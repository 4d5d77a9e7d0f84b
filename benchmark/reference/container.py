"""Plain parser of the flo container, for the benchmark's checks.

Layout (Docs/file-format.md of the format): ``FLO!``, a 66-byte header, a
TOC of 20-byte entries, the DATA chunk of frames, an extra chunk and the
metadata. A frame is ``type u8, samples u32, flags u8`` and one
length-prefixed payload a channel (one for a transform frame). Every check
that fails raises ``FormatError``; the data chunk's CRC-32 is checked.

Numpy and the standard library only: nothing here imports the program.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field

HEADER = struct.Struct("<BBHIBBQB3xIQQQQQ")
TOC_ENTRY = struct.Struct("<IQII")
SILENCE, TRANSFORM, RAW = 0, 253, 254
FIXED_MARKER = 128
ENC_RICE = 0


class FormatError(ValueError):
    """The bytes break the container format."""


@dataclass
class Channel:
    """One channel payload of a lossless frame: ``order`` coefficients (LPC)
    or the fixed order, ``kind`` "lpc" | "fixed" | "raw" | "silence"."""

    kind: str
    order: int = 0
    coeffs: tuple = ()
    shift: int = 0
    k: int = 0
    payload: bytes = b""


@dataclass
class Frame:
    ftype: int
    samples: int
    flags: int
    channels: list = field(default_factory=list)  # Channel, or bytes for a transform


@dataclass
class File:
    sample_rate: int
    channels: int
    bit_depth: int
    total_samples: int
    level: int
    flags: int
    frames: list
    metadata: bytes

    @property
    def lossy(self) -> bool:
        return bool(self.flags & 1)


def _need(cond: bool, what: str) -> None:
    if not cond:
        raise FormatError(what)


def _channel(data: bytes, pos: int, end: int, ftype: int, samples: int) -> Channel:
    if ftype == SILENCE:
        return Channel("silence")
    if ftype == RAW:
        _need(end - pos == 2 * samples, "raw channel of the wrong size")
        return Channel("raw", payload=data[pos:end])
    _need(1 <= ftype <= 12, f"frame type {ftype}")
    _need(end - pos >= 3, "short channel header")
    order = data[pos]
    _need(order <= 12, f"LPC order {order}")
    pos += 1
    coeffs = struct.unpack_from(f"<{order}i", data, pos)
    pos += 4 * order
    _need(pos + 2 <= end, "short channel header")
    shift, enc = data[pos], data[pos + 1]
    pos += 2
    if order == 0 and enc != ENC_RICE:
        # A raw winner inside an ALPC frame: its samples verbatim, LE16.
        _need(end - pos == 2 * samples, "raw channel of the wrong size")
        return Channel("raw", payload=data[pos:end])
    _need(enc == ENC_RICE, f"residual encoding {enc}")
    _need(pos < end, "no Rice parameter")
    k = data[pos]
    pos += 1
    if order == 0:
        _need(FIXED_MARKER <= shift <= FIXED_MARKER + 4, f"fixed marker {shift}")
        return Channel("fixed", order=shift - FIXED_MARKER, k=k, payload=data[pos:end])
    _need(shift <= 15, f"LPC shift {shift}")
    return Channel("lpc", order=order, coeffs=coeffs, shift=shift, k=k, payload=data[pos:end])


def parse(data: bytes) -> File:
    """Parse and check a whole file: magic, header sizes, CRC-32 of the data
    chunk, the TOC's offsets, sizes and timestamps against the frames."""
    _need(len(data) >= 70 and data[:4] == b"FLO!", "bad magic")
    (_vmaj, _vmin, flags, rate, channels, bit_depth, total, level, crc, hsize, toc_size,
     data_size, extra_size, meta_size) = HEADER.unpack_from(data, 4)
    _need(hsize == 66, "header size")
    _need(len(data) == 70 + toc_size + data_size + extra_size + meta_size, "chunk sizes")
    _need(rate > 0 and channels > 0, "rate or channels")
    d0 = 70 + toc_size
    chunk = data[d0 : d0 + data_size]
    _need(zlib.crc32(chunk) & 0xFFFFFFFF == crc, "data CRC-32")
    (n_toc,) = struct.unpack_from("<I", data, 70)
    _need(toc_size == 4 + 20 * n_toc, "TOC size")
    frames, off, cum = [], 0, 0
    for i in range(n_toc):
        idx, boff, fsize, ts = TOC_ENTRY.unpack_from(data, 74 + 20 * i)
        _need(idx == i and boff == off and ts == (cum * 1000 // rate) & 0xFFFFFFFF, "TOC entry")
        _need(off + fsize <= data_size and fsize >= 6, "frame outside the data chunk")
        ftype, samples, fflags = struct.unpack_from("<BIB", chunk, off)
        pos, end = off + 6, off + fsize
        frame = Frame(ftype, samples, fflags)
        for _ in range(1 if ftype == TRANSFORM else channels):
            _need(pos + 4 <= end, "channel size")
            (csize,) = struct.unpack_from("<I", chunk, pos)
            pos += 4
            _need(pos + csize <= end, "channel outside its frame")
            if ftype == TRANSFORM:
                frame.channels.append(chunk[pos : pos + csize])
            else:
                frame.channels.append(_channel(chunk, pos, pos + csize, ftype, samples))
            pos += csize
        _need(pos == end, "frame size")
        frames.append(frame)
        off, cum = end, cum + samples
    _need(off == data_size, "data chunk longer than its frames")
    _need(cum == total, "total samples")
    meta = data[len(data) - meta_size :] if meta_size else b""
    return File(rate, channels, bit_depth, total, level, flags, frames, meta)
