"""Audio file ingest/egress (the reflo/src/audio.rs equivalent).

The reference wraps Symphonia for MP3/WAV/FLAC/OGG/AAC input. Here, the
formats decodable FAITHFULLY from their specifications offline are
implemented from spec: WAV (PCM u8/i16/i24/i32 and IEEE float32/64),
AIFF / AIFF-C (vendored parser — the stdlib `aifc` module is gone in
Python 3.13), FLAC (flo_torch.flac, built on this codebase's own LPC/Rice
machinery), and Ogg Vorbis (flo_torch.vorbis — Vorbis is self-describing,
so no fixed tables need transcribing).

MP3 is ingested through the system libmpg123 (flo_torch.mp3, ctypes) and
AAC/M4A through the system libavformat+libavcodec (flo_torch.aac over the
native/ingest.cpp shim) — the same design as the reference's Symphonia
wrapping: those codecs' normative Huffman/synthesis tables are opaque
constant blobs that cannot be re-derived or verified offline, so the
battle-tested system decoders are the faithful choice.

WAV output matches the reference's 32-bit-float writer
(reflo/src/audio.rs:284-320) byte-for-byte.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np


@dataclass
class AudioMetadata:
    """Source-file tags carried into flo metadata (audio.rs:14-41)."""

    title: Optional[str] = None
    artist: Optional[str] = None
    album: Optional[str] = None
    album_artist: Optional[str] = None
    year: Optional[int] = None
    genre: Optional[str] = None
    track_number: Optional[int] = None
    bpm: Optional[float] = None
    comment: Optional[str] = None
    cover_art: Optional[Tuple[str, bytes]] = None
    source_format: Optional[str] = None
    original_filename: Optional[str] = None


class UnsupportedFormatError(ValueError):
    pass


def _parse_wav(data: bytes):
    if len(data) < 12 or data[0:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise UnsupportedFormatError("not a RIFF/WAVE file")
    pos = 12
    fmt = None
    raw = None
    info_tags = {}
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        (size,) = struct.unpack_from("<I", data, pos + 4)
        body = data[pos + 8 : pos + 8 + size]
        if cid == b"fmt ":
            fmt = body
        elif cid == b"data":
            raw = body
        elif cid == b"LIST" and body[:4] == b"INFO":
            q = 4
            while q + 8 <= len(body):
                tag = body[q : q + 4]
                (tsz,) = struct.unpack_from("<I", body, q + 4)
                val = body[q + 8 : q + 8 + tsz].split(b"\x00")[0]
                try:
                    info_tags[tag.decode("ascii")] = val.decode("utf-8", "replace")
                except Exception:
                    pass
                q += 8 + tsz + (tsz & 1)
        pos += 8 + size + (size & 1)
    if fmt is None or raw is None:
        raise UnsupportedFormatError("WAV missing fmt/data chunk")

    audio_format, channels, sample_rate, _, _, bits = struct.unpack_from("<HHIIHH", fmt, 0)
    if audio_format == 0xFFFE and len(fmt) >= 40:  # WAVE_FORMAT_EXTENSIBLE
        audio_format = struct.unpack_from("<H", fmt, 24)[0]

    if audio_format == 1:  # PCM
        if bits == 8:
            samples = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 16:
            samples = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
        elif bits == 24:
            b = np.frombuffer(raw[: len(raw) - len(raw) % 3], np.uint8).reshape(-1, 3)
            v = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            v = np.where(v >= 1 << 23, v - (1 << 24), v)
            samples = v.astype(np.float32) / float(1 << 23)
        elif bits == 32:
            samples = np.frombuffer(raw, "<i4").astype(np.float32) / float(1 << 31)
        else:
            raise UnsupportedFormatError(f"unsupported PCM bit depth {bits}")
    elif audio_format == 3:  # IEEE float
        if bits == 32:
            samples = np.frombuffer(raw, "<f4").astype(np.float32)
        elif bits == 64:
            samples = np.frombuffer(raw, "<f8").astype(np.float32)
        else:
            raise UnsupportedFormatError(f"unsupported float bit depth {bits}")
    else:
        raise UnsupportedFormatError(f"unsupported WAV format code {audio_format}")

    meta = AudioMetadata(
        title=info_tags.get("INAM"),
        artist=info_tags.get("IART"),
        album=info_tags.get("IPRD"),
        genre=info_tags.get("IGNR"),
        comment=info_tags.get("ICMT"),
        source_format="WAV",
    )
    return samples, int(sample_rate), int(channels), meta


def _f80_to_float(b: bytes) -> float:
    """80-bit IEEE 754 extended float (AIFF sample rates)."""
    if len(b) < 10:
        raise UnsupportedFormatError("truncated AIFF sample rate")
    se = int.from_bytes(b[0:2], "big")
    mant = int.from_bytes(b[2:10], "big")
    if se & 0x7FFF == 0 and mant == 0:
        return 0.0
    exp = (se & 0x7FFF) - 16383 - 63
    v = mant * (2.0**exp)
    return -v if se & 0x8000 else v


def _parse_aiff(data: bytes):
    """Vendored AIFF/AIFF-C parser (the stdlib `aifc` module was removed in
    Python 3.13). Supports PCM 8/16/24/32-bit, big-endian ('NONE') and the
    little-endian 'sowt' AIFF-C variant."""
    if len(data) < 12 or data[0:4] != b"FORM" or data[8:12] not in (b"AIFF", b"AIFC"):
        raise UnsupportedFormatError("not an AIFF file")
    is_aifc = data[8:12] == b"AIFC"
    pos = 12
    comm = None
    ssnd = None
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        (size,) = struct.unpack_from(">I", data, pos + 4)
        body = data[pos + 8 : pos + 8 + size]
        if cid == b"COMM":
            comm = body
        elif cid == b"SSND":
            ssnd = body
        pos += 8 + size + (size & 1)
    if comm is None or ssnd is None or len(comm) < 18:
        raise UnsupportedFormatError("AIFF missing COMM/SSND chunk")

    channels, nframes, bits = struct.unpack_from(">HIH", comm, 0)
    rate = int(round(_f80_to_float(comm[8:18])))
    little = False
    if is_aifc and len(comm) >= 22:
        comp = comm[18:22]
        if comp == b"sowt":
            little = True
        elif comp not in (b"NONE",):
            raise UnsupportedFormatError(f"unsupported AIFF-C compression {comp!r}")

    (offset,) = struct.unpack_from(">I", ssnd, 0)
    raw = ssnd[8 + offset :]
    bo = "<" if little else ">"
    if bits == 16:
        samples = np.frombuffer(raw[: len(raw) - len(raw) % 2], f"{bo}i2").astype(
            np.float32
        ) / 32768.0
    elif bits == 8:
        samples = np.frombuffer(raw, np.int8).astype(np.float32) / 128.0
    elif bits == 24:
        b = np.frombuffer(raw[: len(raw) - len(raw) % 3], np.uint8).reshape(-1, 3)
        if little:
            v = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
        else:
            v = (
                (b[:, 0].astype(np.int32) << 16)
                | (b[:, 1].astype(np.int32) << 8)
                | b[:, 2].astype(np.int32)
            )
        v = np.where(v >= 1 << 23, v - (1 << 24), v)
        samples = v.astype(np.float32) / float(1 << 23)
    elif bits == 32:
        samples = np.frombuffer(raw[: len(raw) - len(raw) % 4], f"{bo}i4").astype(
            np.float32
        ) / float(1 << 31)
    else:
        raise UnsupportedFormatError(f"unsupported AIFF bit depth {bits}")
    samples = samples[: nframes * channels] if nframes else samples
    return samples, rate, int(channels), AudioMetadata(source_format="AIFF")


def read_audio_from_bytes(data: bytes):
    """Decode an audio file to (interleaved f32, rate, channels, metadata)
    (audio.rs:57-166 equivalent)."""
    if data[:4] == b"RIFF":
        return _parse_wav(data)
    if data[:4] == b"FORM" and data[8:12] in (b"AIFF", b"AIFC"):
        return _parse_aiff(data)
    if data[:4] == b"FLO!":
        raise UnsupportedFormatError("input is already a flo file")
    if data[:4] == b"fLaC":
        from . import flac

        d = flac.decode(data)
        return d.samples, d.sample_rate, d.channels, d.metadata
    if data[:4] == b"OggS":
        from . import vorbis

        d = vorbis.decode(data)
        return d.samples, d.sample_rate, d.channels, d.metadata
    if len(data) > 11 and data[4:8] == b"ftyp":
        from . import aac

        d = aac.decode(data, source_format="m4a")
        return d.samples, d.sample_rate, d.channels, d.metadata
    if len(data) > 1 and data[0] == 0xFF and (data[1] & 0xF6) == 0xF0:
        # ADTS sync with layer bits 00 = raw AAC stream, not MPEG audio.
        from . import aac

        d = aac.decode(data, source_format="aac")
        return d.samples, d.sample_rate, d.channels, d.metadata
    if data[:3] == b"ID3" or (
        len(data) > 1 and data[0] == 0xFF and (data[1] & 0xE0) == 0xE0
    ):
        # An ID3 tag can front either MPEG audio or ADTS AAC; peek at the
        # first sync frame's layer bits (00 = AAC) to route correctly.
        if data[:3] == b"ID3" and len(data) > 10:
            body = 10 + (
                (data[6] << 21) | (data[7] << 14) | (data[8] << 7) | data[9]
            )
            if (
                len(data) > body + 1
                and data[body] == 0xFF
                and (data[body + 1] & 0xF6) == 0xF0
            ):
                from . import aac

                d = aac.decode(data, source_format="aac")
                return d.samples, d.sample_rate, d.channels, d.metadata
        from . import mp3

        d = mp3.decode(data)
        return d.samples, d.sample_rate, d.channels, d.metadata
    raise UnsupportedFormatError("unrecognized audio format")


def get_audio_info(data: bytes):
    """(sample_rate, channels, duration_secs) of an input file
    (reflo/src/lib.rs:412-421)."""
    samples, rate, channels, _ = read_audio_from_bytes(data)
    n = len(samples) // max(channels, 1)
    return rate, channels, n / rate


def write_wav_to_bytes(samples: np.ndarray, sample_rate: int, channels: int) -> bytes:
    """32-bit float WAV, byte-identical layout to audio.rs:284-320."""
    samples = np.asarray(samples, dtype=np.float32).reshape(-1)
    data_size = samples.size * 4
    parts = [
        b"RIFF",
        struct.pack("<I", 36 + data_size),
        b"WAVE",
        b"fmt ",
        struct.pack("<IHHIIHH", 16, 3, channels, sample_rate,
                    sample_rate * channels * 4, channels * 4, 32),
        b"data",
        struct.pack("<I", data_size),
        samples.astype("<f4").tobytes(),
    ]
    return b"".join(parts)
