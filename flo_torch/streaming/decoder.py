"""Push-based streaming decoder.

Behavioral mirror of libflo/src/streaming/decoder.rs: feed() buffers bytes and
advances WaitingForHeader -> WaitingForToc -> Ready; next_frame() decodes one
frame as soon as its TOC-declared byte range is buffered; decode_available()
decodes every currently-complete frame. Unlike the reference (which
hand-duplicates the container parsing and the lossless reconstruction,
decoder.rs:356-739), this reuses the container reader's frame parser and the
batch decoders on single-frame batches. A lossless frame decodes on the host
(``lossless.decoder.decode_file_host``: one frame cannot amortise a transfer
and a launch); a lossy frame is dequantized and inverse-transformed on the
decoder's ``device`` (``ops.mdct.inverse``), with a 1-block overlap carry and
the one-time pre-roll skip kept on the host (decoder.rs:475-499).
"""

from __future__ import annotations

import struct
from typing import List, Optional

import numpy as np
import torch

from .. import debug
from ..container import reader
from ..core.constants import HEADER_SIZE, MAGIC, MAX_TOC_ENTRIES, TOC_ENTRY_SIZE, FrameType
from ..core.types import FloFile, Frame, Header, TocEntry
from ..lossless import decoder as lossless_decoder
from ..lossy import decoder as lossy_decoder
from ..ops import mdct, psycho
from .types import DecoderState, StreamingAudioInfo

_HEADER_NEED = 4 + HEADER_SIZE  # 70 bytes (decoder.rs:182)


class StreamingDecoder:
    def __init__(self, *, device="cuda") -> None:
        #: where a lossy frame's IMDCT runs (and a lossless frame's decode on
        #: a host without a C++ toolchain)
        self.device = device
        self.reset()

    def reset(self) -> None:
        """Clear all state (decoder.rs:125-135)."""
        self._buf = bytearray()
        self._state = DecoderState.WAITING_FOR_HEADER
        self._header: Optional[Header] = None
        self._toc: List[TocEntry] = []
        self._toc_count: Optional[int] = None
        self._current_frame = 0
        self._data_start = 0
        self._lossy_overlap: Optional[np.ndarray] = None
        self._preroll_skipped = False

    # ---------------- state/introspection ----------------

    @property
    def state(self) -> DecoderState:
        return self._state

    def info(self) -> Optional[StreamingAudioInfo]:
        if self._header is None:
            return None
        h = self._header
        return StreamingAudioInfo(
            sample_rate=h.sample_rate,
            channels=h.channels,
            bit_depth=h.bit_depth,
            total_samples=h.total_samples,
            is_lossy=h.is_lossy,
        )

    def buffered_bytes(self) -> int:
        return len(self._buf)

    def current_frame_index(self) -> int:
        return self._current_frame

    def frames_available(self) -> int:
        """Count of not-yet-decoded frames whose bytes are fully buffered
        (decoder.rs:342-354)."""
        if self._state not in (DecoderState.READY, DecoderState.FINISHED):
            return 0
        n = 0
        for i in range(self._current_frame, len(self._toc)):
            if self._frame_buffered(i):
                n += 1
            else:
                break
        return n

    available_frames = frames_available

    # ---------------- feeding ----------------

    def feed(self, data: bytes) -> bool:
        """Append bytes and advance the state machine; returns True if the
        state advanced (decoder.rs:71-79). Bad magic transitions to the
        terminal ERROR state and returns False, matching the reference
        (decoder.rs:186-189) — feeding an errored decoder raises."""
        if self._state == DecoderState.ERROR:
            raise ValueError("Decoder is in error state")
        self._buf.extend(data)
        return self._try_advance()

    def _try_advance(self) -> bool:
        advanced = False
        if self._state == DecoderState.WAITING_FOR_HEADER:
            if len(self._buf) >= _HEADER_NEED:
                if bytes(self._buf[0:4]) != MAGIC:
                    self._state = DecoderState.ERROR
                    return False
                self._header = reader.read_header(bytes(self._buf[:_HEADER_NEED]), 4)
                self._state = DecoderState.WAITING_FOR_TOC
                advanced = True
        if self._state == DecoderState.WAITING_FOR_TOC:
            if self._parse_toc_incremental():
                self._state = DecoderState.READY
                self._data_start = _HEADER_NEED + self._header.toc_size
                advanced = True
        return advanced

    def _parse_toc_incremental(self) -> bool:
        """Parse the TOC once fully buffered (decoder.rs:281-340)."""
        if len(self._buf) < _HEADER_NEED + 4:
            return False
        count = struct.unpack_from("<I", self._buf, _HEADER_NEED)[0]
        if count > MAX_TOC_ENTRIES:
            self._state = DecoderState.ERROR
            raise ValueError("Invalid TOC: too many entries")
        need = _HEADER_NEED + 4 + count * TOC_ENTRY_SIZE
        if len(self._buf) < need:
            return False
        self._toc = []
        off = _HEADER_NEED + 4
        for _ in range(count):
            fi, bo, fs, ts = struct.unpack_from("<IQII", self._buf, off)
            self._toc.append(TocEntry(fi, bo, fs, ts))
            off += TOC_ENTRY_SIZE
        return True

    # ---------------- decoding ----------------

    def _frame_buffered(self, i: int) -> bool:
        e = self._toc[i]
        return len(self._buf) >= self._data_start + e.byte_offset + e.frame_size

    def _parse_frame(self, i: int) -> Frame:
        e = self._toc[i]
        start = self._data_start + e.byte_offset
        blob = bytes(self._buf[start : start + e.frame_size])
        return reader.read_frame(blob, 0, self._header.channels, len(blob))

    def next_frame(self) -> Optional[np.ndarray]:
        """Decode the next frame if fully buffered (decoder.rs:81-111).

        Returns interleaved f32 samples, an empty array when a lossy pre-roll
        frame was consumed, or None if more bytes are needed.
        """
        if self._state not in (DecoderState.READY, DecoderState.FINISHED):
            return None
        if self._current_frame >= len(self._toc):
            self._state = DecoderState.FINISHED
            return None
        if not self._frame_buffered(self._current_frame):
            return None
        frame = self._parse_frame(self._current_frame)
        self._current_frame += 1
        if self._current_frame >= len(self._toc):
            self._state = DecoderState.FINISHED
        return self._decode_frame(frame)

    def _decode_frame(self, frame: Frame) -> np.ndarray:
        if FrameType.from_byte(frame.frame_type).is_transform:
            return self._decode_lossy(frame)
        sub = FloFile(header=self._header, toc=[], frames=[frame])
        # Host path: a per-frame device round trip is pure latency here.
        return lossless_decoder.decode_file_host(sub, device=self.device)

    def _decode_lossy(self, frame: Frame) -> np.ndarray:
        parsed = lossy_decoder.deserialize_frame(frame.channels[0].residuals)
        if parsed is None:
            self._state = DecoderState.ERROR
            raise ValueError("Failed to deserialize transform frame")
        n, sf, q = parsed
        n2 = n // 2
        band = psycho.model_tables(self._header.sample_rate, n)[1]
        sf_bin = sf[:, band]
        coeffs = np.where(
            sf_bin > 0, q.astype(np.float32) / np.maximum(sf_bin, 1e-30), 0.0
        ).astype(np.float32)
        on_device = torch.from_numpy(coeffs).to(self.device)
        recon = mdct.inverse(on_device, n, "vorbis").cpu().numpy()  # [C, n]
        if debug.debug_enabled():
            debug.check_finite("StreamingDecoder lossy frame", recon)
        C = recon.shape[0]
        if self._lossy_overlap is None:
            self._lossy_overlap = np.zeros((C, n2), dtype=np.float32)
        out = recon[:, :n2] + self._lossy_overlap
        self._lossy_overlap = recon[:, n2:].copy()
        if not self._preroll_skipped:
            self._preroll_skipped = True
            return np.zeros(0, dtype=np.float32)
        return out.T.reshape(-1)

    def decode_available(self) -> np.ndarray:
        """Decode every fully-buffered remaining frame (decoder.rs:741-773)."""
        parts = []
        while True:
            out = self.next_frame()
            if out is None:
                break
            if out.size:
                parts.append(out)
        if not parts:
            return np.zeros(0, dtype=np.float32)
        return np.concatenate(parts)
