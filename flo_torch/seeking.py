"""TOC-based seeking and single-frame access (libflo/src/seeking.rs)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from . import debug
from .container import reader
from .core.constants import FrameType
from .core.types import FloFile, TocEntry
from .lossless import decoder as lossless_decoder
from .lossy import decoder as lossy_decoder


@dataclass
class SeekResult:
    """Result of a seek (seeking.rs:8-19)."""

    frame_index: int
    byte_offset: int
    timestamp_ms: int
    sample_offset: int
    next_timestamp_ms: int


def get_toc(flo_data: bytes) -> List[TocEntry]:
    """TOC entries of a file (seeking.rs:28-32)."""
    return reader.read(flo_data).toc


def binary_search_frame(toc: List[TocEntry], target_ms: int) -> int:
    """Rightmost frame with timestamp <= target (seeking.rs:134-154)."""
    if not toc:
        return 0
    left, right = 0, len(toc) - 1
    while left < right:
        mid = left + (right - left + 1) // 2
        if toc[mid].timestamp_ms <= target_ms:
            left = mid
        else:
            right = mid - 1
    return left


def seek_to_time(flo_data: bytes, target_ms: int) -> SeekResult:
    """Seek with sub-frame sample offset (seeking.rs:79-130)."""
    flo = reader.read(flo_data)
    if not flo.toc:
        raise ValueError("No TOC available for seeking")
    frame_index = binary_search_frame(flo.toc, target_ms)
    if frame_index >= len(flo.frames):
        frame_index = len(flo.frames) - 1
    entry = flo.toc[frame_index]

    if frame_index + 1 < len(flo.toc):
        frame_duration_ms = flo.toc[frame_index + 1].timestamp_ms - entry.timestamp_ms
    else:
        last_samples = flo.frames[frame_index].frame_samples
        frame_duration_ms = (last_samples * 1000) // flo.header.sample_rate

    ms_into_frame = max(target_ms - entry.timestamp_ms, 0)
    sample_offset = (ms_into_frame * flo.header.sample_rate) // 1000
    sample_offset = min(sample_offset, flo.frames[frame_index].frame_samples)

    if frame_index + 1 < len(flo.toc):
        next_timestamp_ms = flo.toc[frame_index + 1].timestamp_ms
    else:
        next_timestamp_ms = entry.timestamp_ms + frame_duration_ms

    return SeekResult(
        frame_index=frame_index,
        byte_offset=entry.byte_offset,
        timestamp_ms=entry.timestamp_ms,
        sample_offset=int(sample_offset),
        next_timestamp_ms=int(next_timestamp_ms),
    )


def decode_frame_at(flo_data: bytes, frame_index: int, *, device="cuda") -> np.ndarray:
    """Decode exactly one frame (seeking.rs:45-69).

    A lossy frame's blocks are decoded on ``device``; a lossless frame
    decodes on the host (one frame cannot amortise a transfer and a launch).

    Lossless frames decode standalone; lossy frames need the previous frame's
    overlap block. The reference replays *all* prior frames (seeking.rs:175-207,
    O(n)); overlap depth is exactly one block, so decoding frames
    [frame_index-1, frame_index] is equivalent — implemented that way here
    (documented improvement, same output).
    """
    flo = reader.read(flo_data)
    if frame_index >= len(flo.frames):
        raise IndexError(
            f"Frame index {frame_index} out of bounds (total frames: {len(flo.frames)})"
        )
    frame = flo.frames[frame_index]
    if FrameType.from_byte(frame.frame_type).is_transform:
        start = max(frame_index - 1, 0)
        sub = FloFile(
            header=flo.header,
            toc=flo.toc,
            frames=flo.frames[start : frame_index + 1],
            extra=b"",
            metadata=flo.metadata,
        )
        # decode_file drops the first frame's output (pre-roll semantics);
        # with [prev, target] that leaves exactly the target frame's samples.
        out = lossy_decoder.decode_file(sub, device=device)
        if frame_index == 0:
            # Reference: frame 0 decodes against a zero overlap buffer.
            p = lossy_decoder.deserialize_frame(frame.channels[0].residuals)
            if p is None:
                raise ValueError("Failed to deserialize transform frame")
            n, sf, q = p
            q_d, sf_d = lossy_decoder.to_device(q[None], sf[None], device=device)
            segs = lossy_decoder._decode_blocks(q_d, sf_d, flo.header.sample_rate, n)
            out = segs[0].reshape(-1).cpu().numpy()
    else:
        sub = FloFile(
            header=flo.header, toc=flo.toc, frames=[frame], extra=b"", metadata=flo.metadata
        )
        # Single-frame decode: host path (no device round-trip latency).
        out = lossless_decoder.decode_file_host(sub, device=device)
    if debug.debug_enabled():
        debug.check_finite("decode_frame_at", out)
    return out
