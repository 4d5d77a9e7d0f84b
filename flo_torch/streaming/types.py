"""Streaming types (libflo/src/streaming/types.rs)."""

from __future__ import annotations

import enum
from dataclasses import dataclass


class DecoderState(enum.Enum):
    """Push-decoder state machine (types.rs:5-16)."""

    WAITING_FOR_HEADER = "waiting_for_header"
    WAITING_FOR_TOC = "waiting_for_toc"
    READY = "ready"
    FINISHED = "finished"
    ERROR = "error"


@dataclass
class StreamingAudioInfo:
    """Header-derived info (types.rs:20-46)."""

    sample_rate: int
    channels: int
    bit_depth: int
    total_samples: int
    is_lossy: bool

    def duration_secs(self) -> float:
        return self.total_samples / self.sample_rate

    def total_samples_per_channel(self) -> int:
        return self.total_samples


@dataclass
class EncodedFrame:
    """One encoded frame from the streaming encoder (encoder.rs:20-29)."""

    index: int
    timestamp_ms: int
    data: bytes
    samples: int
