"""Top-level API facade: the part of the reference's ``lib.py`` ported so far
(lossless encode, decode, info, validate)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ._flo_host.container import reader
from ._flo_host.core import crc32
from ._flo_host.core.analysis_batch import analyze_one
from ._flo_host.core.constants import FrameType
from ._flo_host.core.metadata import FloMetadata
from .lossless import decoder as lossless_decoder
from .lossless import encoder as lossless_encoder


@dataclass
class AudioInfo:
    """File info."""

    version: str
    sample_rate: int
    channels: int
    bit_depth: int
    total_samples: int
    duration_secs: float
    file_size: int
    compression_ratio: float
    crc_valid: bool
    is_lossy: bool
    lossy_quality: int


def encode(
    samples,
    sample_rate: int,
    channels: int,
    bit_depth: int = 16,
    metadata: bytes = b"",
    compression_level: int = 5,
    *,
    analyze: bool = True,
) -> bytes:
    """Lossless encode with auto-analysis metadata (waveform, fingerprint,
    loudness, length). Runs on the host."""
    samples = np.asarray(samples, dtype=np.float32).reshape(-1)
    if analyze:
        metadata = analyze_one(metadata, samples, sample_rate, channels)
    return lossless_encoder.encode(
        samples, sample_rate, channels, bit_depth, compression_level, metadata
    )


def decode(data: bytes, *, device="cuda") -> np.ndarray:
    """Decode flo bytes to interleaved float32 samples, reconstructing on
    ``device``. Lossy (Transform-frame) files are not ported yet."""
    flo = reader.read(data)
    if any(f.frame_type == int(FrameType.TRANSFORM) for f in flo.frames):
        raise NotImplementedError(
            "lossy (Transform-frame) decode is not ported yet: ROADMAP.md section 1, item 9"
        )
    return lossless_decoder.decode_file(flo, device=device)


def _data_span(flo, data: bytes) -> tuple[int, int]:
    start = 4 + flo.header.header_size + flo.header.toc_size
    return start, start + flo.header.data_size


def validate(data: bytes) -> bool:
    """CRC32 integrity check."""
    try:
        flo = reader.read(data)
    except Exception:
        return False
    start, end = _data_span(flo, data)
    return end <= len(data) and crc32.compute(data[start:end]) == flo.header.data_crc32


def info(data: bytes) -> AudioInfo:
    """File info."""
    flo = reader.read(data)
    try:
        meta = FloMetadata.from_msgpack(flo.metadata) if flo.metadata else FloMetadata()
    except Exception:
        meta = FloMetadata()
    if meta.length_ms is not None:
        duration_secs = meta.length_ms / 1000.0
    else:
        duration_secs = flo.header.total_samples / flo.header.sample_rate

    original_size = int(
        flo.header.total_samples * flo.header.channels * (flo.header.bit_depth / 8.0)
    )
    start, end = _data_span(flo, data)
    return AudioInfo(
        version=f"{flo.header.version_major}.{flo.header.version_minor}",
        sample_rate=flo.header.sample_rate,
        channels=flo.header.channels,
        bit_depth=flo.header.bit_depth,
        total_samples=flo.header.total_samples,
        duration_secs=duration_secs,
        file_size=len(data),
        compression_ratio=(original_size / len(data)) if data else 0.0,
        crc_valid=end <= len(data) and crc32.compute(data[start:end]) == flo.header.data_crc32,
        is_lossy=flo.header.is_lossy,
        lossy_quality=flo.header.lossy_quality,
    )
