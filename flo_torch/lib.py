"""Top-level API facade: the part of the reference's ``lib.py`` ported so far
(lossless and lossy encode, auto-detecting decode, info, validate)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .container import reader
from .core import crc32
from .core.analysis_batch import analyze_one
from .core.constants import FrameType
from .core.metadata import FloMetadata
from .lossless import decoder as lossless_decoder
from .lossless import encoder as lossless_encoder
from .lossy import decoder as lossy_decoder
from .lossy import encoder as lossy_encoder
from .lossy.presets import QUALITY_U8_TO_F32, QualityPreset


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


def encode_lossy(
    samples,
    sample_rate: int,
    channels: int,
    quality: int = 2,
    bit_depth: int = 16,
    metadata: bytes = b"",
    *,
    analyze: bool = True,
    device="cuda",
) -> bytes:
    """Lossy encode on ``device``; quality u8 0-4 -> f32 preset map
    (lib.rs:135-166)."""
    return encode_transform(
        samples, sample_rate, channels, bit_depth, QUALITY_U8_TO_F32[min(int(quality), 4)],
        metadata, analyze=analyze, device=device,
    )


def encode_transform(
    samples,
    sample_rate: int,
    channels: int,
    bit_depth: int = 16,
    quality: float = 0.55,
    metadata: bytes = b"",
    *,
    analyze: bool = True,
    device="cuda",
) -> bytes:
    """Lossy encode on ``device`` with continuous quality 0.0-1.0 (the u8
    preset facade is :func:`encode_lossy`)."""
    samples = np.asarray(samples, dtype=np.float32).reshape(-1)
    q = min(max(float(quality), 0.0), 1.0)
    if analyze:
        metadata = analyze_one(metadata, samples, sample_rate, channels)
    return lossy_encoder.encode(
        samples, sample_rate, channels, q, metadata, bit_depth, device=device
    )


def encode_with_bitrate(
    samples,
    sample_rate: int,
    channels: int,
    bitrate_kbps: int,
    bit_depth: int = 16,
    metadata: bytes = b"",
    *,
    analyze: bool = True,
    device="cuda",
) -> bytes:
    """Lossy encode on ``device`` targeting a bitrate (lib.rs:180-206)."""
    preset = QualityPreset.from_bitrate(bitrate_kbps, sample_rate, channels)
    return encode_lossy(
        samples, sample_rate, channels, int(preset), bit_depth, metadata,
        analyze=analyze, device=device,
    )


def is_transform(flo) -> bool:
    """Whether a parsed file holds any Transform frame (a lossy file)."""
    return any(f.frame_type == int(FrameType.TRANSFORM) for f in flo.frames)


def decode(data: bytes, *, device="cuda") -> np.ndarray:
    """Auto-detecting decode (lib.rs:296-315) to interleaved float32 samples
    on ``device``: any Transform frame -> lossy."""
    flo = reader.read(data)
    if is_transform(flo):
        return lossy_decoder.decode_file(flo, device=device)
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
