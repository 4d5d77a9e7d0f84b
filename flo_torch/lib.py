"""Top-level API facade: the normative public surface.

Mirrors libflo/src/lib.rs: encode / encode_lossy / encode_with_bitrate /
decode / validate / info / version / format_time, metadata creation and
zero-copy editing, and analysis exports. Auto-embeds analysis data
(waveform + fingerprint + loudness + length_ms) at encode time like
lib.rs:219-283. Functions that run on a device take ``device=``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from . import debug
from .container import reader
from .core import crc32
from .core.analysis_batch import analyze_one
from .core.constants import HEADER_SIZE, MAGIC, VERSION_MAJOR, VERSION_MINOR, FrameType
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


_META_SIZE_OFFSET = 62  # byte offset of meta_size in the file (lib.rs:1090-1092)


def require_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises where it names a CUDA device
    and the host has none. The entry points (CLI, service, graft_entry)
    call it first: they never carry on on the CPU unless asked to."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(dev)!r}: this host has no CUDA device (pass 'cpu')")
    return dev


def add_analysis_data_if_missing(
    metadata: bytes,
    samples: np.ndarray,
    sample_rate: int,
    channels: int,
    peaks_per_second: int = 50,
) -> bytes:
    """Embed waveform/fingerprint/loudness/length_ms (lib.rs:219-283).

    Routed through core/analysis_batch (native biquad/FIR/BLAKE3 with
    portable fallbacks: identical numerics). Host work."""
    return analyze_one(metadata, samples, sample_rate, channels, peaks_per_second)


def encode(
    samples,
    sample_rate: int,
    channels: int,
    bit_depth: int = 16,
    metadata: bytes = b"",
    compression_level: int = 5,
    *,
    analyze: bool = True,
    device="cuda",
) -> bytes:
    """Lossless encode with auto-analysis metadata (waveform, fingerprint,
    loudness, length). A lone file is encoded on the host by the C++ search;
    on a host without a C++ toolchain it takes the bulk path on ``device``."""
    samples = np.asarray(samples, dtype=np.float32).reshape(-1)
    if analyze:
        metadata = analyze_one(metadata, samples, sample_rate, channels)
    return lossless_encoder.encode(
        samples, sample_rate, channels, bit_depth, compression_level, metadata,
        device=device,
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
    on ``device``: any Transform frame -> lossy. In debug mode
    (:mod:`flo_torch.debug`) the DATA CRC is verified first and the decoded
    samples are checked to be finite."""
    if debug.debug_enabled():
        debug.check_crc(data)
    flo = reader.read(data)
    if is_transform(flo):
        out = lossy_decoder.decode_file(flo, device=device)
    else:
        out = lossless_decoder.decode_file(flo, device=device)
    if debug.debug_enabled():
        debug.check_finite("decode", out)
    return out


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


def version() -> str:
    """Library/format version (lib.rs:443-446)."""
    return f"{VERSION_MAJOR}.{VERSION_MINOR}"


def format_time(seconds: float) -> str:
    """MM:SS or H:MM:SS (lib.rs:449-466)."""
    if not np.isfinite(seconds) or seconds < 0.0:
        return "0:00"
    total = int(seconds)
    hours, mins, secs = total // 3600, (total % 3600) // 60, total % 60
    if hours > 0:
        return f"{hours}:{mins:02d}:{secs:02d}"
    return f"{mins}:{secs:02d}"


def format_time_ms(milliseconds: float) -> str:
    return format_time(milliseconds / 1000.0)


# ---------------- metadata CRUD (lib.rs:823-1196) ----------------


def create_metadata(
    title: Optional[str] = None, artist: Optional[str] = None, album: Optional[str] = None
) -> bytes:
    return FloMetadata.with_basic(title, artist, album).to_msgpack()


def get_metadata(data: bytes) -> FloMetadata:
    flo = reader.read(data)
    return FloMetadata.from_msgpack(flo.metadata) if flo.metadata else FloMetadata()


def get_metadata_bytes(data: bytes) -> bytes:
    return reader.read(data).metadata


def update_metadata_bytes(flo_data: bytes, new_metadata: bytes) -> bytes:
    """Zero-copy metadata replacement: byte splice + meta_size patch at
    offset 62, audio bytes and CRC untouched (lib.rs:1058-1096)."""
    if len(flo_data) < HEADER_SIZE:
        raise ValueError("File too small to be valid flo")
    if flo_data[0:4] != MAGIC:
        raise ValueError("Invalid flo file: bad magic")
    flo = reader.read(flo_data)
    meta_offset = _data_span(flo, flo_data)[1] + flo.header.extra_size
    out = bytearray(flo_data[:meta_offset])
    out += new_metadata
    out[_META_SIZE_OFFSET : _META_SIZE_OFFSET + 8] = len(new_metadata).to_bytes(8, "little")
    return bytes(out)


def update_metadata(flo_data: bytes, meta: FloMetadata) -> bytes:
    return update_metadata_bytes(flo_data, meta.to_msgpack())


def strip_metadata(flo_data: bytes) -> bytes:
    """Remove all metadata (lib.rs:1121-1135)."""
    return update_metadata_bytes(flo_data, b"")


def has_metadata(flo_data: bytes) -> bool:
    """Fast header peek (lib.rs:1169-1188)."""
    if len(flo_data) < _META_SIZE_OFFSET + 8:
        return False
    return int.from_bytes(flo_data[_META_SIZE_OFFSET : _META_SIZE_OFFSET + 8], "little") > 0
