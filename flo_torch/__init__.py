"""flo_torch — the flo audio codec on PyTorch and CUDA (NVIDIA Hopper).

A port of ``flo_tpu`` beside it: the same container bytes and the same public
names, with the device work in PyTorch and hand-written CUDA kernels.

- Lossless encode: a lone file on the host (C++ search; the bulk path where
  the host has no toolchain), many files on the card
  (``lossless.encoder.encode_many``, ``batch.encode_many``: candidate search
  in ``csrc/lossless_select.cu``, Rice pack in ``csrc/rice_pack.cu``).
- Lossless decode: the LPC reconstruction runs in ``csrc/lpc_reconstruct.cu``.
- Lossy (MDCT) encode and decode on the card (``encode_lossy``,
  ``encode_transform``, ``encode_with_bitrate``, ``batch.encode_lossy_many``;
  ``decode`` detects the mode); the temporal-masking scan runs in
  ``csrc/temporal_mask.cu``.
- Streaming (``streaming.StreamingEncoder`` / ``StreamingDecoder``), seeking
  (``get_toc``, ``seek_to_time``, ``decode_frame_at``), metadata reading and
  zero-copy editing, audio ingest (``audio_io``: WAV, AIFF, FLAC, Vorbis, MP3,
  AAC) and the application facade ``reflo``; ``debug`` holds the integrity
  mode.

Functions that allocate on a device take ``device=`` (default ``"cuda"``).
"""

from .core.constants import VERSION_STRING as __format_version__
from .lib import (
    AudioInfo,
    add_analysis_data_if_missing,
    create_metadata,
    decode,
    encode,
    encode_lossy,
    encode_transform,
    encode_with_bitrate,
    format_time,
    format_time_ms,
    get_metadata,
    get_metadata_bytes,
    has_metadata,
    info,
    strip_metadata,
    update_metadata,
    update_metadata_bytes,
    validate,
    version,
)
from .seeking import SeekResult, decode_frame_at, get_toc, seek_to_time

__version__ = "0.1.0"

__all__ = [
    "AudioInfo",
    "SeekResult",
    "add_analysis_data_if_missing",
    "create_metadata",
    "decode",
    "decode_frame_at",
    "encode",
    "encode_lossy",
    "encode_transform",
    "encode_with_bitrate",
    "format_time",
    "format_time_ms",
    "get_metadata",
    "get_metadata_bytes",
    "get_toc",
    "has_metadata",
    "info",
    "seek_to_time",
    "strip_metadata",
    "update_metadata",
    "update_metadata_bytes",
    "validate",
    "version",
]
