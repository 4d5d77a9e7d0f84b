"""reflo-layer API: file-level encode options and conversions.

Mirrors reflo/src/lib.rs: EncodeOptions, encode_from_audio/samples
(with source-tag merge and encoder stamps), decode_to_samples/wav,
get_flo_info, get_audio_info, metadata passthroughs. The four functions
that encode or decode take ``device=``.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from . import audio_io, lib
from .container import reader
from .core.metadata import Comment, FloMetadata, Picture, PictureType
from .lossless import decoder as lossless_decoder
from .lossless import encoder as lossless_encoder
from .lossy import decoder as lossy_decoder
from .lossy import encoder as lossy_encoder
from .lossy.presets import QualityPreset

get_flo_info = lib.info  # identical computation (reflo/src/lib.rs:34-91)
get_audio_info = audio_io.get_audio_info


def validate_flo(data: bytes) -> bool:
    return lib.info(data).crc_valid


@dataclass
class EncodeOptions:
    """Encoding options with chained setters (reflo/src/lib.rs:93-165)."""

    level: int = 5
    lossy: bool = False
    quality: float = 0.6
    bitrate: Optional[int] = None
    metadata: Optional[FloMetadata] = None

    @classmethod
    def lossless(cls) -> "EncodeOptions":
        return cls(lossy=False)

    @classmethod
    def lossy_quality(cls, quality: float) -> "EncodeOptions":
        return cls(lossy=True, quality=min(max(quality, 0.0), 1.0))

    @classmethod
    def lossy_bitrate(cls, bitrate: int) -> "EncodeOptions":
        return cls(lossy=True, bitrate=bitrate)

    def with_level(self, level: int) -> "EncodeOptions":
        self.level = min(int(level), 9)
        return self

    def with_metadata(self, metadata: FloMetadata) -> "EncodeOptions":
        self.metadata = metadata
        return self


def encode_from_audio(audio_bytes: bytes, options: EncodeOptions, *, device="cuda") -> bytes:
    """Decode a foreign audio file and encode to flo (lib.rs:183-189)."""
    samples, rate, channels, source_meta = audio_io.read_audio_from_bytes(audio_bytes)
    return encode_from_samples(samples, rate, channels, source_meta, options, device=device)


def encode_from_samples(
    samples: np.ndarray,
    sample_rate: int,
    channels: int,
    source_metadata: Optional[audio_io.AudioMetadata],
    options: EncodeOptions,
    *,
    device="cuda",
) -> bytes:
    """Encode samples with source-tag merge + encoder stamps (lib.rs:202-309).

    Like the reference's reflo path, this does NOT auto-embed analysis data
    (that's the lib.encode facade's behavior). A lossy encode runs on
    ``device``; a lossless one on the host (the bulk path on ``device`` where
    the host has no C++ toolchain).
    """
    src = source_metadata or audio_io.AudioMetadata()
    meta = options.metadata
    if meta is None:
        meta = FloMetadata(
            title=src.title,
            artist=src.artist,
            album=src.album,
            album_artist=src.album_artist,
            year=src.year,
            genre=src.genre,
            track_number=src.track_number,
            bpm=int(src.bpm) if src.bpm is not None else None,
        )
        if src.comment:
            meta.comments = [Comment(text=src.comment, language="eng")]
        if src.cover_art:
            mime, data = src.cover_art
            meta.pictures = [Picture(mime, PictureType.COVER_FRONT, None, data)]

    from . import __version__

    meta.flo_encoder_version = f"flo_torch {__version__}"
    meta.encoding_time = datetime.datetime.now(datetime.timezone.utc).strftime(
        "%Y-%m-%dT%H:%M:%SZ"
    )
    meta.source_format = src.source_format or meta.source_format
    meta.original_filename = src.original_filename or meta.original_filename

    if options.lossy or options.bitrate is not None:
        if options.bitrate is not None:
            settings = f"Lossy, target {options.bitrate}kbps"
        else:
            settings = f"Lossy, quality {options.quality * 100.0:.0f}%"
    else:
        settings = f"Lossless, level {options.level}"
    meta.encoder_settings = settings

    n = len(samples) // channels
    meta.length_ms = int(n / sample_rate * 1000.0)
    metadata_bytes = meta.to_msgpack()

    if options.lossy or options.bitrate is not None:
        if options.bitrate is not None:
            q = QualityPreset.from_bitrate(options.bitrate, sample_rate, channels).as_f32()
        else:
            q = options.quality
        return lossy_encoder.encode(
            samples, sample_rate, channels, q, metadata_bytes, device=device
        )
    return lossless_encoder.encode(
        samples, sample_rate, channels, 16, options.level, metadata_bytes, device=device
    )


def decode_to_samples(flo_bytes: bytes, *, device="cuda") -> Tuple[np.ndarray, int, int]:
    """(interleaved f32, rate, channels), decoded on ``device``; lossy
    decided by the header flag (reflo/src/lib.rs:318-367)."""
    flo = reader.read(flo_bytes)
    if flo.header.is_lossy:
        samples = lossy_decoder.decode_file(flo, device=device)
    else:
        samples = lossless_decoder.decode_file(flo, device=device)
    return samples, flo.header.sample_rate, flo.header.channels


def decode_to_wav(flo_bytes: bytes, *, device="cuda") -> bytes:
    """32-bit float WAV (reflo/src/lib.rs:376-380), decoded on ``device``."""
    samples, rate, channels = decode_to_samples(flo_bytes, device=device)
    return audio_io.write_wav_to_bytes(samples, rate, channels)


def get_metadata(flo_bytes: bytes) -> Optional[FloMetadata]:
    blob = reader.read(flo_bytes).metadata
    return FloMetadata.from_msgpack(blob) if blob else None


def update_metadata_bytes(flo_bytes: bytes, new_metadata: bytes) -> bytes:
    return lib.update_metadata_bytes(flo_bytes, new_metadata)
