"""AAC / M4A (MP4 audio) ingest via the system libavformat + libavcodec.

The reference ingests AAC by wrapping a third-party decoder library
(Symphonia with the ``aac`` + ``isomp4`` features, reflo/Cargo.toml:31-41,
reflo/src/audio.rs:57-166); this module is the same design point for this
environment: AAC's normative Huffman codebooks, TNS tables, and window
shapes are opaque constant blobs that cannot be re-derived or verified
offline — unlike FLAC/Vorbis, which this codebase decodes from spec — so
the battle-tested system decoder is the faithful engineering call, exactly
as for MP3 (mp3.py over libmpg123).

The actual FFmpeg calls live in a small C++ shim (native/ingest.cpp)
compiled against the image's FFmpeg 5.1 headers, so struct layouts come
from the real headers instead of hand-mirrored ctypes offsets. Tags and
cover art are read from the container metadata (MP4 ilst atoms / ID3 in
ADTS), mirroring extract_metadata_tags (reflo/src/audio.rs:168-236).

If the libraries are absent, :func:`decode` raises a clear error and the
rest of the framework is unaffected.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np

from .audio_io import AudioMetadata, UnsupportedFormatError


class AacError(UnsupportedFormatError):
    pass


def _lib():
    from . import native

    return native._load("ingest")


def available() -> bool:
    return _lib() is not None


@dataclass
class AacDecoded:
    samples: np.ndarray  # interleaved f32
    sample_rate: int
    channels: int
    metadata: AudioMetadata


def _extract_metadata(lib, h, source_format: str) -> AudioMetadata:
    """Map the container's metadata dict to AudioMetadata fields.

    FFmpeg normalizes MP4 ilst atoms (©nam/©ART/...) and ID3 frames to
    generic lowercase keys, so one mapping covers both containers — the
    same field set as extract_metadata_tags (reflo/src/audio.rs:168-236).
    """
    tags: dict[str, str] = {}
    for i in range(lib.flo_ingest_ntags(h)):
        k = lib.flo_ingest_tag_key(h, i)
        v = lib.flo_ingest_tag_val(h, i)
        if k is not None and v:
            tags[k.decode("utf-8", "replace")] = v.decode("utf-8", "replace")

    md = AudioMetadata(source_format=source_format)
    md.title = tags.get("title") or None
    md.artist = tags.get("artist") or None
    md.album = tags.get("album") or None
    md.album_artist = tags.get("album_artist") or None
    md.genre = tags.get("genre") or None
    md.comment = tags.get("comment") or None
    date = tags.get("date") or tags.get("year")
    if date:
        try:
            md.year = int(date[:4])
        except ValueError:
            pass
    track = tags.get("track")
    if track:
        try:
            md.track_number = int(track.split("/")[0])
        except ValueError:
            pass
    if tags.get("tbpm"):
        try:
            md.bpm = float(tags["tbpm"])
        except ValueError:
            pass

    cover_size = lib.flo_ingest_cover_size(h)
    if cover_size > 0:
        buf = np.empty(cover_size, dtype=np.uint8)
        lib.flo_ingest_cover(h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        mime = lib.flo_ingest_cover_mime(h) or b"image/jpeg"
        md.cover_art = (mime.decode("ascii", "replace"), buf.tobytes())
    return md


def decode(data: bytes, source_format: str = "aac") -> AacDecoded:
    """Decode an AAC (ADTS) or M4A/MP4 byte buffer to interleaved f32."""
    lib = _lib()
    if lib is None:
        raise AacError(
            "AAC/M4A input needs the system libavformat/libavcodec, which "
            "could not be loaded"
        )
    arr = np.frombuffer(data, dtype=np.uint8)
    if arr.size == 0:
        raise AacError("empty AAC input")
    h = lib.flo_ingest_decode(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), arr.size
    )
    if not h:
        raise AacError("AAC decode failed (allocation)")
    try:
        err = lib.flo_ingest_error(h)
        if err:
            raise AacError(f"AAC decode failed: {err.decode('utf-8', 'replace')}")
        n = lib.flo_ingest_nsamples(h)
        rate = lib.flo_ingest_rate(h)
        channels = lib.flo_ingest_channels(h)
        samples = np.empty(n, dtype=np.float32)
        if n:
            lib.flo_ingest_samples(
                h, samples.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
            )
        md = _extract_metadata(lib, h, source_format)
    finally:
        lib.flo_ingest_free(h)
    return AacDecoded(samples, int(rate), int(channels), md)


def encode_for_tests(
    samples: np.ndarray,
    sample_rate: int,
    channels: int,
    container: str = "adts",
    title: str = "",
    artist: str = "",
) -> bytes:
    """Encode f32 PCM to AAC (ADTS or MP4) with the system encoder.

    Test-vector generator only (the analog of tests/mp3_writer.py): the
    framework itself never encodes AAC — the reference doesn't either.
    """
    lib = _lib()
    if lib is None:
        raise AacError("system AAC encoder unavailable")
    arr = np.ascontiguousarray(samples, dtype=np.float32).reshape(-1)
    h = lib.flo_ingest_encode_aac(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        arr.size,
        int(sample_rate),
        int(channels),
        {"adts": b"adts", "mp4": b"mp4", "m4a": b"ipod"}[container],
        title.encode("utf-8"),
        artist.encode("utf-8"),
    )
    if not h:
        raise AacError("AAC encode failed (allocation)")
    try:
        err = lib.flo_ingest_error(h)
        if err:
            raise AacError(f"AAC encode failed: {err.decode('utf-8', 'replace')}")
        n = lib.flo_ingest_bytes_size(h)
        out = np.empty(n, dtype=np.uint8)
        if n:
            lib.flo_ingest_bytes(
                h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
            )
        return out.tobytes()
    finally:
        lib.flo_ingest_free(h)
