"""MP3 (MPEG-1/2 audio) ingest via the system libmpg123.

The reference ingests MP3 by wrapping a third-party decoder library
(Symphonia, reflo/src/audio.rs:57-166 + reflo/Cargo.toml:31-41); this module
is the same design point for this environment: a ctypes binding over the
host's ``libmpg123`` (a battle-tested conformance-checked decoder that ships
in the image), not a from-spec reimplementation.  MP3 is the one ingest
format whose correctness cannot be established offline from first
principles — its normative Huffman code tables and synthesis window are
large opaque constant blobs with no self-describing or mathematically
checkable structure (unlike FLAC/Vorbis, which we decode from spec) — so
wrapping the system decoder is the faithful engineering call, exactly as the
reference did.

Tags are read from the file's ID3v2 header by our own parser (below) rather
than through mpg123's metadata API, mirroring extract_metadata_tags
(reflo/src/audio.rs:168-236): title/artist/album/album-artist/year/genre/
track/BPM/comment plus APIC cover art.

If ``libmpg123`` is absent, :func:`decode` raises a clear error and the
rest of the framework is unaffected.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from dataclasses import dataclass

import numpy as np

from .audio_io import AudioMetadata, UnsupportedFormatError

# mpg123.h return codes / constants (stable public ABI since mpg123 1.x).
_MPG123_OK = 0
_MPG123_NEED_MORE = -10
_MPG123_NEW_FORMAT = -11
_MPG123_DONE = -12
_ENC_SIGNED_16 = 0xD0  # MPG123_ENC_SIGNED_16
_MPEG_RATES = (8000, 11025, 12000, 16000, 22050, 24000, 32000, 44100, 48000)


class Mp3Error(UnsupportedFormatError):
    pass


_LIB = None
_LIB_TRIED = False


def _load() -> "ctypes.CDLL | None":
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    for name in ("libmpg123.so.0", "libmpg123.so"):
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            continue
        lib.mpg123_new.restype = ctypes.c_void_p
        lib.mpg123_new.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
        lib.mpg123_delete.argtypes = [ctypes.c_void_p]
        lib.mpg123_open_feed.argtypes = [ctypes.c_void_p]
        lib.mpg123_feed.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
        ]
        lib.mpg123_decode_frame.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_long),  # off_t (LP64)
            ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte)),
            ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.mpg123_getformat.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.mpg123_format_none.argtypes = [ctypes.c_void_p]
        lib.mpg123_format.argtypes = [
            ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
        ]
        init = getattr(lib, "mpg123_init", None)
        if init is not None:
            init()
        _LIB = lib
        return lib
    return None


def available() -> bool:
    return _load() is not None


# ---------------------------------------------------------------------------
# ID3v2 tag parsing (v2.3 plain sizes / v2.4 syncsafe), audio.rs:168-236
# equivalent field set.
# ---------------------------------------------------------------------------


def _syncsafe(b: bytes) -> int:
    return (b[0] << 21) | (b[1] << 14) | (b[2] << 7) | b[3]


def _decode_text(body: bytes) -> str:
    if not body:
        return ""
    enc, rest = body[0], body[1:]
    try:
        if enc == 0:
            s = rest.decode("latin-1")
        elif enc == 1:
            s = rest.decode("utf-16")
        elif enc == 2:
            s = rest.decode("utf-16-be")
        else:
            s = rest.decode("utf-8")
    except (UnicodeDecodeError, LookupError):
        s = rest.decode("latin-1", "replace")
    return s.strip("\x00").strip() or ""


def _split_term(buf: bytes, enc: int) -> tuple[bytes, bytes]:
    """Split at the encoding's NUL terminator.

    UTF-16 terminators are 2-byte code units; a byte-level search for
    b"\\x00\\x00" lands one byte early on any ASCII UTF-16LE text (…41 00
    followed by 00 00), corrupting the remainder — so scan aligned pairs.
    """
    if enc in (1, 2):
        for i in range(0, len(buf) - 1, 2):
            if buf[i] == 0 and buf[i + 1] == 0:
                return buf[:i], buf[i + 2 :]
        return buf, b""
    desc, _, rest = buf.partition(b"\x00")
    return desc, rest


#: ID3v2.2 3-char frame IDs -> their v2.3/2.4 equivalents (id3v2-00 §4).
_V22_IDS = {
    b"TT2": b"TIT2", b"TP1": b"TPE1", b"TAL": b"TALB", b"TP2": b"TPE2",
    b"TCO": b"TCON", b"TYE": b"TYER", b"TRK": b"TRCK", b"TBP": b"TBPM",
    b"COM": b"COMM", b"PIC": b"APIC",
}


def parse_id3v2(data: bytes) -> tuple[AudioMetadata, int]:
    """Parse a leading ID3v2 block -> (metadata, total header bytes).

    Returns (empty metadata, 0) when no tag is present.  Handles v2.2
    (3-byte IDs/sizes, translated via _V22_IDS), v2.3 (big-endian frame
    sizes) and v2.4 (syncsafe frame sizes).
    """
    md = AudioMetadata(source_format="mp3")
    if len(data) < 10 or data[:3] != b"ID3":
        return md, 0
    ver_major, flags = data[3], data[5]
    size = _syncsafe(data[6:10])
    total = 10 + size + (10 if flags & 0x10 else 0)  # footer flag
    body = bytearray(data[10 : 10 + size])
    v22 = ver_major <= 2
    if v22 and flags & 0x40:  # v2.2 'compression' bit: tag is unparseable
        return md, min(total, len(data))
    if flags & 0x80 and ver_major < 4:
        # Whole-tag unsynchronisation: in v2.2/2.3 frame sizes describe the
        # DE-unsynced bytes. In v2.4 the tag flag only says every frame is
        # unsynced — sizes count the on-disk bytes, so de-unsync per frame.
        body = bytearray(bytes(body).replace(b"\xff\x00", b"\xff"))
    if not v22 and flags & 0x40:  # extended header: skip it
        if ver_major >= 4:
            ext = _syncsafe(bytes(body[0:4]))
        else:
            ext = struct.unpack(">I", bytes(body[0:4]))[0] + 4
        body = body[ext:]

    texts: dict[str, str] = {}
    pos = 0
    hdr = 6 if v22 else 10
    while pos + hdr <= len(body):
        if v22:
            raw_id = bytes(body[pos : pos + 3])
            if raw_id == b"\x00\x00\x00":
                break
            fid = _V22_IDS.get(raw_id, b"????")
            fsize = int.from_bytes(bytes(body[pos + 3 : pos + 6]), "big")
            fflags = 0
        else:
            fid = bytes(body[pos : pos + 4])
            if fid == b"\x00\x00\x00\x00":
                break
            if ver_major >= 4:
                fsize = _syncsafe(bytes(body[pos + 4 : pos + 8]))
            else:
                fsize = struct.unpack(">I", bytes(body[pos + 4 : pos + 8]))[0]
            fflags = struct.unpack(">H", bytes(body[pos + 8 : pos + 10]))[0]
        fbody = bytes(body[pos + hdr : pos + hdr + fsize])
        pos += hdr + fsize
        if ver_major >= 4 and (fflags & 0x02 or flags & 0x80):  # frame unsync
            fbody = fbody.replace(b"\xff\x00", b"\xff")
        if not v22 and fflags:
            # Frame format flags: strip the extra header bytes they add, skip
            # frames we cannot interpret (encrypted; compressed that fails).
            if ver_major >= 4:  # v2.4 %0h00kmnp
                if fflags & 0x40:  # h: grouping identity byte
                    fbody = fbody[1:]
                if fflags & 0x04:  # m: encrypted — method byte, opaque body
                    continue
                if fflags & 0x01:  # p: 4-byte data length indicator
                    fbody = fbody[4:]
                if fflags & 0x08:  # k: zlib-compressed
                    try:
                        fbody = zlib.decompress(fbody)
                    except zlib.error:
                        continue
            else:  # v2.3 %(compression)(encryption)(grouping)00000 00000000
                if fflags & 0x0040:  # encrypted
                    continue
                if fflags & 0x0080:  # compressed: 4-byte size, then zlib
                    grp = 1 if fflags & 0x0020 else 0
                    try:
                        fbody = zlib.decompress(fbody[4 + grp :])
                    except zlib.error:
                        continue
                elif fflags & 0x0020:  # grouping identity byte
                    fbody = fbody[1:]
        if fid.startswith(b"T") and fid != b"TXXX":
            texts[fid.decode("ascii", "replace")] = _decode_text(fbody)
        elif fid == b"COMM" and len(fbody) > 4:
            enc = fbody[0]
            rest = fbody[4:]  # skip encoding + 3-byte language
            _desc, text = _split_term(rest, enc)
            texts.setdefault("COMM", _decode_text(bytes([enc]) + text))
        elif fid == b"APIC" and md.cover_art is None:
            enc = fbody[0]
            if v22:
                # v2.2 PIC: 3-char image format instead of a MIME string.
                fmt = fbody[1:4].decode("latin-1", "replace").strip().lower()
                mime_s = {"png": "image/png", "jpg": "image/jpeg"}.get(
                    fmt, "image/" + (fmt or "unknown")
                )
                rest = fbody[5:]  # skip picture type byte
                _desc, pic = _split_term(rest, enc)
                if pic:
                    md.cover_art = (mime_s, pic)
            else:
                mime, _, rest = fbody[1:].partition(b"\x00")
                if rest:
                    rest = rest[1:]  # picture type byte
                    _desc, pic = _split_term(rest, enc)
                    if pic:
                        md.cover_art = (mime.decode("latin-1", "replace"), pic)

    md.title = texts.get("TIT2") or None
    md.artist = texts.get("TPE1") or None
    md.album = texts.get("TALB") or None
    md.album_artist = texts.get("TPE2") or None
    md.genre = texts.get("TCON") or None
    md.comment = texts.get("COMM") or None
    year = texts.get("TDRC") or texts.get("TYER")
    if year:
        try:
            md.year = int(year[:4])
        except ValueError:
            pass
    if texts.get("TRCK"):
        try:
            md.track_number = int(texts["TRCK"].split("/")[0])
        except ValueError:
            pass
    if texts.get("TBPM"):
        try:
            md.bpm = float(texts["TBPM"])
        except ValueError:
            pass
    return md, min(total, len(data))


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


@dataclass
class Mp3Decoded:
    samples: np.ndarray  # interleaved f32
    sample_rate: int
    channels: int
    metadata: AudioMetadata


def decode(data: bytes) -> Mp3Decoded:
    """Decode an MP3 byte buffer to interleaved f32 samples + tags."""
    lib = _load()
    if lib is None:
        raise Mp3Error(
            "MP3 input needs the system libmpg123, which is not present"
        )
    md, _ = parse_id3v2(data)

    err = ctypes.c_int(0)
    h = lib.mpg123_new(None, ctypes.byref(err))
    if not h:
        raise Mp3Error(f"mpg123_new failed (code {err.value})")
    try:
        if lib.mpg123_open_feed(h) != _MPG123_OK:
            raise Mp3Error("mpg123_open_feed failed")
        # Deterministic output: s16 at the stream's own rate/channels.
        if lib.mpg123_format_none(h) == _MPG123_OK:
            for r in _MPEG_RATES:
                lib.mpg123_format(h, r, 3, _ENC_SIGNED_16)
        if lib.mpg123_feed(h, data, len(data)) != _MPG123_OK:
            raise Mp3Error("mpg123_feed failed")

        rate = ctypes.c_long(0)
        channels = ctypes.c_int(0)
        encoding = ctypes.c_int(0)
        num = ctypes.c_long(0)
        audio = ctypes.POINTER(ctypes.c_ubyte)()
        nbytes = ctypes.c_size_t(0)
        chunks: list[np.ndarray] = []
        while True:
            rc = lib.mpg123_decode_frame(
                h, ctypes.byref(num), ctypes.byref(audio), ctypes.byref(nbytes)
            )
            if rc == _MPG123_NEW_FORMAT:
                lib.mpg123_getformat(
                    h, ctypes.byref(rate), ctypes.byref(channels),
                    ctypes.byref(encoding),
                )
                if encoding.value != _ENC_SIGNED_16:
                    raise Mp3Error(
                        f"unexpected mpg123 output encoding {encoding.value:#x}"
                    )
                continue
            if rc == _MPG123_OK:
                if nbytes.value and audio:
                    buf = ctypes.string_at(audio, nbytes.value)
                    chunks.append(np.frombuffer(buf, dtype="<i2"))
                continue
            if rc in (_MPG123_NEED_MORE, _MPG123_DONE):
                break
            raise Mp3Error(f"mpg123 decode error (code {rc})")
    finally:
        lib.mpg123_delete(h)

    if not chunks or rate.value <= 0 or channels.value <= 0:
        raise Mp3Error("no decodable MPEG audio frames found")
    pcm = np.concatenate(chunks)
    # Same i16 -> f32 scale as the reference's sample conversion
    # (audio.rs:238-275): s / 32768.
    samples = (pcm.astype(np.float32) / np.float32(32768.0)).reshape(-1)
    return Mp3Decoded(samples, int(rate.value), int(channels.value), md)
