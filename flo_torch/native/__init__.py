"""Native (C++) host code with a build at first use and ctypes binding.

The port's copy of the reference's host natives, cut down to the six sources
the port calls:

- rice.cpp     — Rice bitstream pack/unpack (rice.rs equivalent) and the
                 in-place LPC reconstruction of the single-frame host decode
- blockpack.cpp — the bulk encodes' fused f32 -> int32 marshals
                 (``encode_marshal_f32`` lossless, ``lossy_marshal_f32`` lossy)
                 and the single-file decode finalizer
                 (``midside_interleave_f32``)
- sparse.cpp   — sparse run-length coefficient coder of the lossy frames
                 (dense rows or sorted CSR entries in, entries or rows out)
- encode.cpp   — lossless best-of-N candidate search (encoder.rs:173-217 +
                 lpc.rs), the single-file host encode
- analysis.cpp — BLAKE3 (parallel tree), K-weighting biquads, true-peak FIR
                 (analysis.rs / ebu_r128.rs hot loops, for bulk auto-embed)
- ingest.cpp   — AAC/M4A ingest shim over the system's libavformat and
                 libavcodec (``aac.py``); builds only where they are installed

Each source is compiled by g++ at first use into ``build/flo_torch/native/``
beside the package, under a name keyed by a hash of the source and the
flags, so a changed source builds a new library and nothing is written into
the package. Without a toolchain every function returns None (or False) and
its caller takes the vectorized numpy path, so importing never requires g++.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import pathlib
import subprocess
import threading

import numpy as np

_DIR = pathlib.Path(__file__).resolve().parent
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "flo_torch" / "native"
_lock = threading.Lock()
_libs: dict = {}

_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i16p = ctypes.POINTER(ctypes.c_int16)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_f64p = ctypes.POINTER(ctypes.c_double)
_f32p = ctypes.POINTER(ctypes.c_float)

_SIGNATURES = {
    "rice": {
        "rice_sizes": [_i32p, ctypes.c_int64, ctypes.c_int64, _i64p, _i32p, _i64p],
        "rice_encode_batch": [
            _i32p, ctypes.c_int64, ctypes.c_int64, _i64p, _i32p, _i64p, _u8p
        ],
        "rice_decode_batch": [
            _u8p, _i64p, _i64p, _i32p, _i64p, ctypes.c_int64, ctypes.c_int64, _i32p
        ],
        "lpc_reconstruct_batch": [
            _i32p, ctypes.c_int64, ctypes.c_int64, _i32p, _i32p, _i32p, _u8p, _i64p
        ],
    },
    "blockpack": {
        "midside_interleave_f32": [
            _i32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, _u8p,
            _i64p, ctypes.c_float, _f32p,
        ],
        "encode_marshal_f32": [
            _f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_float, ctypes.c_float, _u8p, _i64p,
            _i32p,
        ],
        "lossy_marshal_f32": [
            _f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_float, _i32p,
        ],
    },
    "sparse": {
        "sparse_sizes": [_i16p, ctypes.c_int64, ctypes.c_int64, _i64p],
        "sparse_encode": [_i16p, ctypes.c_int64, ctypes.c_int64, _i64p, _u8p],
        "sparse_decode": [
            _u8p, _i64p, _i64p, ctypes.c_int64, ctypes.c_int64, _i16p
        ],
        "sparse_entry_counts": [
            _u8p, _i64p, _i64p, ctypes.c_int64, ctypes.c_int64, _i64p
        ],
        "sparse_decode_entries": [
            _u8p, _i64p, _i64p, _i64p, ctypes.c_int64, ctypes.c_int64, _i32p
        ],
        "sparse_sizes_csr": [
            _i32p, _i64p, _i32p, ctypes.c_int64, ctypes.c_int64, _i64p
        ],
        "sparse_encode_csr": [
            _i32p, _i64p, _i32p, ctypes.c_int64, ctypes.c_int64, _i64p, _u8p
        ],
    },
    "encode": {
        "lossless_search_batch": [
            _i32p, ctypes.c_int64, ctypes.c_int64, _i64p,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            _i32p, _i32p, _i32p, _i32p, _i32p, _i64p, _i32p,
        ],
    },
    "ingest": {
        # AAC/M4A ingest shim over the system libavformat/libavcodec
        # (ingest.cpp): a handle-based API, see aac.py.
        "flo_ingest_decode": [_u8p, ctypes.c_int64],
        "flo_ingest_encode_aac": [
            _f32p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
        ],
        "flo_ingest_error": [ctypes.c_void_p],
        "flo_ingest_rate": [ctypes.c_void_p],
        "flo_ingest_channels": [ctypes.c_void_p],
        "flo_ingest_nsamples": [ctypes.c_void_p],
        "flo_ingest_samples": [ctypes.c_void_p, _f32p],
        "flo_ingest_ntags": [ctypes.c_void_p],
        "flo_ingest_tag_key": [ctypes.c_void_p, ctypes.c_int],
        "flo_ingest_tag_val": [ctypes.c_void_p, ctypes.c_int],
        "flo_ingest_cover_size": [ctypes.c_void_p],
        "flo_ingest_cover_mime": [ctypes.c_void_p],
        "flo_ingest_cover": [ctypes.c_void_p, _u8p],
        "flo_ingest_bytes_size": [ctypes.c_void_p],
        "flo_ingest_bytes": [ctypes.c_void_p, _u8p],
        "flo_ingest_free": [ctypes.c_void_p],
    },
    "analysis": {
        "blake3_digest": [_u8p, ctypes.c_int64, _u8p],
        "kweight_cascade": [_f64p, ctypes.c_int64, ctypes.c_int64, _f64p],
        "fir_absmax": [
            _f64p, ctypes.c_int64, ctypes.c_int64, _f64p, ctypes.c_int64,
            ctypes.c_int64, _f64p,
        ],
        "loudness_pass": [
            _f32p, ctypes.c_int64, ctypes.c_int64, _f64p, _f64p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, _f64p, _f64p,
        ],
        "sumsq_f32": [_f32p, ctypes.c_int64],
    },
}

#: fn -> ctypes restype for non-void natives (ctypes defaults to c_int).
_RESTYPES = {
    "sumsq_f32": ctypes.c_double,
    "encode_marshal_f32": ctypes.c_int64,
    "flo_ingest_decode": ctypes.c_void_p,
    "flo_ingest_encode_aac": ctypes.c_void_p,
    "flo_ingest_error": ctypes.c_char_p,
    "flo_ingest_nsamples": ctypes.c_int64,
    "flo_ingest_tag_key": ctypes.c_char_p,
    "flo_ingest_tag_val": ctypes.c_char_p,
    "flo_ingest_cover_size": ctypes.c_int64,
    "flo_ingest_cover_mime": ctypes.c_char_p,
    "flo_ingest_bytes_size": ctypes.c_int64,
}

#: module -> extra g++ flags (system libraries the shim links against).
_LINK_FLAGS = {
    "ingest": ("-lavformat", "-lavcodec", "-lavutil"),
}

#: g++ command lines, tried in turn; the first names the library.
_COMPILERS = (
    ("g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC"),
    ("g++", "-O3", "-shared", "-fPIC"),
    ("cc", "-O2", "-shared", "-fPIC", "-x", "c++", "-lstdc++"),
)


def library_path(name: str) -> pathlib.Path:
    """Where ``<name>.cpp`` builds to: keyed by its bytes and the flags."""
    h = hashlib.sha256(repr((_COMPILERS, _LINK_FLAGS.get(name, ()))).encode())
    h.update((_DIR / f"{name}.cpp").read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _build(src: pathlib.Path, out: pathlib.Path, link: tuple = ()) -> bool:
    """Compile ``src`` into ``out`` unless another process already has; one
    process builds at a time (a lock file beside the libraries)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        if out.exists():
            return True
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        for cmd in _COMPILERS:
            try:
                res = subprocess.run(
                    [*cmd, str(src), "-o", str(tmp), *link], capture_output=True, timeout=300
                )
            except (OSError, subprocess.SubprocessError):
                continue
            if res.returncode == 0 and tmp.exists():
                os.replace(tmp, out)
                return True
        tmp.unlink(missing_ok=True)
        return False


def _load(name: str):
    with _lock:
        if name in _libs:
            return _libs[name]
        lib = None
        try:
            so = library_path(name)
            if so.exists() or _build(_DIR / f"{name}.cpp", so, _LINK_FLAGS.get(name, ())):
                lib = ctypes.CDLL(str(so))
                for fn, argtypes in _SIGNATURES[name].items():
                    getattr(lib, fn).argtypes = argtypes
                    if fn in _RESTYPES:
                        getattr(lib, fn).restype = _RESTYPES[fn]
        except OSError:
            lib = None
        _libs[name] = lib
        return lib


def available() -> bool:
    return _load("rice") is not None


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


# ---------------- Rice ----------------


def rice_encode_batch(rows: np.ndarray, ks: np.ndarray, lengths: np.ndarray):
    """C++ batch Rice pack; returns list of per-stream bytes or None."""
    lib = _load("rice")
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    n, stride = rows.shape
    ks = np.ascontiguousarray(ks, dtype=np.int32)
    lengths = np.ascontiguousarray(lengths, dtype=np.int64)
    sizes = np.empty(n, dtype=np.int64)
    lib.rice_sizes(
        _ptr(rows, ctypes.c_int32), n, stride,
        _ptr(lengths, ctypes.c_int64), _ptr(ks, ctypes.c_int32),
        _ptr(sizes, ctypes.c_int64),
    )
    offsets = np.zeros(n, dtype=np.int64)
    np.cumsum(sizes[:-1], out=offsets[1:])
    total = int(offsets[-1] + sizes[-1]) if n else 0
    out = np.zeros(total, dtype=np.uint8)
    if total:
        lib.rice_encode_batch(
            _ptr(rows, ctypes.c_int32), n, stride,
            _ptr(lengths, ctypes.c_int64), _ptr(ks, ctypes.c_int32),
            _ptr(offsets, ctypes.c_int64), _ptr(out, ctypes.c_uint8),
        )
    buf = out.tobytes()
    return [buf[int(offsets[i]) : int(offsets[i] + sizes[i])] for i in range(n)]


def rice_decode_batch(blobs, ks, lengths, out_width: int):
    """C++ batch Rice unpack into [n, out_width] int32, or None."""
    n = len(blobs)
    blob_lens = np.array([len(b) for b in blobs], dtype=np.int64)
    offsets = np.zeros(n, dtype=np.int64)
    np.cumsum(blob_lens[:-1], out=offsets[1:])
    cat = np.frombuffer(b"".join(blobs), dtype=np.uint8) if n else np.zeros(0, np.uint8)
    return rice_decode_concat(cat, offsets, blob_lens, ks, lengths, out_width)


def rice_decode_concat(cat, offsets, blob_lens, ks, lengths, out_width: int):
    """rice_decode_batch over an already-concatenated byte buffer (skips the
    per-blob split/join)."""
    lib = _load("rice")
    if lib is None:
        return None
    n = len(offsets)
    cat = np.ascontiguousarray(cat, dtype=np.uint8)
    if cat.size == 0:
        cat = np.zeros(1, dtype=np.uint8)  # valid pointer for empty input
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    blob_lens = np.ascontiguousarray(blob_lens, dtype=np.int64)
    ks = np.ascontiguousarray(ks, dtype=np.int32)
    lengths = np.ascontiguousarray(lengths, dtype=np.int64)
    out = np.zeros((n, out_width), dtype=np.int32)
    if n:
        lib.rice_decode_batch(
            _ptr(cat, ctypes.c_uint8), _ptr(offsets, ctypes.c_int64),
            _ptr(blob_lens, ctypes.c_int64), _ptr(ks, ctypes.c_int32),
            _ptr(lengths, ctypes.c_int64), n, out_width,
            _ptr(out, ctypes.c_int32),
        )
    return out


def lpc_reconstruct_into(rows: np.ndarray, coeffs, shifts, orders, is_fixed,
                         lengths) -> bool:
    """C++ in-place LPC/fixed reconstruction over [L, S] int32 residual rows
    (decoder.rs:92-273 semantics: i64 MAC >> shift, int32 wrap, fixed-lane
    warm-up ramp). The host half of the streaming/seeking single-frame decode
    path, where a device round trip a frame would be pure latency.
    Returns False if the native lib is missing (callers take the device
    decode)."""
    lib = _load("rice")
    if lib is None:
        return False
    assert rows.dtype == np.int32 and rows.flags.c_contiguous
    n, stride = rows.shape
    if n == 0:
        return True
    coeffs = np.ascontiguousarray(coeffs, dtype=np.int32)
    assert coeffs.shape == (n, 12)  # ops/lpc.MAX_ORDER, hardcoded in the C++
    shifts = np.ascontiguousarray(shifts, dtype=np.int32)
    orders = np.ascontiguousarray(orders, dtype=np.int32)
    fx = np.ascontiguousarray(np.asarray(is_fixed), dtype=np.uint8)
    lengths = np.ascontiguousarray(lengths, dtype=np.int64)
    lib.lpc_reconstruct_batch(
        _ptr(rows, ctypes.c_int32), n, stride,
        _ptr(coeffs, ctypes.c_int32), _ptr(shifts, ctypes.c_int32),
        _ptr(orders, ctypes.c_int32), _ptr(fx, ctypes.c_uint8),
        _ptr(lengths, ctypes.c_int64),
    )
    return True


# ---------------- Single-file decode finalizer ----------------


def midside_interleave_f32(rows, mid_side, frame_lengths, channels: int,
                           scale: float):
    """Single-file decode finalizer: mid/side undo + interleave + i32->f32
    in one C++ pass over reconstructed rows [F*C, S]. The sums ``m + s`` and
    ``m - s`` are taken in int64 and halved toward zero, as
    ``lossless.decoder.decode_file_i32`` does on the host (the device decode
    wraps them in int32 first: they differ only where a sum leaves int32).
    Returns the flat f32 array, or None when the native lib is unavailable."""
    lib = _load("blockpack")
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, np.int32)
    FC, S = rows.shape
    F = FC // max(channels, 1)
    mid_side = np.ascontiguousarray(mid_side, np.uint8)
    frame_lengths = np.ascontiguousarray(frame_lengths, np.int64)
    out = np.empty(int(frame_lengths.sum()) * channels, np.float32)
    if F:
        lib.midside_interleave_f32(
            _ptr(rows, ctypes.c_int32), F, channels, S,
            _ptr(mid_side, ctypes.c_uint8),
            _ptr(frame_lengths, ctypes.c_int64),
            ctypes.c_float(scale), _ptr(out, ctypes.c_float),
        )
    return out


# ---------------- Bulk-encode marshal ----------------


def encode_marshal_f32(flat, total: int, C: int, spf: int, thresh: float,
                       scale: float, lanes: np.ndarray, row0: int):
    """Bulk-encode marshal: interleaved f32 [total, C] -> compacted
    lane-major i32 frames written at ``lanes[row0:]`` in one pass, silence
    detection included. Returns (n_active, silent[F] bool,
    active_idx[n_active]) or None when the native lib is unavailable."""
    lib = _load("blockpack")
    if lib is None:
        return None
    F = -(-total // spf) if total else 0
    assert flat.dtype == np.float32 and flat.flags.c_contiguous
    assert lanes.dtype == np.int32 and lanes.flags.c_contiguous
    silent = np.zeros(F, np.uint8)
    active_idx = np.zeros(F, np.int64)
    n_active = 0
    if F:
        n_active = lib.encode_marshal_f32(
            _ptr(flat, ctypes.c_float), total, C, spf, F,
            ctypes.c_float(thresh), ctypes.c_float(scale),
            _ptr(silent, ctypes.c_uint8), _ptr(active_idx, ctypes.c_int64),
            _ptr(lanes[row0:], ctypes.c_int32),
        )
    return int(n_active), silent.astype(bool), active_idx[:n_active]


def lossy_marshal_f32(flat, n: int, C: int, hop: int, scale: float,
                      rows: np.ndarray) -> bool:
    """One file's interleaved f32 -> pre-rolled i32 channel rows
    ([C, stride], pre-zeroed) in one pass: sample j of channel c at
    rows[c, hop+j] = clamp(rint(x*scale)). Returns False when the native
    lib is unavailable."""
    lib = _load("blockpack")
    if lib is None:
        return False
    assert flat.dtype == np.float32 and flat.flags.c_contiguous
    assert rows.dtype == np.int32 and rows.flags.c_contiguous
    if n:
        lib.lossy_marshal_f32(
            _ptr(flat, ctypes.c_float), n, C, hop, rows.shape[1],
            ctypes.c_float(scale), _ptr(rows, ctypes.c_int32),
        )
    return True


# ---------------- Sparse RLE ----------------


def _offsets(sizes: np.ndarray):
    """(exclusive prefix sums, total) of a 1-D int64 size array."""
    n = len(sizes)
    offsets = np.zeros(n, dtype=np.int64)
    np.cumsum(sizes[:-1], out=offsets[1:])
    return offsets, (int(offsets[-1] + sizes[-1]) if n else 0)


def _split(out: np.ndarray, offsets, sizes) -> list:
    buf = out.tobytes()
    return [buf[int(o) : int(o + s)] for o, s in zip(offsets, sizes)]


def _concat_blobs(blobs):
    """Byte strings -> (one uint8 buffer with a valid base pointer, offsets,
    lengths)."""
    lens = np.array([len(b) for b in blobs], dtype=np.int64)
    offsets, _ = _offsets(lens)
    cat = np.frombuffer(b"".join(blobs), dtype=np.uint8) if len(blobs) else np.zeros(0, np.uint8)
    cat = np.ascontiguousarray(cat)
    if cat.size == 0:
        cat = np.zeros(1, dtype=np.uint8)
    return cat, offsets, lens


def sparse_encode_batch(rows: np.ndarray):
    """C++ sparse RLE over [n, width] i16 rows -> list of bytes, or None."""
    lib = _load("sparse")
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, dtype=np.int16)
    n, width = rows.shape
    sizes = np.empty(n, dtype=np.int64)
    lib.sparse_sizes(_ptr(rows, ctypes.c_int16), n, width, _ptr(sizes, ctypes.c_int64))
    offsets, total = _offsets(sizes)
    out = np.zeros(max(total, 1), dtype=np.uint8)
    if n:
        lib.sparse_encode(
            _ptr(rows, ctypes.c_int16), n, width,
            _ptr(offsets, ctypes.c_int64), _ptr(out, ctypes.c_uint8),
        )
    return _split(out, offsets, sizes)


def sparse_encode_entries_csr(entries: np.ndarray, row_nnz: np.ndarray,
                              width: int):
    """C++ sparse RLE straight from sorted (col<<16|val) entries.

    entries: [total] i32, row-major (row r owns the slice starting at
    cumsum(row_nnz)[r-1], cols strictly ascending within a row: the device
    compaction's output order, ops/compact.py); row_nnz: [n] int. Emits
    byte-identical streams to sparse_encode_batch on the equivalent dense
    rows without ever materializing them. Returns list[bytes] or None.
    """
    lib = _load("sparse")
    if lib is None:
        return None
    entries = np.ascontiguousarray(entries, dtype=np.int32)
    row_nnz = np.ascontiguousarray(row_nnz, dtype=np.int32)
    n = len(row_nnz)
    row_off, _ = _offsets(row_nnz.astype(np.int64))
    if entries.size == 0:
        entries = np.zeros(1, dtype=np.int32)  # valid base pointer
    sizes = np.empty(n, dtype=np.int64)
    lib.sparse_sizes_csr(
        _ptr(entries, ctypes.c_int32), _ptr(row_off, ctypes.c_int64),
        _ptr(row_nnz, ctypes.c_int32), n, width, _ptr(sizes, ctypes.c_int64),
    )
    offsets, total = _offsets(sizes)
    out = np.zeros(max(total, 1), dtype=np.uint8)
    if n:
        lib.sparse_encode_csr(
            _ptr(entries, ctypes.c_int32), _ptr(row_off, ctypes.c_int64),
            _ptr(row_nnz, ctypes.c_int32), n, width,
            _ptr(offsets, ctypes.c_int64), _ptr(out, ctypes.c_uint8),
        )
    return _split(out, offsets, sizes)


def sparse_decode_batch(blobs, width: int):
    """C++ sparse RLE decode -> [n, width] i16, or None."""
    lib = _load("sparse")
    if lib is None:
        return None
    n = len(blobs)
    cat, offsets, lens = _concat_blobs(blobs)
    out = np.zeros((n, width), dtype=np.int16)
    if n:
        lib.sparse_decode(
            _ptr(cat, ctypes.c_uint8), _ptr(offsets, ctypes.c_int64),
            _ptr(lens, ctypes.c_int64), n, width, _ptr(out, ctypes.c_int16),
        )
    return out


def sparse_decode_entries(blobs, width: int):
    """C++ sparse RLE -> row-major (col<<16 | i16 value) int32 entries.

    Returns (entries int32 [total_nnz], stream_nnz int64 [n]) or None.
    Zero VALUES inside nonzero runs are dropped, matching dense+np.nonzero.
    """
    lib = _load("sparse")
    if lib is None:
        return None
    n = len(blobs)
    cat, offsets, lens = _concat_blobs(blobs)
    counts = np.zeros(n, dtype=np.int64)
    if n:
        lib.sparse_entry_counts(
            _ptr(cat, ctypes.c_uint8), _ptr(offsets, ctypes.c_int64),
            _ptr(lens, ctypes.c_int64), n, width, _ptr(counts, ctypes.c_int64),
        )
    entry_off, total = _offsets(counts)
    entries = np.zeros(max(total, 1), dtype=np.int32)
    if n:
        lib.sparse_decode_entries(
            _ptr(cat, ctypes.c_uint8), _ptr(offsets, ctypes.c_int64),
            _ptr(lens, ctypes.c_int64), _ptr(entry_off, ctypes.c_int64),
            n, width, _ptr(entries, ctypes.c_int32),
        )
    return entries[:total], counts


# ---------------- Analysis ----------------


def blake3_digest(data) -> bytes | None:
    """C++ parallel BLAKE3 (32-byte digest), or None without a toolchain."""
    lib = _load("analysis")
    if lib is None:
        return None
    if isinstance(data, np.ndarray):
        buf = np.ascontiguousarray(data).reshape(-1).view(np.uint8)
    else:
        buf = np.frombuffer(data, dtype=np.uint8)  # zero-copy on bytes
    if buf.size == 0:
        buf = np.zeros(1, dtype=np.uint8)
        n = 0
    else:
        n = buf.size
    out = np.zeros(32, dtype=np.uint8)
    lib.blake3_digest(_ptr(buf, ctypes.c_uint8), n, _ptr(out, ctypes.c_uint8))
    return out.tobytes()


def kweight_cascade(x: np.ndarray, coefs: np.ndarray):
    """In-place K-weighting over [lanes, n] f64 rows, or None."""
    lib = _load("analysis")
    if lib is None:
        return None
    assert x.dtype == np.float64 and x.flags.c_contiguous
    coefs = np.ascontiguousarray(coefs, dtype=np.float64)
    lanes, n = x.shape
    lib.kweight_cascade(
        _ptr(x, ctypes.c_double), lanes, n, _ptr(coefs, ctypes.c_double)
    )
    return x


def fir_absmax(x: np.ndarray, h: np.ndarray, center: int):
    """Per-lane max|conv(x, h)| over [lanes, n] f64 rows, or None."""
    lib = _load("analysis")
    if lib is None:
        return None
    x = np.ascontiguousarray(x, dtype=np.float64)
    h = np.ascontiguousarray(h, dtype=np.float64)
    lanes, n = x.shape
    out = np.zeros(lanes, dtype=np.float64)
    lib.fir_absmax(
        _ptr(x, ctypes.c_double), lanes, n, _ptr(h, ctypes.c_double),
        len(h), center, _ptr(out, ctypes.c_double),
    )
    return out


def loudness_pass(interleaved: np.ndarray, channels: int, cf: np.ndarray,
                  h: np.ndarray, center: int, hop: int):
    """Fused EBU R128 prep: (seg_energy_sums, true_peak, sample_peak) or None.

    interleaved: f32 [n*C]; returns (seg f64 [n//hop + 1] summed over
    channels — element [n//hop] is the partial tail — tp_linear,
    sample_peak_linear).
    """
    lib = _load("analysis")
    if lib is None:
        return None
    x = np.ascontiguousarray(interleaved, dtype=np.float32)
    C = max(int(channels), 1)
    n = x.size // C
    nseg = n // hop if hop > 0 else 0
    seg = np.zeros(nseg + 1, dtype=np.float64)
    peaks = np.zeros(2, dtype=np.float64)
    cf = np.ascontiguousarray(cf, dtype=np.float64)
    h = np.ascontiguousarray(h, dtype=np.float64)
    lib.loudness_pass(
        _ptr(x, ctypes.c_float), n, C, _ptr(cf, ctypes.c_double),
        _ptr(h, ctypes.c_double), len(h), center, hop,
        _ptr(seg, ctypes.c_double), _ptr(peaks, ctypes.c_double),
    )
    return seg, float(peaks[0]), float(peaks[1])


def sumsq_f32(x: np.ndarray):
    """f64-accumulated sum of squares of an f32 array, or None."""
    lib = _load("analysis")
    if lib is None:
        return None
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1)
    if x.size == 0:
        return 0.0
    return float(lib.sumsq_f32(_ptr(x, ctypes.c_float), x.size))


# ---------------- Lossless search ----------------


def lossless_search_batch(lanes: np.ndarray, nvalid: np.ndarray,
                          max_order: int, use_lpc: bool,
                          prune_lpc: int = 0):
    """C++ per-lane best-of-N candidate search (encoder.rs:173-217 + lpc.rs).

    lanes: [L, S] int32 (mid/side domain); nvalid: [L] int64. Returns
    (sel_kind [L] 0=raw/1=fixed/2=lpc, sel_order, k, coeffs [L,12], shift,
    size_bytes [L] i64, residuals [L, S] i32) or None without a toolchain.

    prune_lpc=0 evaluates the full LPC order set (byte parity with the
    reference search); K>0 evaluates only the K best predicted orders from
    the Levinson prediction error (see encode.cpp).
    """
    lib = _load("encode")
    if lib is None:
        return None
    lanes = np.ascontiguousarray(lanes, dtype=np.int32)
    L, S = lanes.shape
    nvalid = np.ascontiguousarray(nvalid, dtype=np.int64)
    sel_kind = np.zeros(L, np.int32)
    sel_order = np.zeros(L, np.int32)
    k = np.zeros(L, np.int32)
    coeffs = np.zeros((L, 12), np.int32)
    shift = np.zeros(L, np.int32)
    size = np.zeros(L, np.int64)
    residuals = np.zeros((L, S), np.int32)
    if L:
        lib.lossless_search_batch(
            _ptr(lanes, ctypes.c_int32), L, S, _ptr(nvalid, ctypes.c_int64),
            int(max_order), int(bool(use_lpc)), int(prune_lpc),
            _ptr(sel_kind, ctypes.c_int32), _ptr(sel_order, ctypes.c_int32),
            _ptr(k, ctypes.c_int32), _ptr(coeffs, ctypes.c_int32),
            _ptr(shift, ctypes.c_int32), _ptr(size, ctypes.c_int64),
            _ptr(residuals, ctypes.c_int32),
        )
    return sel_kind, sel_order, k, coeffs, shift, size, residuals
