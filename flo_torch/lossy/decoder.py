"""Lossy (MDCT transform) decoder: a batched device path.

Behavioral model: libflo/src/lossy/decoder.rs + lib.rs:325-352, batched as in
the reference's ``lossy/decoder.py``: all frames' coefficients are
dequantized and IMDCT'd in one pass, the reference's stateful per-channel
overlap buffer becomes a stateless shifted add over the block axis, and the
pre-roll frame's output is dropped (lib.rs:341-345). Under a mesh
(``parallel.pipeline``) each chunk's files are sharded over its devices.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native, tracing
from ..container import reader
from ..core.types import FloFile
from ..futures import BulkFuture
from ..ops import compact, mdct, psycho
from ..parallel import pipeline
from .sparse import deserialize_sparse

_BLOCK_SIZES = {0: 2048, 1: 256, 2: 2048, 3: 2048}  # Long/Short/Start/Stop


def _parse_frame_blob(data: bytes):
    """Parse one transform blob -> (n, sf_u16 [C, 25] uint16, [sparse bytes
    per channel]) or None on truncation (decoder.rs:61-131). Scale factors
    stay in wire form and sparse streams stay encoded so bulk callers can
    decode both in single vectorized passes."""
    if len(data) < 2:
        return None
    bs = data[0]
    if bs not in _BLOCK_SIZES:
        return None
    n = _BLOCK_SIZES[bs]
    C = data[1]
    pos = 2
    need = 2 * psycho.NUM_BARK_BANDS
    if pos + need * C > len(data):
        return None
    sf_u16 = (
        np.frombuffer(data, dtype="<u2", count=psycho.NUM_BARK_BANDS * C, offset=pos)
        .reshape(C, psycho.NUM_BARK_BANDS)
    )
    pos += need * C
    streams = []
    for c in range(C):
        if pos + 4 > len(data):
            return None
        ln = int.from_bytes(data[pos : pos + 4], "little")
        pos += 4
        if pos + ln > len(data):
            return None
        streams.append(data[pos : pos + ln])
        pos += ln
    return n, sf_u16, streams


def decode_sf_u16(sf_u16: np.ndarray) -> np.ndarray:
    """Wire-form scale factors -> f32 (decoder.rs:96-99), any shape."""
    return np.where(
        sf_u16 > 0,
        np.exp2((sf_u16.astype(np.float32) - 32768.0) / 256.0),
        np.float32(0.0),
    )


def deserialize_frame_raw(data: bytes):
    """Parse one transform blob -> (n, sf [C, 25] f32, [sparse bytes per
    channel]) or None on truncation (decoder.rs:61-131)."""
    p = _parse_frame_blob(data)
    if p is None:
        return None
    n, sf_u16, streams = p
    return n, decode_sf_u16(sf_u16), streams


def _sparse_decode_rows(streams, n2: int) -> np.ndarray:
    """[len(streams), n2] i16 via the native batch decoder (numpy fallback)."""
    out = native.sparse_decode_batch(streams, n2)
    if out is not None:
        return out
    rows = np.zeros((len(streams), n2), dtype=np.int16)
    for i, s in enumerate(streams):
        rows[i] = deserialize_sparse(s, n2)
    return rows


def deserialize_frame(data: bytes, expect_n2: int | None = None):
    """Parse one transform blob -> (n, sf [C, 25] f32, q [C, n/2] i16) or
    None on truncation (decoder.rs:61-131). ``expect_n2`` is accepted for
    the reference's signature; the blob's own size field decides."""
    raw = deserialize_frame_raw(data)
    if raw is None:
        return None
    n, sf, streams = raw
    return n, sf, _sparse_decode_rows(streams, n // 2)


def _decode_blocks(q, sf, sample_rate: int, n: int):
    """q [..., T, C, n2] integer, sf [..., T, C, 25] -> segments [..., T, n2, C].

    Dequantize (decoder.rs:38-45: c = q / sf[band] when sf > 0), batched
    IMDCT, stateless overlap-add over T. Leading axes (e.g. a file batch)
    broadcast through.
    """
    band = psycho.tables_to_device(sample_rate, n, q.device)[1]
    sf_bin = sf.index_select(-1, band)  # [..., T, C, n2]
    coeffs = torch.where(sf_bin > 0, q.to(torch.float32) / sf_bin.clamp_min(1e-30), 0.0)
    del sf_bin
    recon = mdct.inverse(coeffs, n, "vorbis")  # [..., T, C, n]
    del coeffs
    segs = mdct.overlap_add(recon.movedim(-3, -2))  # [..., C, T, n2]
    return segs.movedim(-3, -1)  # [..., T, n2, C]


def _to_i16(s):
    """Float samples -> the i16 output domain, round half to even, int16."""
    return torch.round(s * 32767.0).clamp(-32768.0, 32767.0).to(torch.int16)


def _decode_blocks_packed(entries, row_nnz, sf, sample_rate: int, n: int):
    """Sparse upload, int16 download: the host ships 4 bytes a nonzero
    coefficient (ops/compact.py), the dense [N, T, C, n2] grid is rebuilt on
    the device, dequantized and IMDCT'd, and the samples are rounded to the
    i16 output domain there. Returns [N, T, n2, C] int16."""
    N, T, C = sf.shape[:3]
    n2 = n // 2
    q = compact.expand_nonzeros(entries, row_nnz, N * T * C, n2).reshape(N, T, C, n2)
    return _to_i16(_decode_blocks(q, sf, sample_rate, n))


def decode_file(flo: FloFile, *, device="cuda") -> np.ndarray:
    """Decode a parsed lossy file to interleaved f32 (pre-roll dropped)."""
    return decode_many([flo], device=device)[0]


def decode(data: bytes, *, device="cuda") -> np.ndarray:
    return decode_file(reader.read(data), device=device)


def _parse_batch(flos):
    """Every file's frames parsed into one batch: (n, C, rate, counts [N],
    sf float32 [N, t_max, C, 25], streams in (file, frame, channel) order),
    or None when no file has a frame. Raises on a truncated blob and on
    files that differ in block size, channels or rate."""
    parsed_files = []
    for flo in flos:
        parsed = []
        for f in flo.frames:
            if not f.channels:
                continue
            p = _parse_frame_blob(f.channels[0].residuals)
            if p is None:
                raise ValueError("Failed to deserialize transform frame")
            parsed.append(p)
        parsed_files.append(parsed)
    if not parsed_files or all(not p for p in parsed_files):
        return None
    n = next(p[0][0] for p in parsed_files if p)
    C = next(len(p[0][2]) for p in parsed_files if p)
    rate = flos[0].header.sample_rate
    t_max = max(len(p) for p in parsed_files)

    all_streams = []
    sf_u16 = np.zeros((len(flos), t_max, C, psycho.NUM_BARK_BANDS), dtype=np.uint16)
    for i, parsed in enumerate(parsed_files):
        for t, (nn, s, streams) in enumerate(parsed):
            if nn != n or len(streams) != C or flos[i].header.sample_rate != rate:
                raise ValueError("decode_many requires homogeneous files")
            sf_u16[i, t] = s
            all_streams.extend(streams)
    counts = np.array([len(p) for p in parsed_files], dtype=np.int64)
    # One vectorized pass over the whole batch's scale factors.
    return n, C, int(rate), counts, decode_sf_u16(sf_u16), all_streams


def _sparse_entries(all_streams, n2: int):
    """The streams' nonzeros as (entries int32 [total], nnz int64 [streams]):
    the C++ RLE walker emits the device entry form directly; the fallback
    goes dense + np.nonzero."""
    ent = native.sparse_decode_entries(all_streams, n2)
    if ent is not None:
        return ent
    all_rows = _sparse_decode_rows(all_streams, n2)
    rid, cid = np.nonzero(all_rows)
    entries = compact.make_entries(cid.astype(np.int32), all_rows[rid, cid])
    return entries, np.bincount(rid, minlength=len(all_streams)).astype(np.int64)


def _chunks(counts, C: int, sf, entries_all, stream_nnz):
    """The batch cut into (at most two, from four files on) file sub-batches,
    so that the device holds one half's temporaries at a time: yields (lo,
    entries [nnz], row_nnz [files*t_max*C], sf [files, t_max, C, 25]) as
    numpy, ``lo`` the chunk's first file. Stream order is the padded grid's row-major order; frames a
    file does not have are rows with no entry."""
    N, t_max = sf.shape[:2]
    entry_off = np.concatenate([[0], np.cumsum(stream_nnz)])
    s0 = np.concatenate([[0], np.cumsum(counts * C)])
    half = N // 2 if N >= 4 else N
    for lo in range(0, N, half):
        hi = min(lo + half, N)
        g = np.zeros((hi - lo, t_max, C), np.int32)
        for i in range(lo, hi):
            g[i - lo, : counts[i]] = stream_nnz[s0[i] : s0[i + 1]].reshape(-1, C)
        e_lo, e_hi = int(entry_off[s0[lo]]), int(entry_off[s0[hi]])
        yield lo, entries_all[e_lo:e_hi], g.reshape(-1), sf[lo:hi]


def _finish_chunk(host: np.ndarray, lo: int, hi: int, counts, outs: list) -> None:
    """host [files, T, n2, C] int16 of the files from ``lo`` on -> each
    file's interleaved float32 (x 1/32767) into ``outs``. Frame 0 is the
    pre-roll and is dropped; frames past a file's own count are the batch's
    padding, and files from ``hi`` on are a mesh's padding."""
    scale = np.float32(1.0 / 32767.0)
    for k in range(min(host.shape[0], hi - lo)):
        body = host[k, 1 : max(int(counts[lo + k]), 1)]
        outs[lo + k] = np.multiply(body.reshape(-1), scale, dtype=np.float32)  # one pass


def to_device(*arrays, device="cuda"):
    """Numpy arrays (or slices of them) as tensors on ``device``."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays)


def _shard_files(entries, row_nnz, sf, mesh):
    """One chunk's (entries, row_nnz, sf) cut by files into one shard a
    device of ``mesh`` (one device: the chunk whole), the files padded to a
    mesh multiple with files of no frame (zero scale factors, no entry):
    [(entries, row_nnz, sf, device)]."""
    nnz = pipeline.split_batch(row_nnz.reshape(sf.shape[0], -1), mesh)
    ends = np.cumsum([int(g.sum()) for g in nnz])[:-1]
    return [
        (e, g.reshape(-1), s, d)
        for e, g, s, d in zip(np.split(entries, ends), nnz, pipeline.split_batch(sf, mesh),
                              mesh.devices)
    ]


def decode_many_async(flos: list[FloFile], *, device="cuda", mesh=None) -> BulkFuture:
    """Bulk decode: all files' blocks in chunked device calls (T padded to
    the batch max; every file must share sample_rate/block size/channels).
    All device work is dispatched before this returns; ``result()`` brings
    the int16 samples down, scales them by 1/32767 to float32, drops each
    file's pre-roll frame and gives one interleaved array per file.

    ``mesh`` (or the ambient ``parallel.use_mesh``; it overrides
    ``device``): each chunk's files are padded to a mesh multiple and cut
    into one shard a device. Without one, ``device`` is a mesh of one shard.
    """
    mesh = pipeline.active_mesh(mesh) or pipeline.Mesh((device,))
    with tracing.span("decode.parse", mode="lossy") as sp:
        batch = _parse_batch(flos)
        if batch is None:
            return BulkFuture(lambda: [np.zeros(0, dtype=np.float32) for _ in flos])
        n, C, rate, counts, sf, all_streams = batch
        # Sparse upload: 4 bytes per nonzero coefficient instead of the dense
        # i16 grid.
        entries_all, stream_nnz = _sparse_entries(all_streams, n // 2)
        if sp:
            sp.add(frames=int(counts.sum()), nonzeros=len(entries_all))
    handles = []
    for lo, entries, row_nnz, sf_c in _chunks(counts, C, sf, entries_all, stream_nnz):
        shards = []
        for e, g, s, d in _shard_files(entries, row_nnz, sf_c, mesh):
            with tracing.span("decode.upload"):
                up = to_device(e, g, s, device=d)
            with tracing.span("decode.enqueue", files=s.shape[0]):
                shards.append(_decode_blocks_packed(*up, rate, n))
        handles.append((lo, lo + sf_c.shape[0], shards))

    def fin() -> list[np.ndarray]:
        outs = [None] * len(flos)
        for lo, hi, shards in handles:
            for pcm in shards:
                with tracing.span("decode.download"):
                    host = pcm.cpu().numpy()
                with tracing.span("decode.finish"):
                    _finish_chunk(host, lo, hi, counts, outs)
                lo += pcm.shape[0]
        return outs

    return BulkFuture(fin)


def decode_many(flos: list[FloFile], *, device="cuda", mesh=None) -> list[np.ndarray]:
    """Blocking form of decode_many_async."""
    return decode_many_async(flos, device=device, mesh=mesh).result()
