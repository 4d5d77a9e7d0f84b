"""Lossy (MDCT transform) encoder: a fully batched device path.

Behavioral model: libflo/src/lossy/encoder.rs:63-239, batched as in the
reference's ``lossy/encoder.py``: the whole file becomes a [C, T, 2048] block
tensor (a 50%-overlap strided view), one pass computes MDCT -> SMR (the
temporal-masking scan over T) -> per-Bark scale factors -> i16 quantization
for every block at once, the nonzeros are compacted on the device, and the
host packs the sparse RLE payloads and the container. Under a mesh
(``parallel.pipeline``) each chunk's lanes are sharded over its devices.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native, tracing
from ..container import writer
from ..core.constants import FrameType
from ..core.types import ChannelData, Frame
from ..futures import BulkFuture
from ..ops import compact, mdct, psycho
from ..parallel import pipeline
from .sparse import serialize_sparse

BLOCK = mdct.LONG_N  # always Long/2048 + Vorbis (encoder.rs:36-53)
HOP = BLOCK // 2
WINDOW = "vorbis"

_PACKED = ("packed", "rice16")


def smr_threshold(quality: float) -> float:
    """Quality -> SMR gate in dB (encoder.rs:130-136)."""
    q = min(max(float(quality), 0.0), 1.0)
    if q >= 0.99:
        return -100.0
    t = max(1.0 - q, 0.001)
    return -60.0 * (1.0 - t**0.5)


def _band_max(mag, sample_rate: int):
    """Largest magnitude of each Bark band: mag [..., n2] -> [..., 25]. A
    band is one run of bins (``psycho.band_bounds``), so this is 25 small
    reductions instead of a [..., n2, 25] product; a band with no bin gives
    0, as a maximum over the one-hot products does."""
    bounds = psycho.band_bounds(sample_rate, BLOCK)
    out = mag.new_zeros(*mag.shape[:-1], psycho.NUM_BARK_BANDS)
    for b, (lo, hi) in enumerate(zip(bounds, bounds[1:])):
        if hi > lo:
            out[..., b] = mag[..., lo:hi].amax(dim=-1)
    return out


def _quantize_gated(coeffs, smr, sample_rate: int, thr: float):
    """Quantization per encoder.rs:109-152 given the SMR: per-Bark sf =
    30000/max|c| (1.0 for empty/tiny bands), coefficients at SMR <=
    threshold zeroed, others round-half-away-from-zero and clamped to i16.
    Returns (q int16 [..., T, 1024], sf float32 [..., T, 25])."""
    band = psycho.tables_to_device(sample_rate, BLOCK, coeffs.device)[1]
    band_max = _band_max(coeffs.abs(), sample_rate)
    sf = torch.where(band_max > 1e-10, 30000.0 / band_max.clamp_min(1e-30), 1.0)

    scaled = coeffs * sf.index_select(-1, band)
    q = torch.sign(scaled) * torch.floor(scaled.abs() + 0.5)
    q = q.clamp(-32768.0, 32767.0)
    q = torch.where(smr > float(thr), q, 0.0).to(torch.int16)
    return q, sf


def _quantize_coeffs(coeffs, sample_rate: int, thr: float):
    """coeffs [..., T, 1024] float32 -> (quantized int16 [..., T, 1024], scale
    factors float32 [..., T, 25]): the SMR (temporal masking carried over T),
    then :func:`_quantize_gated`."""
    return _quantize_gated(coeffs, psycho.smr(coeffs, sample_rate, BLOCK), sample_rate, thr)


def _blocks(padded):
    """padded [C, (T+1)*1024] signal on the device -> the 50%-overlap blocks
    [C, T, 2048] float32, a strided view of the signal (each block = two
    adjacent 1024-sample segments): the upload is half the block tensor, and
    no block tensor is stored.

    float32, or float16 (the halved upload), or int16 PCM (the "packed"
    transport: scaled by 1/32767 here).
    """
    if padded.dtype == torch.int16:
        padded = padded.to(torch.float32) * (1.0 / 32767.0)
    else:
        padded = padded.to(torch.float32)
    return padded.unfold(-1, BLOCK, HOP)


def _encode_blocks(blocks, sample_rate: int, thr: float):
    """Blocks [..., T, 2048] float32 on the device -> (q [..., T, 1024] int16,
    sf [..., T, 25] float32): the MDCT, then :func:`_quantize_coeffs`."""
    return _quantize_coeffs(mdct.forward(blocks, BLOCK, WINDOW), sample_rate, thr)


def _encode_padded(padded, sample_rate: int, thr: float):
    """padded [C, (T+1)*1024] signal on the device -> (q [C, T, 1024] int16,
    sf [C, T, 25] float32)."""
    return _encode_blocks(_blocks(padded), sample_rate, thr)


def encode_sf_u16(sf: np.ndarray) -> np.ndarray:
    """f32 scale factors -> log-u16 wire form (encoder.rs:259-269)."""
    sf = np.asarray(sf, dtype=np.float32)
    log_sf = np.clip(np.log2(np.maximum(sf, 1e-37)) * 256.0 + 32768.0, 0.0, 65535.0)
    out = np.trunc(log_sf).astype(np.uint16)
    return np.where(sf > 1e-10, out, np.uint16(0))


def _file_padded(samples: np.ndarray, channels: int):
    """Pre-rolled, hop-padded signal [C, (num_hops+1)*1024] per
    encoder.rs:167-239 framing (blocks are folded on the device)."""
    samples = np.asarray(samples, dtype=np.float32).reshape(-1)
    C = int(channels)
    n = len(samples) // C
    total = n + HOP
    num_hops = -(-total // HOP)
    padded_len = (num_hops + 1) * HOP
    padded = np.zeros((C, padded_len), dtype=np.float32)
    deint = samples[: n * C].reshape(n, C).T if n else np.zeros((C, 0), np.float32)
    usable = min(n, padded_len - HOP)
    padded[:, HOP : HOP + usable] = deint[:, :usable]
    return padded, num_hops


def _assemble_frames(
    q: np.ndarray, sf_u16: np.ndarray, C: int, num_hops: int, payloads=None
) -> list[Frame]:
    """payloads: optional pre-computed sparse streams indexed [c][t]."""
    frames = []
    # One LE conversion for the whole [C, T, 25] table (hot loop below).
    sf_le = np.ascontiguousarray(sf_u16.astype("<u2"))
    for t in range(num_hops):
        blob = bytearray([0, C])  # Long block marker + channel count
        for c in range(C):
            blob += sf_le[c, t].tobytes()
        for c in range(C):
            payload = payloads[c][t] if payloads is not None else serialize_sparse(q[c, t])
            blob += len(payload).to_bytes(4, "little")
            blob += payload
        frames.append(
            Frame(
                frame_type=int(FrameType.TRANSFORM),
                frame_samples=HOP,
                channels=[ChannelData.transform(bytes(blob))],
            )
        )
    return frames


def _marshal(samples_list, C: int, transport_dtype):
    """Every file's channel lanes stacked and hop-padded to the batch's
    longest file: (stacked [N*C, (t_max+1)*1024], hops per file). The array
    is what goes up: float32, float16, or for the "packed" transport int16
    PCM (``clamp(rint(x * 32767))`` in one C++ pass a file)."""
    if isinstance(transport_dtype, str) and transport_dtype in _PACKED:
        flats, hops = [], []
        for s in samples_list:
            arr = np.asarray(s, dtype=np.float32).reshape(-1)
            n = len(arr) // C
            flats.append((arr, n))
            hops.append(-(-(n + HOP) // HOP))
        t_max = max(hops, default=0)
        stacked = np.zeros((len(flats) * C, (t_max + 1) * HOP), np.int32)
        for i, (arr, n) in enumerate(flats):
            rows = stacked[i * C : (i + 1) * C]
            if not native.lossy_marshal_f32(
                np.ascontiguousarray(arr[: n * C]), n, C, HOP, 32767.0, rows
            ):
                padded, _ = _file_padded(arr, C)
                rows[:, : padded.shape[1]] = np.clip(
                    np.rint(padded * np.float32(32767.0)), -32768, 32767
                ).astype(np.int32)
        return stacked.astype(np.int16), hops
    per_file = [_file_padded(s, C) for s in samples_list]
    hops = [nh for _, nh in per_file]
    t_max = max(hops, default=0)
    stacked = np.zeros((len(per_file) * C, (t_max + 1) * HOP), dtype=transport_dtype)
    for i, (padded, _) in enumerate(per_file):
        stacked[i * C : (i + 1) * C, : padded.shape[1]] = padded
    return stacked, hops


def _chunk_bounds(N: int, C: int):
    """Lane ranges of the (at most two, from four files on) sub-batches: the
    device holds one half's temporaries at a time."""
    half = (N // 2) * C if N >= 4 else N * C
    return [(lo, min(lo + half, N * C)) for lo in range(0, N * C, half)]


def _download_chunk(shards, lanes: int):
    """Compact one chunk's nonzeros on each shard's device and bring them
    down, joined in lane order: (entries int32 [total], row_nnz int32
    [lanes*T], sf float32 [lanes, T, 25]) as numpy. A compaction's count is
    its shard's one wait. Lanes past ``lanes`` (mesh padding: zero blocks,
    no nonzero) are dropped."""
    parts = []
    for q, sf in shards:
        Lc, T, n2 = q.shape
        entries, row_nnz = compact.compact_nonzeros(q.reshape(Lc * T, n2))
        parts.append((entries.cpu().numpy(), row_nnz.cpu().numpy(), sf.cpu().numpy()))
    entries, row_nnz, sf = (np.concatenate(x) for x in zip(*parts))
    row_nnz = row_nnz[: lanes * sf.shape[1]]
    return entries[: int(row_nnz.sum())], row_nnz, sf[:lanes]


def _sparse_streams(ent_parts, t_max: int):
    """The chunks' (entries, row_nnz, sf) -> (streams, q): one native
    sparse-RLE pass straight from the CSR entries gives every row's stream
    (the dense [rows, 1024] grid is never built on the host, ``q`` is None);
    without a toolchain the dense rows ``q`` [N*C, T, 1024] for the Python
    serializer (``streams`` is None)."""
    nnz_all = np.concatenate([r for _, r, _ in ent_parts])
    entries_all = np.concatenate([e for e, _, _ in ent_parts])
    flat = native.sparse_encode_entries_csr(entries_all, nnz_all, HOP)
    if flat is not None:
        return flat, None
    R = int(nnz_all.size)
    cols, vals = compact.split_entries(entries_all)
    q = np.zeros((R, HOP), np.int16)
    if len(cols):
        q[np.repeat(np.arange(R), nnz_all), cols] = vals
    return None, q.reshape(-1, t_max, HOP)


def _assemble_files(flat, q, sf, hops, C: int, t_max: int) -> list[list[Frame]]:
    """Every file's frames from the rows' streams ``flat`` (or the dense rows
    ``q``: see :func:`_sparse_streams`) and the scale factors sf [N*C, T, 25].
    Frames past a file's own hop count (zero padding) are never emitted."""
    sf_u16 = encode_sf_u16(sf)
    out = []
    for i, nh in enumerate(hops):
        if flat is not None:
            payloads = [
                flat[(i * C + c) * t_max : (i * C + c) * t_max + nh] for c in range(C)
            ]
        else:
            payloads = None
        qi = None if q is None else q[i * C : (i + 1) * C]
        out.append(_assemble_frames(qi, sf_u16[i * C : (i + 1) * C], C, nh, payloads))
    return out


def _pack_frames(ent_parts, hops, C: int, t_max: int) -> list[list[Frame]]:
    """The chunks' (entries, row_nnz, sf) -> every file's frames."""
    with tracing.span("encode.sparse_rle") as sp:
        if sp:
            sp.add(nonzeros=sum(len(e) for e, _, _ in ent_parts))
        flat, q = _sparse_streams(ent_parts, t_max)
    with tracing.span("encode.assemble") as sp:
        if sp:
            sp.add(frames=sum(hops))
        sf = np.concatenate([sf for _, _, sf in ent_parts])
        return _assemble_files(flat, q, sf, hops, C, t_max)


def encode_many_to_frames_async(
    samples_list, sample_rate: int, channels: int, quality: float,
    transport_dtype=np.float32, *, device="cuda", mesh=None,
) -> BulkFuture:
    """Bulk blocked MDCT encode: all files' channel lanes stacked into
    chunked device calls (hop counts padded to the batch max; padding blocks
    are all-zero and their frames are never emitted). The uploads and the
    MDCT, SMR and quantization of every chunk are dispatched before this
    returns; ``result()`` compacts, downloads and packs.

    transport_dtype=np.float16 halves the upload; the MDCT input is then
    f16-quantized (~1e-4), inside the lossy tolerance at every preset.
    transport_dtype="packed" uploads int16 PCM (i16-rounded, ~1.5e-5
    quantization; one C++ host pass). The legacy alias "rice16" is accepted.

    ``mesh`` (or the ambient ``parallel.use_mesh``; it overrides
    ``device``): each chunk's lanes are padded to a mesh multiple with zero
    lanes and cut into one shard a device; decodes lie within 1.5 i16 steps
    of the unsharded encode's. Without one, ``device`` is a mesh of one
    shard.
    """
    mesh = pipeline.active_mesh(mesh) or pipeline.Mesh((device,))
    C = int(channels)
    with tracing.span("encode.marshal") as sp:
        stacked, hops = _marshal(samples_list, C, transport_dtype)
        if sp:
            sp.add(frames=sum(hops))
    t_max = max(hops, default=0)
    if t_max == 0:
        return BulkFuture(lambda: [[] for _ in samples_list])
    thr = smr_threshold(quality)
    handles = []
    for lo, hi in _chunk_bounds(len(hops), C):
        with tracing.span("encode.upload"):
            shards = pipeline.put_batch(stacked[lo:hi], mesh)
        with tracing.span("encode.enqueue", lanes=hi - lo):
            handles.append(([_encode_padded(p, int(sample_rate), thr) for p in shards], hi - lo))

    def fin() -> list[list[Frame]]:
        parts = []
        for h in handles:
            with tracing.span("encode.download"):
                parts.append(_download_chunk(*h))
        return _pack_frames(parts, hops, C, t_max)

    return BulkFuture(fin)


def encode_many_to_frames(
    samples_list, sample_rate: int, channels: int, quality: float,
    transport_dtype=np.float32, *, device="cuda", mesh=None,
) -> list[list[Frame]]:
    """Blocking form of encode_many_to_frames_async."""
    return encode_many_to_frames_async(
        samples_list, sample_rate, channels, quality, transport_dtype, device=device, mesh=mesh
    ).result()


def encode_to_frames(
    samples: np.ndarray, sample_rate: int, channels: int, quality: float, *, device="cuda"
) -> list[Frame]:
    """Blocked MDCT encode (encoder.rs:167-239): 1024-sample pre-roll, pad to
    (num_hops+1)*1024, one Transform frame of 1024 samples per hop, each frame
    a single serialized blob pseudo-channel."""
    return encode_many_to_frames([samples], sample_rate, channels, quality, device=device)[0]


def quality_u8(quality: float) -> int:
    """Continuous quality 0.0-1.0 -> the header's u8 preset field."""
    return min(int(round(min(max(float(quality), 0.0), 1.0) * 4.0)), 4)


def encode_many_async(
    samples_list,
    sample_rate: int,
    channels: int,
    quality: float,
    metadata_list=None,
    bit_depth: int = 16,
    transport_dtype=np.float32,
    *,
    device="cuda",
    mesh=None,
) -> BulkFuture:
    """Bulk lossy encode, dispatched immediately; result() -> file bytes."""
    fut = encode_many_to_frames_async(
        samples_list, sample_rate, channels, quality, transport_dtype, device=device, mesh=mesh
    )
    metas = metadata_list or [b""] * len(samples_list)
    return fut.then(
        lambda frames_per_file: [
            writer.write(
                int(sample_rate), int(channels), int(bit_depth), 5, frames, meta,
                lossy=True, lossy_quality=quality_u8(quality),
            )
            for frames, meta in zip(frames_per_file, metas)
        ]
    )


def encode_many(
    samples_list,
    sample_rate: int,
    channels: int,
    quality: float,
    metadata_list=None,
    bit_depth: int = 16,
    transport_dtype=np.float32,
    *,
    device="cuda",
    mesh=None,
) -> list[bytes]:
    """Bulk lossy encode: one device pass for every file (blocking form)."""
    return encode_many_async(
        samples_list, sample_rate, channels, quality, metadata_list, bit_depth,
        transport_dtype, device=device, mesh=mesh,
    ).result()


def encode(
    samples: np.ndarray,
    sample_rate: int,
    channels: int,
    quality: float,
    metadata: bytes = b"",
    bit_depth: int = 16,
    *,
    device="cuda",
) -> bytes:
    """Encode interleaved f32 samples to a lossy flo file."""
    return encode_many(
        [samples], sample_rate, channels, quality, [metadata], bit_depth, device=device
    )[0]
