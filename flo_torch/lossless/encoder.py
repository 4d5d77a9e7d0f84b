"""Lossless encoder: the single-file host path and the bulk device path.

Single file (f32 input, default compat): one 1 s frame at a time on the
host -- silence detection, f32 -> i32, the exact mid/side decision, the C++
best-of-N candidate search (``native/encode.cpp``) and the C++ Rice pack.

Bulk (:func:`encode_many`; also integer input and ``compat="reference-bugs"``
through :func:`encode`): every (frame, channel) lane of many files in one
device pass per chunk.

1. Marshal (host): interleaved f32 -> lane-major int32 frames with silence
   detection, by the reference's fused C++ marshal
   (``native.encode_marshal_f32``); integer input is taken as the sample
   domain directly.
2. Analysis: ``"exact"`` on the host (the exact mid/side decision, the exact
   integer autocorrelation and the float64 Levinson-Durbin for every order,
   sent to the device by :func:`tables_to_device`), or ``"device"`` in
   float32 on the device (``ops/select.device_analysis``).
3. Device: int16 PCM up, mid/side lanes, the exact candidate search
   (``ops/select``; the kernel ``csrc/lossless_select.cu`` on the card) and
   the Rice / raw-LE16 pack (``ops/blockspread``; ``csrc/rice_pack.cu``).
4. Host: the packed bytes come down, are sliced per lane, and the container
   writer assembles the files.

``analysis="exact"`` gives the single-file encode's bytes. The reference's
TPU wire transport (block-packed uploads, speculative fetches), its host
re-pack of ``bad`` lanes and its ``mesh`` argument have no counterpart.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from .._flo_host import native
from .._flo_host.container import writer
from .._flo_host.core import rice_host
from .._flo_host.core.constants import (
    FIXED_PREDICTOR_MARKER,
    FRAME_FLAG_MID_SIDE,
    I16_MAX_F32,
    LPC_ORDER_BY_LEVEL,
    MIN_LEVEL_FOR_LPC,
    SILENCE_THRESHOLD,
    FrameType,
    ResidualEncoding,
)
from .._flo_host.core.convert import f32_to_i32_np
from .._flo_host.core.types import ChannelData, Frame
from .._flo_host.futures import BulkFuture
from ..ops import blockspread, lpc, select

_I16_MIN, _I16_MAX = -(1 << 15), (1 << 15) - 1


def _candidate_plan(compression_level: int):
    """Candidate list in the reference's evaluation order.

    Returns (kinds, orders, max_order): kind 'raw' | 'fixed' | 'lpc'.
    """
    max_order = LPC_ORDER_BY_LEVEL[min(compression_level, 9)]
    kinds = ["raw"]
    orders = [0]
    for o in range(0, min(4, max_order) + 1):
        kinds.append("fixed")
        orders.append(o)
    if compression_level >= MIN_LEVEL_FOR_LPC and max_order > 4:
        for o in range(5, max_order + 1):
            kinds.append("lpc")
            orders.append(o)
    return kinds, orders, max_order


def _autocorr_int_exact(lanes: np.ndarray, nvalid: np.ndarray, max_order: int) -> np.ndarray:
    """Exact integer autocorrelation lags 0..max_order (lpc.rs:213-221).

    float64 is exact for the codec's sample domain (products <= 2^34, sums
    <= 2^52), so any summation order gives the same result; one batched
    matmul per lag. Zero padding beyond nvalid contributes nothing.
    """
    S = lanes.shape[1]
    mask = np.arange(S)[None, :] < nvalid[:, None]
    x = np.where(mask, lanes, 0).astype(np.float64)
    cols = [np.matmul(x[:, None, :], x[:, :, None])[:, 0, 0]]
    for lag in range(1, max_order + 1):
        cols.append(np.matmul(x[:, None, lag:], x[:, : S - lag, None])[:, 0, 0])
    return np.stack(cols, axis=1)


def _check_i16(flat: np.ndarray) -> None:
    """Integer input must lie in the int16 range: the bulk path uploads it as
    int16, and a wrapped sample would decode to another value."""
    if flat.size and (flat.min() < _I16_MIN or flat.max() > _I16_MAX):
        raise ValueError(
            f"integer samples must lie in [{_I16_MIN}, {_I16_MAX}]; got "
            f"[{int(flat.min())}, {int(flat.max())}]"
        )


def _marshal(samples_list, C: int, spf: int):
    """Host marshal of a bulk encode: every file's interleaved samples ->
    lane-major int32 frames [F'*C, spf] of its non-silent frames (frame f's
    channel c at row f*C+c), by the reference's fused C++ marshal for f32
    input. Returns (lanes, nvalid per active frame [F'] int64, the frame
    lists with their silent frames filled in, (file, frame) of each active
    frame)."""
    metas = []  # (flat, is_int, total, num_frames)
    F_sum = 0
    for samples in samples_list:
        arr = np.asarray(samples)
        is_int = np.issubdtype(arr.dtype, np.integer)
        flat = arr.reshape(-1)
        total = len(flat) // C
        if is_int:
            _check_i16(flat[: total * C])
        num_frames = -(-total // spf) if total else 0
        metas.append((flat, is_int, total, num_frames))
        F_sum += num_frames

    # Worst case: every frame active. Each file's non-silent frames are
    # written compactly at a running row offset.
    lanes_batch = np.empty((F_sum * C, spf), np.int32)
    row = 0
    all_frames: List[List[Frame]] = []
    active_nvalid = []
    active_slots = []  # (file_idx, frame_idx)
    for fidx, (flat, is_int, total, num_frames) in enumerate(metas):
        if num_frames == 0:
            all_frames.append([])
            continue
        frame_samples = np.full(num_frames, spf, dtype=np.int64)
        frame_samples[-1] = total - (num_frames - 1) * spf
        res = None
        if not is_int:
            flat32 = np.ascontiguousarray(flat[: total * C], np.float32)
            res = native.encode_marshal_f32(
                flat32, total, C, spf, SILENCE_THRESHOLD, float(I16_MAX_F32), lanes_batch, row
            )
        if res is not None:
            n_act, silent, active_idx = res
        else:
            # Integer input (silence is exact zeroness there), or no C++.
            if is_int:
                padded = np.zeros(num_frames * spf * C, dtype=np.int32)
                padded[: total * C] = flat[: total * C]
                fsc = padded.reshape(num_frames, spf, C)
                silent = (fsc == 0).all(axis=(1, 2))
            else:
                padded = np.zeros(num_frames * spf * C, dtype=np.float32)
                padded[: total * C] = flat[: total * C].astype(np.float32)
                f32 = padded.reshape(num_frames, spf, C)
                silent = (np.abs(f32) < SILENCE_THRESHOLD).all(axis=(1, 2))
                fsc = f32_to_i32_np(f32)
            active_idx = np.flatnonzero(~silent)
            n_act = len(active_idx)
            if n_act:
                lanes_batch[row : row + n_act * C] = np.ascontiguousarray(
                    np.moveaxis(fsc[active_idx], 2, 1)
                ).reshape(-1, spf)
        frames: List[Frame] = [None] * num_frames  # type: ignore[list-item]
        for fi in np.flatnonzero(silent):
            frames[fi] = Frame(
                frame_type=int(FrameType.SILENCE),
                frame_samples=int(frame_samples[fi]),
                channels=[ChannelData.silence() for _ in range(C)],
            )
        all_frames.append(frames)
        for fi in active_idx:
            active_nvalid.append(frame_samples[fi])
            active_slots.append((fidx, int(fi)))
        row += n_act * C
    # [F'*C, S] lane-major, frame-compacted
    return lanes_batch[:row], np.asarray(active_nvalid, dtype=np.int64), all_frames, active_slots


def encode_many_to_frames_async(
    samples_list,
    sample_rate: int,
    channels: int,
    compression_level: int = 5,
    analysis: str = "exact",
    compat: str = "fixed",
    *,
    device="cuda",
) -> BulkFuture:
    """Encode many files (same rate and channels) in one batched pass.

    All files' non-silent (frame, channel) lanes go through chunked device
    searches on ``device``. The device work is dispatched before this
    returns; the future's ``result()`` downloads the packed payloads and
    yields one frame list per input file. Integer input is the sample
    domain itself and must lie in the int16 range (``ValueError``
    otherwise).
    """
    C = int(channels)
    spf = int(sample_rate)
    if spf >= (1 << 18):
        raise ValueError("sample_rate too large for exact device aggregation")
    if analysis not in ("exact", "device"):
        raise ValueError(f"analysis must be 'exact' or 'device', got {analysis!r}")
    kinds, cand_orders, max_order = _candidate_plan(compression_level)
    lanes_batch, nvalid_f, all_frames, active_slots = _marshal(samples_list, C, spf)
    if not active_slots:
        return BulkFuture(lambda: all_frames)
    states = _dispatch_active_frames(
        lanes_batch, nvalid_f, C, kinds, cand_orders, analysis, device=device
    )

    def fin() -> List[List[Frame]]:
        frames_out: List[Frame] = []
        for st in states:
            frames_out.extend(_collect_chunk(st, C, kinds, cand_orders, max_order, compat))
        for (fidx, fi), frame in zip(active_slots, frames_out):
            all_frames[fidx][fi] = frame
        return all_frames

    return BulkFuture(fin)


def encode_many_to_frames(
    samples_list,
    sample_rate: int,
    channels: int,
    compression_level: int = 5,
    analysis: str = "exact",
    compat: str = "fixed",
    *,
    device="cuda",
) -> List[List[Frame]]:
    """Blocking form of :func:`encode_many_to_frames_async`."""
    return encode_many_to_frames_async(
        samples_list, sample_rate, channels, compression_level, analysis, compat, device=device
    ).result()


#: Sub-batches a bulk encode is split into, so that one chunk's host work
#: (analysis, assembly) can overlap another's device work.
PIPELINE_CHUNKS = 2


def _chunk_bounds(n_frames: int, n_samples: int):
    """(lo, hi) frame ranges of a bulk encode's sub-batches: PIPELINE_CHUNKS
    of them, more where a chunk would pass ``blockspread.MAX_BATCH_SAMPLES``
    samples (``n_samples`` is the whole batch's)."""
    G = PIPELINE_CHUNKS if n_frames >= 2 * PIPELINE_CHUNKS else 1
    G = max(G, -(-n_samples // blockspread.MAX_BATCH_SAMPLES))
    chunk = -(-n_frames // G)
    return [(g * chunk, min((g + 1) * chunk, n_frames)) for g in range(G) if g * chunk < n_frames]


def _dispatch_active_frames(
    lanes, frame_samples, C, kinds, cand_orders, analysis: str = "exact", *, device="cuda"
):
    """Dispatch a batch of non-silent frames (lane-major [F'*C, S]; frame f's
    channel c at row f*C+c) as sub-batches (:func:`_chunk_bounds`); returns
    the chunk states for :func:`_collect_chunk`."""
    return [
        _dispatch_chunk(
            lanes[lo * C : hi * C], frame_samples[lo:hi], C, kinds, cand_orders, analysis,
            device=device,
        )
        for lo, hi in _chunk_bounds(lanes.shape[0] // C, lanes.size)
    ]


def host_analysis(lanes_in, frame_samples, C, kinds, cand_orders):
    """``analysis="exact"`` on the host: the exact mid/side decision
    (encoder.rs:131-153) and the candidate tables from the exact integer
    autocorrelation and the float64 Levinson-Durbin.

    lanes_in: [F*C, S] int32 L/R lanes; frame_samples [F]. Returns
    (mid_side [F] bool, the five candidate tables as CPU tensors, see
    ``ops/select.candidate_tables``).
    """
    spf = lanes_in.shape[1]
    Fa = lanes_in.shape[0] // C
    ch = lanes_in.reshape(Fa, C, spf)
    mid_side = np.zeros(Fa, dtype=bool)
    if C == 2:
        # einsum with dtype=f64 is exact here (squares <= 2^34, sums <= 2^52).
        l, r = ch[:, 0], ch[:, 1]
        var_l = np.einsum("fs,fs->f", l, l, dtype=np.float64)
        var_r = np.einsum("fs,fs->f", r, r, dtype=np.float64)
        side = l - r
        var_side = np.einsum("fs,fs->f", side, side, dtype=np.float64)
        mid_side = var_side < np.floor_divide(var_l + var_r, 2)
        ch = np.where(mid_side[:, None, None], np.stack([l + r, side], axis=1), ch)

    lanes = ch.reshape(Fa * C, spf)
    nvalid = np.repeat(frame_samples, C).astype(np.int32)
    fit = None
    if "lpc" in kinds:
        max_order = max(o for kd, o in zip(kinds, cand_orders) if kd == "lpc")
        ac = _autocorr_int_exact(lanes, nvalid, max_order)
        fit = [torch.from_numpy(a) for a in lpc.levinson_durbin_all_orders(ac, max_order)]
    tables = select.candidate_tables(torch.from_numpy(nvalid), kinds, cand_orders, fit)
    return mid_side, tables


def tables_to_device(coeffs_all, shifts_all, orders_all, fixed_all, cand_ok, *, device="cuda"):
    """The host-built candidate tables on ``device``: flo has no weights,
    these tables are the state a search is given (same order as
    :func:`host_analysis` returns them)."""
    return tuple(
        t.to(device) for t in (coeffs_all, shifts_all, orders_all, fixed_all, cand_ok)
    )


def pcm_to_device(lanes_in, frame_samples, C: int, *, device="cuda"):
    """Upload one chunk's PCM as int16 [F, C, S] (half the bytes of the int32
    lanes) and its frame lengths [F] int32. The samples are int16 by
    construction: f32 input is clamped by the marshal, integer input is
    checked by :func:`_check_i16`."""
    Fa = lanes_in.shape[0] // C
    pcm16 = lanes_in.reshape(Fa, C, lanes_in.shape[1]).astype(np.int16)
    return (
        torch.from_numpy(pcm16).to(device),
        torch.from_numpy(np.asarray(frame_samples, np.int32)).to(device),
    )


def _max_words(frame_samples, C: int) -> int:
    """Packed words of a chunk at most: a winner is raw (16 bits a sample) or
    strictly smaller, and each lane is word-aligned. The pack's buffer is
    allocated with this bound, without waiting on the search."""
    bits = blockspread.WORST_BITS_PER_SAMPLE * np.asarray(frame_samples, np.int64)
    return int(C * np.sum((bits + 31) >> 5))


def _dispatch_chunk(lanes_in, frame_samples, C, kinds, cand_orders, analysis="exact", *,
                    device="cuda"):
    """Host analysis (if any), uploads, and the device candidate search and
    pack of the winners (Rice streams; raw winners as LE16) of one
    sub-batch, dispatched without waiting on the device."""
    pcm, nvalid_f = pcm_to_device(lanes_in, frame_samples, C, device=device)
    if analysis == "device":
        *search, mid_side = select._select_device_core(pcm, nvalid_f, kinds, cand_orders)
    else:
        mid_side, tables = host_analysis(lanes_in, frame_samples, C, kinds, cand_orders)
        lanes = select._lanes_from_pcm16(pcm, torch.from_numpy(mid_side).to(device))
        search = select.encode_select_best(
            lanes, nvalid_f.repeat_interleave(C), *tables_to_device(*tables, device=device),
            tuple(kd == "lpc" for kd in kinds),
        )
    sel, k, size, residuals, win_c, win_shift = search
    packed = blockspread.pack_best(
        residuals, k, nvalid_f.repeat_interleave(C), sel == 0,
        max_words=_max_words(frame_samples, C),
    )
    return {
        "out": (sel, k, size, *packed, win_c, win_shift),
        "mid_side": mid_side,
        "frame_samples": frame_samples,
    }


def _download_chunk(st, C: int) -> dict:
    """Block on one sub-batch: download its search tables and its packed
    bytes, and check them.

    The packer counts its bytes independently of the search's exact sizes:
    equality checks the device bit packing end to end. Exact selection keeps
    every winner strictly below raw, so the reference's demote-to-raw step
    has nothing to do: asserted here.
    """
    sel_d, k_d, size_d, payload_d, lane_bytes_d, lane_off_d, winc_d, wins_d = st["out"]
    sel, ks, size, lane_bytes, lane_off = (
        t.cpu().numpy().astype(np.int64) for t in (sel_d, k_d, size_d, lane_bytes_d, lane_off_d)
    )
    if not np.array_equal(lane_bytes, size):
        raise AssertionError("device Rice packing size mismatch")
    nvalid = np.repeat(np.asarray(st["frame_samples"], np.int64), C)
    if not np.all((sel == 0) | (size < 2 * nvalid)):
        raise AssertionError("a search winner is not smaller than raw")
    total = int(lane_off[-1] + ((lane_bytes[-1] + 3) // 4) * 4) if len(sel) else 0
    payload = payload_d[:total].cpu().numpy().tobytes()
    if len(payload) != total:
        raise AssertionError("the packed payload is shorter than its lanes")
    mid_side = st["mid_side"]
    if isinstance(mid_side, torch.Tensor):
        mid_side = mid_side.cpu().numpy()
    return {
        "sel": sel, "k": ks, "lane_bytes": lane_bytes, "lane_off": lane_off,
        "payload": payload, "win_coeffs": winc_d.cpu().numpy(),
        "win_shift": wins_d.cpu().numpy(), "mid_side": mid_side,
        "frame_samples": st["frame_samples"],
    }


def _assemble_frames(host: dict, C, kinds, cand_orders, max_order, compat: str = "fixed"):
    """Slice a downloaded sub-batch's payload per lane and build its frames.

    compat="reference-bugs" reproduces the reference encoder byte for byte,
    including its Raw-frame defect (encoder.rs:104-119 + writer.rs:266-268):
    a frame whose channels all won with order 0 -- raw PCM or fixed 0, whose
    payload is Rice bytes -- is typed Raw and written without the ALPC
    framing. The default "fixed" types a frame Raw only when every channel
    chose raw PCM.
    """
    sel, ks, mid_side = host["sel"], host["k"], host["mid_side"]
    lane_off, lane_bytes, pb = host["lane_off"], host["lane_bytes"], host["payload"]

    def blob(lane):
        return pb[lane_off[lane] : lane_off[lane] + lane_bytes[lane]]

    bug_compat = compat == "reference-bugs"
    frames_out: List[Frame] = []
    for idx, n in enumerate(host["frame_samples"]):
        flags = FRAME_FLAG_MID_SIDE if mid_side[idx] else 0
        lanes = range(idx * C, idx * C + C)
        if bug_compat and all(
            kinds[sel[lane]] == "raw"
            or (kinds[sel[lane]] == "fixed" and cand_orders[sel[lane]] == 0)
            for lane in lanes
        ):
            # writer.rs:266-268: Raw channels emit the payload bytes verbatim,
            # so fixed-0 winners lose their Rice framing.
            frames_out.append(
                Frame(
                    frame_type=int(FrameType.RAW),
                    frame_samples=int(n),
                    flags=flags,
                    channels=[ChannelData.raw(blob(lane)) for lane in lanes],
                )
            )
            continue
        chans = []
        all_raw = True
        for lane in lanes:
            ci = int(sel[lane])
            kd = kinds[ci]
            if kd == "raw":
                # A raw winner's packed payload is its verbatim LE16 samples.
                chans.append(ChannelData.raw(blob(lane)))
                continue
            all_raw = False
            if kd == "fixed":
                coeff_list, shift_bits = [], FIXED_PREDICTOR_MARKER + cand_orders[ci]
            else:
                coeff_list = [int(v) for v in host["win_coeffs"][lane][: cand_orders[ci]]]
                shift_bits = int(host["win_shift"][lane])
            chans.append(
                ChannelData(
                    predictor_coeffs=coeff_list,
                    shift_bits=shift_bits,
                    residual_encoding=ResidualEncoding.RICE,
                    rice_parameter=int(ks[lane]),
                    residuals=blob(lane),
                )
            )
        ftype = FrameType.RAW if all_raw else FrameType.from_order(max_order)
        frames_out.append(
            Frame(frame_type=int(ftype), frame_samples=int(n), flags=flags, channels=chans)
        )
    return frames_out


def _collect_chunk(st, C, kinds, cand_orders, max_order, compat: str = "fixed"):
    """Download one sub-batch's results and assemble its frames."""
    return _assemble_frames(_download_chunk(st, C), C, kinds, cand_orders, max_order, compat)


def encode_to_frames(
    samples: np.ndarray,
    sample_rate: int,
    channels: int,
    compression_level: int = 5,
    compat: str = "fixed",
    *,
    device="cuda",
) -> List[Frame]:
    """Encode interleaved samples into a list of container frames.

    f32 input with the default compat runs on the host (a lone file cannot
    amortise a device pass); integer input and compat="reference-bugs" take
    the bulk path with ``analysis="exact"`` on ``device``, as in the
    reference."""
    arr = np.asarray(samples)
    if compat == "fixed" and not np.issubdtype(arr.dtype, np.integer):
        return _encode_frames_host_file(arr, sample_rate, channels, compression_level)
    return encode_many_to_frames(
        [arr], sample_rate, channels, compression_level, "exact", compat, device=device
    )[0]


def _encode_frames_host_file(
    samples: np.ndarray, sample_rate: int, channels: int, compression_level: int
) -> List[Frame]:
    """Whole-file host encode: one encode_frame_host call per 1 s frame."""
    arr = np.asarray(samples, dtype=np.float32).reshape(-1)
    C = int(channels)
    spf = int(sample_rate)
    total = len(arr) // C
    return [
        encode_frame_host(arr[start * C : min(start + spf, total) * C], sample_rate, C,
                          compression_level)
        for start in range(0, total, spf)
    ]


def encode_frame_host(
    samples: np.ndarray, sample_rate: int, channels: int, compression_level: int = 5
) -> Frame:
    """Encode ONE frame's interleaved f32 samples on the host: C++ candidate
    search (native/encode.cpp) + C++ Rice pack. Raises when the native
    library cannot be built."""
    arr = np.asarray(samples, dtype=np.float32).reshape(-1)
    C = int(channels)
    n = len(arr) // C
    if n == 0:
        raise ValueError("empty frame")
    if (np.abs(arr[: n * C]) < SILENCE_THRESHOLD).all():
        return Frame(
            frame_type=int(FrameType.SILENCE),
            frame_samples=n,
            channels=[ChannelData.silence() for _ in range(C)],
        )
    ints = f32_to_i32_np(arr[: n * C]).reshape(n, C)
    ch = np.ascontiguousarray(ints.T)  # [C, n]

    mid_side = False
    if C == 2:
        l, r = ch[0], ch[1]
        var_l = np.einsum("s,s->", l, l, dtype=np.float64)
        var_r = np.einsum("s,s->", r, r, dtype=np.float64)
        side = l - r
        var_side = np.einsum("s,s->", side, side, dtype=np.float64)
        mid_side = bool(var_side < np.floor_divide(var_l + var_r, 2))
        if mid_side:
            ch = np.stack([l + r, side])

    kinds, cand_orders, max_order = _candidate_plan(compression_level)
    use_lpc = any(kd == "lpc" for kd in kinds)
    out = native.lossless_search_batch(ch, np.full(C, n, np.int64), max_order, use_lpc)
    if out is None:
        raise RuntimeError("the C++ encoder (flo_tpu/native/encode.cpp) could not be built")
    sel_kind, sel_order, ks, coeffs, shifts, sizes, residuals = out

    rice_lanes = np.flatnonzero(sel_kind != 0)
    blobs = {}
    if len(rice_lanes):
        packed = rice_host.encode_batch(
            residuals[rice_lanes], ks[rice_lanes],
            np.full(len(rice_lanes), n, np.int64),
        )
        blobs = dict(zip(rice_lanes.tolist(), packed))

    chans = []
    all_raw = True
    for c in range(C):
        kd = int(sel_kind[c])
        if kd == 0:
            chans.append(ChannelData.raw(residuals[c, :n].astype("<i2").tobytes()))
            continue
        all_raw = False
        if kd == 1:
            coeff_list, shift_bits = [], FIXED_PREDICTOR_MARKER + int(sel_order[c])
        else:
            order = int(sel_order[c])
            coeff_list, shift_bits = [int(v) for v in coeffs[c, :order]], int(shifts[c])
        chans.append(
            ChannelData(
                predictor_coeffs=coeff_list,
                shift_bits=shift_bits,
                residual_encoding=ResidualEncoding.RICE,
                rice_parameter=int(ks[c]),
                residuals=blobs[c],
            )
        )
    ftype = FrameType.RAW if all_raw else FrameType.from_order(max_order)
    return Frame(
        frame_type=int(ftype),
        frame_samples=n,
        flags=FRAME_FLAG_MID_SIDE if mid_side else 0,
        channels=chans,
    )



def encode_many_async(
    samples_list,
    sample_rate: int,
    channels: int,
    bit_depth: int = 16,
    compression_level: int = 5,
    metadata_list=None,
    analysis: str = "device",
    *,
    device="cuda",
) -> BulkFuture:
    """Bulk encode, dispatched immediately; ``result()`` yields the file bytes.

    The default ``analysis="device"`` runs the mid/side decision,
    autocorrelation and Levinson-Durbin in float32 on the device: the round
    trip stays bit-exact (coefficients and flags travel in the stream) and
    sizes stay within a few per mille of ``analysis="exact"``, which gives
    the single-file ``encode``'s bytes.
    """
    level = min(int(compression_level), 9)
    fut = encode_many_to_frames_async(
        samples_list, sample_rate, channels, level, analysis, device=device
    )
    metas = metadata_list or [b""] * len(samples_list)
    return fut.then(
        lambda frames_per_file: [
            writer.write(int(sample_rate), int(channels), int(bit_depth), level, frames, meta)
            for frames, meta in zip(frames_per_file, metas)
        ]
    )


def encode_many(
    samples_list,
    sample_rate: int,
    channels: int,
    bit_depth: int = 16,
    compression_level: int = 5,
    metadata_list=None,
    analysis: str = "device",
    *,
    device="cuda",
) -> List[bytes]:
    """Bulk encode: many files, one device pass (blocking form of
    :func:`encode_many_async`)."""
    return encode_many_async(
        samples_list, sample_rate, channels, bit_depth, compression_level, metadata_list,
        analysis, device=device,
    ).result()


def encode(
    samples: np.ndarray,
    sample_rate: int,
    channels: int,
    bit_depth: int = 16,
    compression_level: int = 5,
    metadata: bytes = b"",
    compat: str = "fixed",
    *,
    device="cuda",
) -> bytes:
    """Encode interleaved samples to flo bytes (f32 on the host; integer
    input and compat="reference-bugs" through the bulk path on ``device``)."""
    level = min(int(compression_level), 9)
    frames = encode_to_frames(samples, sample_rate, channels, level, compat, device=device)
    return writer.write(int(sample_rate), int(channels), int(bit_depth), level, frames, metadata)
