"""Lossless decoder: C++ Rice parse on the host, reconstruction on the device.

Pipeline (the reference's ``lossless/decoder.py``, without its TPU wire
transport):

1. Classify every (frame, channel) into a *lane* with uniform parameters
   (residual row, 12 coefficient taps, shift, warm-up order, fixed flag), so
   one program handles LPC, fixed, raw and silent lanes alike. The
   container's Rice streams are parsed by the C++ batch decoder.
2. The lane tables go to the device as tensors (:func:`lanes_to_device`);
   one reconstruction per channel group (the CUDA kernel on the card),
   then the mid/side undo and the x1/32767 scale.
3. The host trims each frame's padded tail and interleaves the channels.
"""

from __future__ import annotations

import numpy as np
import torch

from .._flo_host.container import reader
from .._flo_host.core import rice_host
from .._flo_host.core.constants import FIXED_PREDICTOR_MARKER, FrameType
from .._flo_host.core.types import FloFile
from .._flo_host.futures import BulkFuture
from ..core.convert import i32_to_f32
from ..ops import lpc
from ..ops.intmath import div2_trunc


def _marshal_lanes(flo: FloFile):
    """Build per-lane arrays from a parsed file.

    Returns (residual_rows [L,S], coeffs [L,12], shifts [L], orders [L],
    is_fixed [L], mid_side [F] bool, S, frame_lengths [F]), or None when the
    file has no lossless frame. Lane order is frame-major, channel-minor.
    """
    channels = flo.header.channels
    frames = [f for f in flo.frames if not FrameType.from_byte(f.frame_type).is_transform]
    F = len(frames)
    if F == 0:
        return None
    S = max(f.frame_samples for f in frames)
    L = F * channels

    rows = np.zeros((L, S), dtype=np.int32)
    coeffs = np.zeros((L, lpc.MAX_ORDER), dtype=np.int32)
    shifts = np.zeros(L, dtype=np.int32)
    orders = np.zeros(L, dtype=np.int32)
    is_fixed = np.zeros(L, dtype=bool)
    mid_side = np.zeros(F, dtype=bool)
    frame_lengths = np.zeros(F, dtype=np.int64)

    # Rice streams are decoded afterwards, as one batch.
    rice_jobs = []  # (lane, blob, k, n)

    for fi, frame in enumerate(frames):
        n = frame.frame_samples
        frame_lengths[fi] = n
        mid_side[fi] = channels == 2 and bool(frame.flags & 0x01)
        for ci in range(channels):
            lane = fi * channels + ci
            ch = frame.channels[ci] if ci < len(frame.channels) else None
            if ch is None:
                continue
            has_coeffs = len(ch.predictor_coeffs) > 0
            has_residuals = len(ch.residuals) > 0
            # Same classification order as the reference decoder.
            if not has_coeffs and has_residuals and ch.shift_bits >= FIXED_PREDICTOR_MARKER:
                order = ch.shift_bits - FIXED_PREDICTOR_MARKER
                rice_jobs.append((lane, ch.residuals, ch.rice_parameter, n))
                if order <= 4:
                    is_fixed[lane] = True
                    orders[lane] = order
                    coeffs[lane, :] = lpc._FIXED_COEFFS[order]
                # order > 4: unknown fixed order -> samples = residuals
                # verbatim: zero coeffs, order 0 already set.
            elif has_coeffs:
                order = len(ch.predictor_coeffs)
                rice_jobs.append((lane, ch.residuals, ch.rice_parameter, n))
                coeffs[lane, :order] = np.asarray(ch.predictor_coeffs, dtype=np.int64).astype(
                    np.int32
                )
                shifts[lane] = min(int(ch.shift_bits), 15)
                orders[lane] = order
            elif has_residuals:
                # Raw i16 PCM; whole i16 pairs only.
                raw = np.frombuffer(
                    ch.residuals[: (len(ch.residuals) // 2) * 2], dtype="<i2"
                ).astype(np.int32)
                m = min(len(raw), n)
                rows[lane, :m] = raw[:m]
            # else: silence -> zeros already.

    if rice_jobs:
        job_lanes = np.array([j[0] for j in rice_jobs])
        job_ks = np.array([j[2] for j in rice_jobs], dtype=np.int32)
        job_ns = np.array([j[3] for j in rice_jobs], dtype=np.int64)
        rows[job_lanes] = rice_host.decode_batch([j[1] for j in rice_jobs], job_ks, job_ns, S)

    return rows, coeffs, shifts, orders, is_fixed, mid_side, S, frame_lengths


def lanes_to_device(rows, coeffs, shifts, orders, is_fixed, mid_side, *, device="cuda"):
    """The decode's parameters as tensors on ``device``: flo has no weights,
    the marshalled lane tables are the whole state of a decode.

    Takes the numpy arrays of :func:`_marshal_lanes` (rows [L,S] i32, coeffs
    [L,12] i32, shifts/orders [L] i32, is_fixed [L] bool, mid_side [F] bool)
    and returns them as tensors in the same order.
    """
    arrays = (
        (rows, np.int32), (coeffs, np.int32), (shifts, np.int32), (orders, np.int32),
        (is_fixed, np.bool_), (mid_side, np.bool_),
    )
    return tuple(
        torch.from_numpy(np.ascontiguousarray(a, dtype=dt)).to(device) for a, dt in arrays
    )


def _device_decode(rows, coeffs, shifts, orders, is_fixed, mid_side, channels: int):
    """Reconstruct + mid/side undo + f32 conversion, on the tensors' device.

    rows: [F*C, S] -> returns [F, S, C] float32 (interleave-ready).
    """
    samples = lpc.reconstruct_best(rows, coeffs, shifts, orders, is_fixed)
    S = samples.shape[1]
    fcs = samples.reshape(-1, channels, S)
    if channels == 2:
        m, s = fcs[:, 0].to(torch.int64), fcs[:, 1].to(torch.int64)
        left = div2_trunc((m + s).to(torch.int32))  # int32-wrapping sums, as
        right = div2_trunc((m - s).to(torch.int32))  # the reference computes them
        ms = mid_side[:, None]
        fcs = torch.stack(
            [torch.where(ms, left, fcs[:, 0]), torch.where(ms, right, fcs[:, 1])], dim=1
        )
    return i32_to_f32(fcs).permute(0, 2, 1).contiguous()


def _concat_group(group):
    """One channel group's marshalled files as one lane batch (files
    concatenate along lanes, rows zero-padded to the group's longest frame)."""
    S_max = max(m[6] for _, m in group)
    L_tot = sum(m[0].shape[0] for _, m in group)
    rows = np.zeros((L_tot, S_max), dtype=np.int32)
    off = 0
    for _, m in group:
        r = m[0]
        rows[off : off + r.shape[0], : r.shape[1]] = r
        off += r.shape[0]
    coeffs, shifts, orders, is_fixed, mid_side = (
        np.concatenate([m[k] for _, m in group]) for k in (1, 2, 3, 4, 5)
    )
    return rows, coeffs, shifts, orders, is_fixed, mid_side


def decode_many_async(flos: list[FloFile], *, device="cuda") -> BulkFuture:
    """Bulk decode: every file's lanes in one device reconstruction per
    channel count. The device work is dispatched before this returns; the
    future's ``result()`` copies the samples back and trims and interleaves
    them on the host, giving one flat interleaved float32 array per file."""
    outs: list[np.ndarray] = [np.zeros(0, dtype=np.float32)] * len(flos)
    by_channels: dict[int, list] = {}
    for i, f in enumerate(flos):
        m = _marshal_lanes(f)
        if m is not None:
            by_channels.setdefault(f.header.channels, []).append((i, m))

    pending = []
    for channels, group in by_channels.items():
        lanes = lanes_to_device(*_concat_group(group), device=device)
        pending.append((group, _device_decode(*lanes, channels=channels)))

    def collect():
        for group, fsc in pending:
            host = fsc.cpu().numpy()  # [F, S, C]
            f0 = 0
            for i, m in group:
                frame_lengths = m[7]
                outs[i] = np.concatenate(
                    [host[f0 + k, :n].reshape(-1) for k, n in enumerate(frame_lengths)]
                )
                f0 += len(frame_lengths)
        return outs

    return BulkFuture(collect)


def decode_many(flos: list[FloFile], *, device="cuda") -> list[np.ndarray]:
    """Blocking form of :func:`decode_many_async`."""
    return decode_many_async(flos, device=device).result()


def decode_file(flo: FloFile, *, device="cuda") -> np.ndarray:
    """Decode a parsed lossless file to interleaved float32 samples."""
    return decode_many([flo], device=device)[0]


def decode(data: bytes, *, device="cuda") -> np.ndarray:
    """Decode flo bytes to interleaved float32 samples (lossless path)."""
    return decode_file(reader.read(data), device=device)


def _undo_midside_host(fcs: np.ndarray, mid_side: np.ndarray, channels: int) -> np.ndarray:
    """Mid/side -> L/R on [F, C, S] int32 frames, with Rust's truncating
    ``/ 2`` on the int64 sums."""
    if channels != 2:
        return fcs
    m, s = fcs[:, 0].astype(np.int64), fcs[:, 1].astype(np.int64)

    def trunc_div2(t):
        return t // 2 + ((t < 0) & (t % 2 != 0))

    left = np.where(mid_side[:, None], trunc_div2(m + s), m)
    right = np.where(mid_side[:, None], trunc_div2(m - s), s)
    return np.stack([left.astype(np.int32), right.astype(np.int32)], axis=1)


def decode_file_i32(flo: FloFile, *, device="cuda") -> np.ndarray:
    """Integer-domain decode: [total_samples, channels] int32, true L/R
    (mid/side undone). Used by bit-exactness tests."""
    channels = flo.header.channels
    marshaled = _marshal_lanes(flo)
    if marshaled is None:
        return np.zeros((0, channels), dtype=np.int32)
    rows, coeffs, shifts, orders, is_fixed, mid_side, S, frame_lengths = marshaled
    lanes = lanes_to_device(rows, coeffs, shifts, orders, is_fixed, mid_side, device=device)
    samples = lpc.reconstruct_best(*lanes[:5]).cpu().numpy()
    fcs = _undo_midside_host(samples.reshape(-1, channels, S), mid_side, channels)
    parts = [fcs[i, :, : frame_lengths[i]].T for i in range(fcs.shape[0])]
    return np.concatenate(parts, axis=0)
