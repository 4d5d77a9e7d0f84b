"""Lossless candidate search: the plain PyTorch version and the backend choice.

For every lane (one frame-channel) and every candidate predictor, in the
reference's evaluation order (raw, fixed 0..min(4, max_order), LPC
5..max_order; encoder.rs:173-217):

- the masked residuals, with the warm-up rules: LPC emits its first
  ``order`` samples verbatim (lpc.rs:283-285), fixed predictors ramp through
  ``FIXED[min(i, 4)]`` (lpc.rs:301-359);
- ``max|r|`` (wrapping at i32::MIN, as Rust's release ``.abs()``): an LPC
  candidate is out above 1_000_000 (encoder.rs:269-271) or when its
  Levinson fit failed (``cand_ok``);
- the Rice parameter ``k = clamp(max(min_k, bitlen(mean|r|)), 0, 15)``, 0
  when ``max|r| == 0`` (rice.rs:29-69, on the unsigned abs);
- the exact size ``(sum min(u >> k, 255) + n * (1 + k) + 7) >> 3`` bytes;

and a candidate wins only with a size strictly below the best so far (raw
counts ``2n``). Every statistic is exact, in int64: the reference steers
this choice with float32 approximations (``flo_tpu/ops/select.py:97-163``),
the port does not, so it picks what the C++ host search
(``native/encode.cpp``) picks, and its winner can never be worse than raw
(the reference's demote-to-raw step cannot fire; ``lossless/encoder.py``
asserts it).

On a CUDA tensor :func:`encode_select_best` launches the hand-written kernel
(``ops/cuda_select.py``, ``csrc/lossless_select.cu``); on a CPU tensor it runs
:func:`encode_select_step`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import lpc
from .intmath import predict_shift_taps

#: LPC candidates with a residual larger than this are unstable
#: (encoder.rs:269-271).
MAX_STABLE_RESIDUAL = 1_000_000


def residuals_one(lanes, nvalid, coeffs, shifts, orders, is_fixed) -> torch.Tensor:
    """Masked residuals [L, S] int32 for one candidate per lane.

    lanes [L, S] int32; nvalid, shifts, orders [L]; coeffs [L, 12] int32;
    is_fixed [L] bool. The main region uses the stored coefficients; the
    <= 12-sample warm-up prefix is fixed up: LPC emits samples verbatim, fixed
    predictors ramp through FIXED[min(i, 4)]. Zero past ``nvalid``.
    """
    L, S = lanes.shape
    dev = lanes.device
    pred = predict_shift_taps(lanes, coeffs, shifts[:, None])
    r = (lanes.to(torch.int64) - pred).to(torch.int32)  # int32 wrap

    P = min(lpc.MAX_ORDER, S)
    prefix = lanes[:, :P].to(torch.int64)
    lag_pref = torch.stack(
        [F.pad(prefix, (j + 1, 0))[:, :P] for j in range(lpc.MAX_ORDER)], dim=-1
    )  # [L, P, 12]: lag_pref[l, i, j] = s[i-1-j]
    i_idx = torch.arange(P, device=dev)
    ramp_rows = torch.from_numpy(lpc._FIXED_COEFFS).to(dev, torch.int64)[i_idx.clamp(max=4)]
    pred_ramp = (ramp_rows[None] * lag_pref).sum(-1)
    in_warmup = i_idx[None, :] < orders[:, None]
    r_pref = torch.where(
        in_warmup,
        torch.where(is_fixed[:, None], (prefix - pred_ramp).to(torch.int32), lanes[:, :P]),
        r[:, :P],
    )
    r = torch.cat([r_pref, r[:, P:]], dim=1)
    valid = torch.arange(S, device=dev)[None, :] < nvalid[:, None]
    return torch.where(valid, r, 0)


def bit_length(x: torch.Tensor) -> torch.Tensor:
    """Exact bit length of non-negative int64 values below 2**53 (frexp of the
    exactly converted float64)."""
    return torch.frexp(x.to(torch.float64)).exponent.to(torch.int64)


def rice_k_exact(max_uabs, sum_abs, nvalid) -> torch.Tensor:
    """rice.rs:29-69: k = clamp(max(min_k, bitlen(mean|r|)), 0, 15), 0 when
    every residual is 0. ``max_uabs`` and ``sum_abs`` are the int64 max and
    sum of the unsigned abs (i32::MIN counts 2**31); min_k keeps every
    quotient <= 255. Returns int64 [L]."""
    n = nvalid.to(torch.int64).clamp(min=1)
    max_u2 = 2 * max_uabs
    min_k = torch.where(max_u2 > 255, (bit_length(max_u2) - 8).clamp(min=0), 0)
    mean_k = bit_length(sum_abs // n)
    k = torch.maximum(min_k, mean_k).clamp(0, 15)
    return torch.where(max_uabs == 0, 0, k)


def zigzag_u32(r: torch.Tensor) -> torch.Tensor:
    """rice_host.zigzag on int32 residuals, as int64 values in [0, 2**32)."""
    r = r.to(torch.int64)
    return ((r << 1) ^ (r >> 31)) & 0xFFFFFFFF


def candidate_size(r, nvalid):
    """(max_abs, k, size_bytes) of one candidate's masked residuals [L, S]
    int32: max_abs int32 wraps at i32::MIN like Rust's ``.abs()`` (the
    stability test reads it); k and the exact byte size at k are int64."""
    max_abs = r.abs().amax(1) if r.shape[1] else torch.zeros_like(nvalid, dtype=torch.int32)
    a = r.to(torch.int64).abs()
    max_uabs = a.amax(1) if r.shape[1] else torch.zeros_like(nvalid, dtype=torch.int64)
    k = rice_k_exact(max_uabs, a.sum(1), nvalid)
    q = (zigzag_u32(r) >> k[:, None]).clamp(max=255)
    bits = q.sum(1) + nvalid.to(torch.int64) * (1 + k)
    return max_abs, k, (bits + 7) >> 3


def encode_select_step(
    lanes, nvalid, coeffs_all, shifts_all, orders_all, fixed_all, cand_ok, is_lpc: tuple
):
    """Plain full candidate search, with the reference's signature.

    lanes [L, S] int32; nvalid [L] int32; candidate tables coeffs_all
    [L, NC, 12] int32, shifts_all / orders_all [L, NC] int32, fixed_all /
    cand_ok [L, NC] bool; is_lpc: NC flags. Candidate 0 is the raw baseline
    (size 2 * nvalid; its table rows are not read).

    Returns (sel [L], k [L], size_bytes [L], residuals [L, S] of the winner
    (raw winners: the verbatim samples, zero past nvalid), win_coeffs
    [L, 12], win_shift [L]), all int32.
    """
    L, S = lanes.shape
    dev = lanes.device
    nvalid64 = nvalid.to(torch.int64)
    valid = torch.arange(S, device=dev)[None, :] < nvalid[:, None]
    best_size = 2 * nvalid64
    best_ci = torch.zeros(L, dtype=torch.int64, device=dev)
    best_k = torch.zeros(L, dtype=torch.int64, device=dev)
    best_r = torch.where(valid, lanes, 0)
    for ci in range(1, coeffs_all.shape[1]):
        r = residuals_one(
            lanes, nvalid, coeffs_all[:, ci], shifts_all[:, ci], orders_all[:, ci],
            fixed_all[:, ci],
        )
        max_abs, k, size = candidate_size(r, nvalid)
        ok = cand_ok[:, ci]
        if is_lpc[ci]:
            ok = ok & (max_abs <= MAX_STABLE_RESIDUAL)
        better = ok & (size < best_size)
        best_size = torch.where(better, size, best_size)
        best_ci = torch.where(better, ci, best_ci)
        best_k = torch.where(better, k, best_k)
        best_r = torch.where(better[:, None], r, best_r)

    rows = torch.arange(L, device=dev)
    return (
        best_ci.to(torch.int32),
        best_k.to(torch.int32),
        best_size.to(torch.int32),
        best_r,
        coeffs_all[rows, best_ci],
        shifts_all[rows, best_ci],
    )


def encode_select_best(
    lanes, nvalid, coeffs_all, shifts_all, orders_all, fixed_all, cand_ok, is_lpc: tuple
):
    """:func:`encode_select_step` for CPU tensors; the hand-written CUDA
    kernel (``ops/cuda_select.py``) for anything else, which launches or
    raises."""
    if lanes.device.type == "cpu":
        return encode_select_step(
            lanes, nvalid, coeffs_all, shifts_all, orders_all, fixed_all, cand_ok, is_lpc
        )
    from .cuda_select import encode_select_cuda

    return encode_select_cuda(
        lanes, nvalid, coeffs_all, shifts_all, orders_all, fixed_all, cand_ok, is_lpc
    )


def _lanes_from_pcm16(pcm16, mid_side) -> torch.Tensor:
    """[F, C, S] int16 PCM + per-frame mid/side flags [F] -> [F*C, S] int32
    lanes (mid = l + r, side = l - r, exact in int32)."""
    Fr, C, S = pcm16.shape
    p = pcm16.to(torch.int32)
    if C == 2:
        ms = torch.stack([p[:, 0] + p[:, 1], p[:, 0] - p[:, 1]], dim=1)
        p = torch.where(mid_side[:, None, None], ms, p)
    return p.reshape(Fr * C, S)


def candidate_tables(nvalid, kinds: tuple, cand_orders: tuple, lpc_fit=None):
    """Per-lane candidate tables on nvalid's device: (coeffs_all [L, NC, 12]
    int32, shifts_all, orders_all [L, NC] int32, fixed_all, cand_ok [L, NC]
    bool), for the candidate plan ``kinds`` / ``cand_orders``. ``lpc_fit``
    is (coeffs [L, max_order, 12], shifts [L, max_order], valid [L,
    max_order]) from a Levinson recursion; the LPC candidate of order o
    reads row o - 1 and needs ``nvalid > o``."""
    L = nvalid.shape[0]
    NC = len(kinds)
    dev = nvalid.device
    coeffs_all = torch.zeros((L, NC, lpc.MAX_ORDER), dtype=torch.int32, device=dev)
    shifts_all = torch.zeros((L, NC), dtype=torch.int32, device=dev)
    orders_all = torch.zeros((L, NC), dtype=torch.int32, device=dev)
    fixed_all = torch.zeros((L, NC), dtype=torch.bool, device=dev)
    cand_ok = torch.ones((L, NC), dtype=torch.bool, device=dev)
    fixed_table = torch.from_numpy(lpc._FIXED_COEFFS).to(dev)
    for ci, (kd, o) in enumerate(zip(kinds, cand_orders)):
        if kd == "fixed":
            coeffs_all[:, ci] = fixed_table[o]
            orders_all[:, ci] = o
            fixed_all[:, ci] = True
        elif kd == "lpc":
            lc, ls, lv = lpc_fit
            coeffs_all[:, ci] = lc[:, o - 1]
            shifts_all[:, ci] = ls[:, o - 1].to(torch.int32)
            orders_all[:, ci] = o
            cand_ok[:, ci] = lv[:, o - 1] & (nvalid > o)
    return coeffs_all, shifts_all, orders_all, fixed_all, cand_ok


def device_analysis(p, nvalid_f, kinds: tuple, cand_orders: tuple):
    """``analysis="device"``: the mid/side decision, autocorrelation and
    Levinson-Durbin in float32 on the PCM's device.

    p: [F, C, S] int32 (or int16) PCM; nvalid_f [F]. Returns (lanes [F*C, S]
    int32, nvalid [F*C] int32, the five candidate tables, mid_side [F]
    bool). Float32 sums may pick other coefficients or mid/side flags than
    the exact host analysis; both travel in the stream, so the round trip
    stays exact and only the size can drift.
    """
    Fr, C, S = p.shape
    p = p.to(torch.int32)
    if C == 2:
        l, r = p[:, 0].to(torch.float32), p[:, 1].to(torch.float32)
        side = l - r
        mid_side = (side * side).sum(1) < ((l * l).sum(1) + (r * r).sum(1)) * 0.5
    else:
        mid_side = torch.zeros(Fr, dtype=torch.bool, device=p.device)
    lanes = _lanes_from_pcm16(p, mid_side)
    nvalid = nvalid_f.to(torch.int32).repeat_interleave(C)
    max_order = max((o for kd, o in zip(kinds, cand_orders) if kd == "lpc"), default=0)
    fit = None
    if max_order > 0:
        fit = lpc.levinson_device(lpc.autocorrelation_device(lanes, nvalid, max_order), max_order)
    tables = candidate_tables(nvalid, kinds, cand_orders, fit)
    return lanes, nvalid, tables, mid_side


def _select_device_core(p, nvalid_f, kinds: tuple, cand_orders: tuple):
    """[F, C, S] PCM -> the search's six outputs + mid_side [F], with the
    whole analysis on the device (:func:`device_analysis`)."""
    lanes, nvalid, tables, mid_side = device_analysis(p, nvalid_f, kinds, cand_orders)
    is_lpc = tuple(kd == "lpc" for kd in kinds)
    return encode_select_best(lanes, nvalid, *tables, is_lpc) + (mid_side,)
