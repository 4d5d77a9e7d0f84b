"""LPC: the decoder's reconstruction recurrence and the encoder's analysis.

Reconstruction: the plain PyTorch recurrence and the backend choice.

The unit of work is a batch of lanes (one lane = one frame-channel). The
recurrence is sequential in time and independent across lanes:

    s[i] = wrap32(r[i] + ((sum_j c_eff[j] * s[i-1-j]) >> shift))

with the warm-up of the reference decoder: while ``i < order`` a fixed lane
uses the ramped predictor ``FIXED[min(i, 4)]`` and an LPC lane uses zero
coefficients. Raw and silent lanes carry zero coefficients (identity).

The MAC runs in int64. Twelve int32 x int32 products can overflow it, but the
sum wraps modulo 2**64 and only bits 0..46 of it reach the int32 output
(``shift <= 15``), so the wrapped sum gives the exact result.

Analysis, for the encoder's LPC candidates: the on-device float32
autocorrelation and Levinson-Durbin of ``analysis="device"``, and the host
float64 Levinson-Durbin of ``analysis="exact"`` (a copy of the reference's
numpy function: its module imports JAX, so it cannot be loaded by alias).
"""

from __future__ import annotations

import numpy as np
import torch

MAX_ORDER = 12

#: Binomial difference-filter coefficients for fixed predictors 0..4, padded
#: to MAX_ORDER taps; tap j multiplies sample i-1-j.
_FIXED_COEFFS = np.zeros((5, MAX_ORDER), dtype=np.int32)
_FIXED_COEFFS[1, :1] = [1]
_FIXED_COEFFS[2, :2] = [2, -1]
_FIXED_COEFFS[3, :3] = [3, -3, 1]
_FIXED_COEFFS[4, :4] = [4, -6, 4, -1]


def reconstruct(residuals, coeffs, shifts, orders, is_fixed) -> torch.Tensor:
    """Plain PyTorch reconstruction: a loop over samples, vectorised over
    lanes, on whatever device the inputs lie on.

    Args:
      residuals: [L, S] int32 (zero-padded beyond each lane's true length).
      coeffs:    [L, MAX_ORDER] int32; coeffs[:, j] multiplies sample i-1-j.
      shifts:    [L] int32 in [0, 15].
      orders:    [L] int32, the warm-up length.
      is_fixed:  [L] bool, the lane uses a fixed predictor (ramped warm-up).

    Returns: [L, S] int32 reconstructed samples.
    """
    L, S = residuals.shape
    dev = residuals.device
    if L == 0 or S == 0:
        return torch.zeros((L, S), dtype=torch.int32, device=dev)
    # Time-major history: hist[MAX_ORDER + i] = s[i], so rows i..i+11 hold
    # s[i-12..i-1] and tap j (lag 1+j) meets row MAX_ORDER-1-j: the taps are
    # flipped once up front.
    res_t = residuals.t().to(torch.int64)
    taps = coeffs.t().to(torch.int64).flip(0)  # [MAX_ORDER, L]
    ramp = torch.from_numpy(_FIXED_COEFFS).to(dev, torch.int64).flip(1)
    sh = shifts.to(torch.int64)
    hist = torch.zeros((MAX_ORDER + S, L), dtype=torch.int64, device=dev)
    warm = min(int(orders.max()), S)
    for i in range(S):
        c = taps
        if i < warm:
            c_ramp = torch.where(is_fixed[None, :], ramp[min(i, 4)][:, None], 0)
            c = torch.where((i < orders)[None, :], c_ramp, taps)
        pred = (c * hist[i : i + MAX_ORDER]).sum(0) >> sh
        hist[MAX_ORDER + i] = (pred + res_t[i]).to(torch.int32)  # int32 wrap
    return hist[MAX_ORDER:].t().to(torch.int32)


def reconstruct_best(residuals, coeffs, shifts, orders, is_fixed) -> torch.Tensor:
    """Plain version for CPU tensors; the hand-written CUDA kernel
    (``ops/cuda_lpc.py``) for anything else, which launches or raises."""
    if residuals.device.type == "cpu":
        return reconstruct(residuals, coeffs, shifts, orders, is_fixed)
    from .cuda_lpc import reconstruct_cuda

    return reconstruct_cuda(residuals, coeffs, shifts, orders, is_fixed)


def autocorrelation_device(lanes: torch.Tensor, nvalid: torch.Tensor, max_order: int):
    """Autocorrelation lags 0..max_order in float32, on the lanes' device.

    The int32 -> float32 cast is exact for the codec's sample domain
    (|s| < 2**17); the float32 dot products are approximate, which only moves
    the coefficients the Levinson recursion proposes (they travel in the
    stream, so the round trip stays exact). lanes [L, S] int32, nvalid [L]
    -> [L, max_order + 1] float32.
    """
    S = lanes.shape[1]
    mask = torch.arange(S, device=lanes.device)[None, :] < nvalid[:, None]
    x = torch.where(mask, lanes, 0).to(torch.float32)
    cols = [(x * x).sum(1)]
    for lag in range(1, max_order + 1):
        cols.append((x[:, lag:] * x[:, : S - lag]).sum(1))
    return torch.stack(cols, dim=1)


def levinson_device(ac: torch.Tensor, max_order: int):
    """Levinson-Durbin for every order 1..max_order in float32, vectorised over
    lanes: the float32 counterpart of :func:`levinson_durbin_all_orders`, with
    the same instability rejection and fixed-point quantization.

    ac: [L, max_order + 1] float32. Returns (coeffs_fp [L, max_order,
    MAX_ORDER] int32, shifts [L, max_order] int32, valid [L, max_order] bool).
    """
    L = ac.shape[0]
    dev = ac.device
    j_idx = torch.arange(MAX_ORDER, device=dev)
    coeffs = torch.zeros((L, MAX_ORDER), dtype=torch.float32, device=dev)
    error = ac[:, 0].clone()
    alive = ac[:, 0] != 0.0
    qs, shifts, valid = [], [], []
    for i in range(max_order):
        # lam = ac[i+1] - sum_{j<i} coeffs[j] * ac[i-j]
        gather = ac[:, (i - j_idx).clamp(0, ac.shape[1] - 1)]
        lam = ac[:, i + 1] - torch.where(j_idx[None, :] < i, coeffs * gather, 0.0).sum(1)
        alive = alive & ~(error.abs() < 1e-10)
        gamma = torch.where(alive, lam / torch.where(error == 0, 1.0, error), 0.0)
        alive = alive & (gamma.abs() < 1.0)
        # new[j] = coeffs[j] - gamma * coeffs[i-1-j] for j < i; new[i] = gamma
        rev = coeffs[:, (i - 1 - j_idx).clamp(0, MAX_ORDER - 1)]
        new = torch.where(
            j_idx[None, :] < i,
            coeffs - gamma[:, None] * rev,
            torch.where(j_idx[None, :] == i, gamma[:, None], coeffs),
        )
        coeffs = torch.where(alive[:, None], new, coeffs)
        error = error * (1.0 - gamma * gamma)

        # Quantize the order-(i+1) snapshot: shift = clip(floor(log2(2**30 /
        # max|c|)), 0, 15), round half away from zero, saturate to int32.
        c_now = torch.where(j_idx[None, :] <= i, coeffs, 0.0)
        max_c = c_now.abs().amax(1)
        ok = alive & (max_c > 0) & torch.isfinite(max_c)
        shift = torch.floor(torch.log2(2.0**30 / torch.where(ok, max_c, 1.0)))
        shift = shift.clamp(0, 15).to(torch.int32)
        scaled = c_now * torch.exp2(shift.to(torch.float32))[:, None]
        q = torch.sign(scaled) * torch.floor(scaled.abs() + 0.5)
        q = q.to(torch.int64).clamp(-(2**31), 2**31 - 1).to(torch.int32)
        qs.append(torch.where(ok[:, None], q, 0))
        shifts.append(shift)
        valid.append(ok)
    if not qs:
        return (
            torch.zeros((L, 0, MAX_ORDER), dtype=torch.int32, device=dev),
            torch.zeros((L, 0), dtype=torch.int32, device=dev),
            torch.zeros((L, 0), dtype=torch.bool, device=dev),
        )
    return torch.stack(qs, 1), torch.stack(shifts, 1), torch.stack(valid, 1)


def levinson_durbin_all_orders(autocorr: np.ndarray, max_order: int):
    """Vectorized (host, float64) Levinson-Durbin producing coefficients for
    *every* order 1..max_order in one recursion.

    Mirrors the numerical behavior of levinson_durbin_int (lpc.rs:225-276):
    float64 recursion on autocorrelation, instability rejection when
    |gamma| >= 1 or the error vanishes, then fixed-point quantization with
    shift = min(floor(log2(2^30 / max|c|)), 15).

    Args:
      autocorr: [L, max_order+1] float64.
      max_order: highest order to produce.

    Returns:
      coeffs_fp: [L, max_order, MAX_ORDER] int32 quantized coefficients where
                 coeffs_fp[:, o-1] is the order-o predictor (zero-padded).
      shifts:    [L, max_order] uint8.
      valid:     [L, max_order] bool — False where the recursion bailed
                 (matching the reference returning None).
    """
    ac = np.asarray(autocorr, dtype=np.float64)
    L = ac.shape[0]
    coeffs = np.zeros((L, max_order), dtype=np.float64)
    out_c = np.zeros((L, max_order, MAX_ORDER), dtype=np.int32)
    out_shift = np.zeros((L, max_order), dtype=np.uint8)
    valid = np.zeros((L, max_order), dtype=bool)

    error = ac[:, 0].copy()
    alive = ac[:, 0] != 0.0

    for i in range(max_order):
        lam = ac[:, i + 1].copy()
        for j in range(i):
            lam -= coeffs[:, j] * ac[:, i - j]
        dead = np.abs(error) < 1e-10
        alive = alive & ~dead
        with np.errstate(divide="ignore", invalid="ignore"):
            gamma = np.where(alive, lam / np.where(error == 0, 1.0, error), 0.0)
        alive = alive & (np.abs(gamma) < 1.0)

        new = coeffs.copy()
        new[:, i] = gamma
        for j in range(i):
            new[:, j] = coeffs[:, j] - gamma * coeffs[:, i - 1 - j]
        coeffs = np.where(alive[:, None], new, coeffs)
        error = error * (1.0 - gamma * gamma)

        order = i + 1
        c_now = coeffs[:, :order]
        max_c = np.abs(c_now).max(axis=1)
        ok = alive & (max_c > 0) & np.isfinite(max_c)
        with np.errstate(divide="ignore", invalid="ignore"):
            shift = np.floor(np.log2((1 << 30) / np.where(ok, max_c, 1.0)))
        # Rust: `... as u8` saturates (negative -> 0, huge -> 255), then min(15).
        shift_u8 = np.clip(shift, 0, 15).astype(np.uint8)
        scale = np.ldexp(1.0, shift_u8.astype(np.int64))
        # Rust f64::round = half away from zero; `as i32` saturates.
        scaled = c_now * scale[:, None]
        q = np.sign(scaled) * np.floor(np.abs(scaled) + 0.5)
        q = np.clip(q, -(2**31), 2**31 - 1)
        out_c[:, i, :order] = np.where(ok[:, None], q, 0).astype(np.int64).astype(np.int32)
        out_shift[:, i] = np.where(ok, shift_u8, 0)
        valid[:, i] = ok

    return out_c, out_shift, valid
