"""LPC reconstruction: the plain PyTorch recurrence and the backend choice.

The unit of work is a batch of lanes (one lane = one frame-channel). The
recurrence is sequential in time and independent across lanes:

    s[i] = wrap32(r[i] + ((sum_j c_eff[j] * s[i-1-j]) >> shift))

with the warm-up of the reference decoder: while ``i < order`` a fixed lane
uses the ramped predictor ``FIXED[min(i, 4)]`` and an LPC lane uses zero
coefficients. Raw and silent lanes carry zero coefficients (identity).

The MAC runs in int64. Twelve int32 x int32 products can overflow it, but the
sum wraps modulo 2**64 and only bits 0..46 of it reach the int32 output
(``shift <= 15``), so the wrapped sum gives the exact result.
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
