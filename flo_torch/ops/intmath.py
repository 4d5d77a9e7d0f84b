"""Integer helpers: the encoder's causal prediction and the decoder's halving.

The reference computes both with 15-bit limbs in int32 because the TPU has no
64-bit multiply; the card has one, so the MAC here runs in int64 and the limb
machinery has no counterpart.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def predict_shift_taps(samples: torch.Tensor, coeffs: torch.Tensor, shifts) -> torch.Tensor:
    """Exact ``pred[..., i] = (sum_j coeffs[..., j] * samples[..., i-1-j]) >> shift``
    with zero-padded lags, wrapped to int32.

    samples: [..., S] integer; coeffs: [..., T] integer; shifts: an int or a
    tensor broadcastable to [..., S] (e.g. [L, 1]). The MAC is int64: twelve
    products of an int32 coefficient and a sample of the codec's domain
    (|s| < 2**25) stay far inside it, and an arithmetic right shift of the
    exact sum followed by the int32 wrap is the reference's
    ``(prediction >> shift) as i32``.
    """
    s = samples.to(torch.int64)
    S = s.shape[-1]
    c = coeffs.to(torch.int64)
    acc = torch.zeros_like(s)
    for j in range(c.shape[-1]):
        acc += c[..., j : j + 1] * F.pad(s, (j + 1, 0))[..., :S]
    if isinstance(shifts, torch.Tensor):
        shifts = shifts.to(torch.int64)
    return (acc >> shifts).to(torch.int32)  # int32 wrap


def div2_trunc(x: torch.Tensor) -> torch.Tensor:
    """Truncating division by 2 (Rust i32 ``/ 2``), as the reference computes
    it: ``where(x >= 0, x >> 1, -((-x) >> 1))`` in int32.

    The negation wraps, so ``INT32_MIN`` maps to ``+2**30`` (not ``-2**30``);
    the expression is copied bit for bit, quirk included.
    """
    x = x.to(torch.int32)
    neg = (-x.to(torch.int64)).to(torch.int32)  # int32 negation, wrapping
    return torch.where(x >= 0, x >> 1, -(neg >> 1))
