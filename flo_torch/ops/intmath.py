"""Integer helpers for the decoder.

Only the truncating halving of the mid/side undo lives here: the reference's
15-bit-limb MAC has no counterpart, because the card multiplies in 64 bits.
"""

from __future__ import annotations

import torch


def div2_trunc(x: torch.Tensor) -> torch.Tensor:
    """Truncating division by 2 (Rust i32 ``/ 2``), as the reference computes
    it: ``where(x >= 0, x >> 1, -((-x) >> 1))`` in int32.

    The negation wraps, so ``INT32_MIN`` maps to ``+2**30`` (not ``-2**30``);
    the expression is copied bit for bit, quirk included.
    """
    x = x.to(torch.int32)
    neg = (-x.to(torch.int64)).to(torch.int32)  # int32 negation, wrapping
    return torch.where(x >= 0, x >> 1, -(neg >> 1))
