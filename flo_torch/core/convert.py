"""Sample-domain conversions (f32 <-> integer) on tensors.

Same numerical contract as the reference's ``core/convert.py``:

  f32_to_i32(s) = clamp(s * 32767, -32768, 32767) truncated toward zero
  i32_to_f32(s) = s * float32(1 / 32767)
"""

from __future__ import annotations

import torch

from .._flo_host.core.constants import I16_MAX_F32, I16_MIN_F32


def f32_to_i32(samples: torch.Tensor) -> torch.Tensor:
    x = samples.to(torch.float32) * I16_MAX_F32
    return torch.clamp(x, I16_MIN_F32, I16_MAX_F32).trunc().to(torch.int32)


def i32_to_f32(samples: torch.Tensor) -> torch.Tensor:
    scale = torch.tensor(1.0 / I16_MAX_F32, dtype=torch.float32, device=samples.device)
    return samples.to(torch.float32) * scale
