"""Wrapper of the hand-written CUDA LPC reconstruction kernel.

The counterpart of the reference's ``ops/pallas_lpc.py``: the kernel is
``csrc/lpc_reconstruct.cu`` (one thread per lane, time-major residuals, the
12-sample history in registers), built at first use by ``ops/_build.py`` and
called through ctypes on PyTorch's current stream. Its plain version is
``ops/lpc.reconstruct``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ._build import check_tensor
from .lpc import MAX_ORDER

#: Kernel launches made by :func:`reconstruct_cuda` in this process.
LAUNCHES = 0


def _kernel():
    lib = _build.load("lpc_reconstruct")
    fn = lib.flo_lpc_reconstruct
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def reconstruct_cuda(residuals, coeffs, shifts, orders, is_fixed) -> torch.Tensor:
    """Drop-in equivalent of ``ops/lpc.reconstruct`` on the CUDA kernel.

    residuals [L, S] int32, coeffs [L, 12] int32, shifts/orders [L] int32
    (shifts in [0, 15]), is_fixed [L] bool, all contiguous on one CUDA
    device -> [L, S] int32. Raises on anything else, and when the kernel
    does not build or launch.
    """
    global LAUNCHES
    dev = residuals.device
    if dev.type != "cuda":
        raise ValueError(f"reconstruct_cuda needs CUDA tensors, got {dev}")
    if residuals.dim() != 2:
        raise ValueError(f"residuals must be [L, S], got shape {tuple(residuals.shape)}")
    L, S = residuals.shape
    check_tensor("residuals", residuals, torch.int32, (L, S), dev)
    check_tensor("coeffs", coeffs, torch.int32, (L, MAX_ORDER), dev)
    check_tensor("shifts", shifts, torch.int32, (L,), dev)
    check_tensor("orders", orders, torch.int32, (L,), dev)
    check_tensor("is_fixed", is_fixed, torch.bool, (L,), dev)
    if L == 0 or S == 0:
        return torch.empty((L, S), dtype=torch.int32, device=dev)

    launch = _kernel()
    with torch.cuda.device(dev):
        res_t = torch.empty((S, L), dtype=torch.int32, device=dev)
        res_t.copy_(residuals.t())
        out_t = torch.empty((S, L), dtype=torch.int32, device=dev)
        rc = launch(
            res_t.data_ptr(), coeffs.data_ptr(), shifts.data_ptr(), orders.data_ptr(),
            is_fixed.data_ptr(), out_t.data_ptr(), L, S,
            torch.cuda.current_stream(dev).cuda_stream,
        )
        if rc != 0:
            raise RuntimeError(f"lpc_reconstruct launch failed: CUDA error {rc}")
        LAUNCHES += 1
        out = torch.empty((L, S), dtype=torch.int32, device=dev)
        out.copy_(out_t.t())
    return out
