"""Wrapper of the hand-written CUDA candidate-search kernel.

The counterpart of the reference's XLA program ``ops/select.py``
``encode_select_step``: the kernel is ``csrc/lossless_select.cu`` (one block
per lane, the candidate table in shared memory, three passes over the lane),
built at first use by ``ops/_build.py`` and called through ctypes on
PyTorch's current stream. Its plain version is ``ops/select.encode_select_step``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ._build import check_tensor
from .lpc import MAX_ORDER

#: Kernel launches made by :func:`encode_select_cuda` in this process.
LAUNCHES = 0

#: Candidates a lane may have (csrc/lossless_select.cu kMaxCand).
MAX_CANDIDATES = 16


def _kernel():
    fn = _build.load("lossless_select").flo_lossless_select
    fn.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_uint32, ctypes.c_int32, ctypes.c_int64, ctypes.c_int64]
        + [ctypes.c_void_p] * 7
    )
    fn.restype = ctypes.c_int
    return fn


def encode_select_cuda(
    lanes, nvalid, coeffs_all, shifts_all, orders_all, fixed_all, cand_ok, is_lpc: tuple
):
    """Drop-in equivalent of ``ops/select.encode_select_step`` on the CUDA
    kernel: the same arguments (lanes [L, S] int32, nvalid [L] int32 in
    [0, S], coeffs_all [L, NC, 12] int32, shifts_all / orders_all [L, NC]
    int32, fixed_all / cand_ok [L, NC] bool, all contiguous on one CUDA
    device; is_lpc: NC flags, NC <= 16) and the same six int32 outputs.
    Raises on anything else, and when the kernel does not build or launch.
    """
    global LAUNCHES
    dev = lanes.device
    if dev.type != "cuda":
        raise ValueError(f"encode_select_cuda needs CUDA tensors, got {dev}")
    if lanes.dim() != 2 or coeffs_all.dim() != 3:
        raise ValueError("lanes must be [L, S] and coeffs_all [L, NC, 12]")
    L, S = lanes.shape
    NC = coeffs_all.shape[1]
    if not 1 <= NC <= MAX_CANDIDATES or len(is_lpc) != NC:
        raise ValueError(f"{NC} candidates with {len(is_lpc)} is_lpc flags (1..16 expected)")
    check_tensor("lanes", lanes, torch.int32, (L, S), dev)
    check_tensor("nvalid", nvalid, torch.int32, (L,), dev)
    check_tensor("coeffs_all", coeffs_all, torch.int32, (L, NC, MAX_ORDER), dev)
    for name, t, dt in (
        ("shifts_all", shifts_all, torch.int32), ("orders_all", orders_all, torch.int32),
        ("fixed_all", fixed_all, torch.bool), ("cand_ok", cand_ok, torch.bool),
    ):
        check_tensor(name, t, dt, (L, NC), dev)
    lpc_mask = sum(1 << c for c, flag in enumerate(is_lpc) if flag)

    def i32(*shape):
        return torch.empty(shape, dtype=torch.int32, device=dev)

    sel, k, size, win_shift = i32(L), i32(L), i32(L), i32(L)
    residuals, win_coeffs = i32(L, S), i32(L, MAX_ORDER)
    if L == 0:
        return sel, k, size, residuals, win_coeffs, win_shift
    launch = _kernel()
    with torch.cuda.device(dev):
        rc = launch(
            lanes.data_ptr(), nvalid.data_ptr(), coeffs_all.data_ptr(), shifts_all.data_ptr(),
            orders_all.data_ptr(), fixed_all.data_ptr(), cand_ok.data_ptr(), lpc_mask, NC, L, S,
            sel.data_ptr(), k.data_ptr(), size.data_ptr(), residuals.data_ptr(),
            win_coeffs.data_ptr(), win_shift.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"lossless_select launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return sel, k, size, residuals, win_coeffs, win_shift
