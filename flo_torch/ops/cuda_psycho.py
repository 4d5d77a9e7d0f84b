"""Wrapper of the hand-written CUDA temporal-masking scan.

The counterpart of the ``lax.scan`` inside the reference's XLA program
``ops/psycho.py`` ``smr``: the kernel is ``csrc/temporal_mask.cu`` (a block a
lane moves its values through shared memory in tiles of 128 hops, the next
tile's loads in flight while 25 threads walk the chains over the tile at
hand, in registers), built at first use by ``ops/_build.py`` and called through ctypes on
PyTorch's current stream. Its plain version is
``ops/psycho.temporal_mask_plain``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ._build import check_tensor

#: Kernel launches made by :func:`temporal_mask_cuda` in this process.
LAUNCHES = 0

#: Width of the band axis (``psycho.NUM_BARK_BANDS``, ``kBands`` of the source).
BANDS = 25


def _kernel():
    fn = _build.load("temporal_mask").flo_temporal_mask
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def temporal_mask_cuda(masking):
    """Drop-in equivalent of ``ops/psycho.temporal_mask_plain`` on the CUDA
    kernel: masking [R, T, 25] float32, contiguous, on a CUDA device -> the
    scan over T, same shape, same bits. R = 0 or T = 0 launches nothing.

    Raises on bad arguments, and when the kernel does not build or launch.
    """
    global LAUNCHES
    dev = masking.device
    if dev.type != "cuda":
        raise ValueError(f"temporal_mask_cuda needs a CUDA tensor, got {dev}")
    if masking.dim() != 3 or masking.shape[2] != BANDS:
        raise ValueError(f"masking must be [R, T, {BANDS}], got shape {tuple(masking.shape)}")
    R, T, _ = masking.shape
    check_tensor("masking", masking, torch.float32, (R, T, BANDS), dev)
    out = torch.empty_like(masking)
    if R == 0 or T == 0:
        return out
    kernel = _kernel()
    with torch.cuda.device(dev):
        rc = kernel(masking.data_ptr(), out.data_ptr(), R, T,
                    torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"temporal_mask launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out
