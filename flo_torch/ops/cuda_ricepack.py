"""Wrapper of the hand-written CUDA Rice / raw-LE16 pack kernel.

The counterpart of the reference's XLA programs ``ops/blockspread.py``
``pack_stage1`` + ``pack_stage2``: the kernels are ``csrc/rice_pack.cu``
(per-lane scan of code lengths, one thread per code ORing its words in, a
byte-order pass), built at first use by ``ops/_build.py`` and called through
ctypes on PyTorch's current stream. Its plain version is
``ops/blockspread.pack_lanes_words``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ._build import check_tensor
from .blockspread import lane_layout

#: Pack calls made by :func:`pack_lanes_cuda` in this process (each launches
#: the kernels of both entry points once).
LAUNCHES = 0

#: Longest code in bits (255 unary ones, the terminator, 15 remainder bits).
MAX_CODE_BITS = 271


def _kernels():
    lib = _build.load("rice_pack")
    lengths, scatter = lib.flo_rice_pack_lengths, lib.flo_rice_pack_scatter
    lengths.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
    scatter.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int64] * 3 + [ctypes.c_void_p]
    lengths.restype = scatter.restype = ctypes.c_int
    return lengths, scatter


def pack_lanes_cuda(residuals, k, nvalid, is_raw, max_words=None):
    """Drop-in equivalent of ``ops/blockspread.pack_lanes_words`` on the CUDA
    kernels: residuals [L, S] int32, k [L] int32 in [0, 15], nvalid [L] int32
    in [0, S], is_raw [L] bool, all contiguous on one CUDA device ->
    (payload uint8, lane_bytes int64 [L], lane_off int64 [L]).

    Without ``max_words`` the payload is exactly the packed words, which
    waits on the device for their count; with it the buffer has
    ``max_words`` words and the packed bytes end at ``lane_off[-1] +
    lane_bytes[-1]`` (words past the buffer are not written: a caller whose
    bound is short finds fewer bytes than ``lane_bytes`` promises). Raises on
    bad arguments, and when a kernel does not build or launch.
    """
    global LAUNCHES
    dev = residuals.device
    if dev.type != "cuda":
        raise ValueError(f"pack_lanes_cuda needs CUDA tensors, got {dev}")
    if residuals.dim() != 2:
        raise ValueError(f"residuals must be [L, S], got shape {tuple(residuals.shape)}")
    L, S = residuals.shape
    if MAX_CODE_BITS * S >= 1 << 31:
        raise ValueError(f"lanes of {S} samples could pass 2**31 bits")
    check_tensor("residuals", residuals, torch.int32, (L, S), dev)
    check_tensor("k", k, torch.int32, (L,), dev)
    check_tensor("nvalid", nvalid, torch.int32, (L,), dev)
    check_tensor("is_raw", is_raw, torch.bool, (L,), dev)
    if L == 0:
        none = torch.zeros(0, dtype=torch.int64, device=dev)
        return torch.zeros(4 * (max_words or 0), dtype=torch.uint8, device=dev), none, none

    lengths, scatter = _kernels()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        bitoff = torch.empty((L, S), dtype=torch.int32, device=dev)
        lane_bits = torch.zeros(L, dtype=torch.int64, device=dev)
        rc = lengths(
            residuals.data_ptr(), k.data_ptr(), nvalid.data_ptr(), is_raw.data_ptr(),
            bitoff.data_ptr(), lane_bits.data_ptr(), L, S, stream,
        )
        if rc != 0:
            raise RuntimeError(f"rice_pack lengths launch failed: CUDA error {rc}")
        lane_bytes, lane_woff, lane_words = lane_layout(lane_bits)
        nw = int(lane_words.sum()) if max_words is None else int(max_words)
        words = torch.zeros(nw, dtype=torch.int32, device=dev)
        rc = scatter(
            residuals.data_ptr(), k.data_ptr(), nvalid.data_ptr(), is_raw.data_ptr(),
            bitoff.data_ptr(), lane_woff.data_ptr(), words.data_ptr(), L, S, nw, stream,
        )
        if rc != 0:
            raise RuntimeError(f"rice_pack scatter launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return words.view(torch.uint8), lane_bytes, lane_woff * 4
