"""Wrapper of the hand-written CUDA Rice / raw-LE16 pack kernel.

The counterpart of the reference's XLA programs ``ops/blockspread.py``
``pack_stage1`` + ``pack_stage2``: the kernels are ``csrc/rice_pack.cu`` (a
count of each lane's bits, skipped where the caller knows the lanes' byte
counts; lane offsets on the device; then a block a lane that walks it in
tiles of 2,048 codes, assembles each tile's words in shared memory and stores
every word of the stream once, in byte order), built at first use by
``ops/_build.py`` and called through ctypes on PyTorch's current stream. Its
plain version is ``ops/blockspread.pack_lanes_words``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from ._build import check_tensor

#: Pack calls made by :func:`pack_lanes_cuda` in this process (each launches
#: the layout and pack kernels once, and the count kernel without a hint).
LAUNCHES = 0

#: Longest code in bits (255 unary ones, the terminator, 15 remainder bits).
MAX_CODE_BITS = 271

#: Codes the kernel takes at a time (``kTile`` of ``csrc/rice_pack.cu``).
TILE = 2048


def dense_lane_case(seed: int, L: int, S: int, dense: int = 1):
    """Ordinary lanes (small residuals at random k, ragged lengths) around
    lane ``dense``, which is nothing but 271-bit codes (k = 15, residuals of
    +-2**30) over all S samples: a tile of it is 17,344 words of stream.
    Numpy arrays (residuals, k, nvalid, is_raw)."""
    rng = np.random.default_rng(seed)
    res = rng.integers(-3000, 3000, (L, S)).astype(np.int32)
    k = rng.integers(0, 16, L).astype(np.int32)
    nvalid = rng.integers(0, S + 1, L).astype(np.int32)
    res[dense] = rng.choice([-(1 << 30), 1 << 30], S)
    k[dense], nvalid[dense] = 15, S
    return res, k, nvalid, np.zeros(L, bool)


def edge_cases(seed: int = 0) -> dict:
    """The shapes a tiled packer is sensitive to, by name, as numpy arrays
    (residuals, k, nvalid, is_raw): lanes of a tile less one, a tile, a tile
    and one, and two tiles and three samples (a full lane, ragged ones, a raw
    one); a lane of 271-bit codes over several tiles beside ordinary lanes;
    lanes of 1-bit codes and of near-silence turning loud; only raw lanes,
    with samples past int16; only empty lanes; one lane of one sample; a lane
    that ends on a word boundary and one that ends one bit past it."""
    rng = np.random.default_rng(seed)
    cases = {}
    for name, S in (("tile - 1", TILE - 1), ("tile", TILE), ("tile + 1", TILE + 1),
                    ("2 tiles + 3", 2 * TILE + 3)):
        res = rng.integers(-300, 300, (5, S)).astype(np.int32)
        k = rng.integers(0, 9, 5).astype(np.int32)
        nvalid = rng.integers(0, S + 1, 5).astype(np.int32)
        is_raw = np.zeros(5, bool)
        nvalid[[0, 3]], is_raw[3] = S, True
        cases[name] = (res, k, nvalid, is_raw)
    cases["271-bit lane"] = dense_lane_case(seed + 1, 3, 2 * TILE + 3)
    # Lane 0 is 1-bit codes throughout (a thread's codes fill no word); lane 1
    # (k = 0) goes from codes of 1-3 bits to ordinary codes to codes of about
    # 100 bits, a tile each, so it takes each of the kernel's routes in turn;
    # lane 2 is ordinary.
    S = 3 * TILE + 9
    res = rng.integers(-40, 40, (3, S)).astype(np.int32)
    res[0] = 0
    res[1, :TILE] = rng.integers(-1, 2, TILE)
    res[1, TILE : 2 * TILE] = rng.integers(-8, 9, TILE)
    res[1, 2 * TILE :] = rng.integers(-100, 100, S - 2 * TILE)
    cases["quiet, then loud"] = (res, np.array([0, 0, 4], np.int32),
                                 np.array([S, S, S - 5], np.int32), np.zeros(3, bool))
    S = TILE + 5
    cases["all raw"] = (rng.integers(-70000, 70000, (4, S)).astype(np.int32),
                        np.zeros(4, np.int32), np.array([S, 0, 7, S - 1], np.int32),
                        np.ones(4, bool))
    cases["all empty"] = (rng.integers(-300, 300, (4, 100)).astype(np.int32),
                          rng.integers(0, 16, 4).astype(np.int32), np.zeros(4, np.int32),
                          np.array([False, True, False, False]))
    cases["one sample"] = (np.array([[-5]], np.int32), np.array([2], np.int32),
                           np.array([1], np.int32), np.zeros(1, bool))
    # Lane 0: 64 codes of 4 bits (k = 3, u < 8), 8 words to the bit. Lane 1:
    # 33 codes of 1 bit (k = 0, u = 0), a word and one bit. Lane 2 follows.
    res = rng.integers(-4, 4, (3, 64)).astype(np.int32)
    res[1] = 0
    cases["word boundary"] = (res, np.array([3, 0, 5], np.int32),
                              np.array([64, 33, 50], np.int32), np.zeros(3, bool))
    return cases


def _kernels():
    lib = _build.load("rice_pack")
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    layout, pack = lib.flo_rice_pack_layout, lib.flo_rice_pack
    layout.argtypes = [ptr] * 9 + [i64, i64, ptr]
    pack.argtypes = [ptr] * 8 + [i64] * 3 + [ptr]
    layout.restype = pack.restype = ctypes.c_int
    return layout, pack


def kernel_geometry() -> tuple:
    """(codes a tile, words a window) as the built kernel has them."""
    out = (ctypes.c_int32 * 2)()
    _build.load("rice_pack").flo_rice_pack_geometry(out)
    return tuple(out)


def pack_lanes_cuda(residuals, k, nvalid, is_raw, max_words=None, size_hint=None):
    """Drop-in equivalent of ``ops/blockspread.pack_lanes_words`` on the CUDA
    kernels: residuals [L, S] int32, k [L] int32 in [0, 15], nvalid [L] int32
    in [0, S], is_raw [L] bool, all contiguous on one CUDA device ->
    (payload uint8, lane_bytes int64 [L], lane_off int64 [L]).

    Without ``max_words`` the payload is exactly the packed words, which
    waits on the device for their count. With it the buffer has
    ``max_words`` words, allocated without waiting and not initialised: the
    packed bytes end at ``lane_off[-1] + lane_bytes[-1]``, and what lies past
    that, rounded up to a word, is unspecified. Words past the buffer are not
    written: a caller whose bound is short finds fewer bytes than
    ``lane_bytes`` promises.

    ``size_hint`` [L] int32, where the caller knows every lane's packed byte
    count (the search's ``size``), saves the pass that counts them: the
    residuals are then read once. Lane ``l`` gets ``ceil(size_hint[l] / 4)``
    words. ``lane_bytes`` stays the packer's own count, so a caller can (and
    the encoder does) check it against the hint; a lane whose hint is short
    is cut at its span, never written outside it.

    Raises on bad arguments, and when a kernel does not build or launch.
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
    if size_hint is not None:
        check_tensor("size_hint", size_hint, torch.int32, (L,), dev)
    if L == 0:
        none = torch.zeros(0, dtype=torch.int64, device=dev)
        return torch.zeros(4 * (max_words or 0), dtype=torch.uint8, device=dev), none, none

    layout, pack = _kernels()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        # One allocation: lane bits (scratch), byte offsets, spans in words,
        # byte counts, and the word total.
        meta = torch.empty(4 * L + 1, dtype=torch.int64, device=dev)
        lane_bits, lane_off, lane_span, lane_bytes = (meta[i * L : (i + 1) * L] for i in range(4))
        lanes = (residuals.data_ptr(), k.data_ptr(), nvalid.data_ptr(), is_raw.data_ptr())
        rc = layout(
            *lanes, None if size_hint is None else size_hint.data_ptr(), lane_bits.data_ptr(),
            lane_off.data_ptr(), lane_span.data_ptr(), meta[4 * L :].data_ptr(), L, S, stream,
        )
        if rc != 0:
            raise RuntimeError(f"rice_pack layout launch failed: CUDA error {rc}")
        nw = int(meta[4 * L]) if max_words is None else int(max_words)
        words = torch.empty(nw, dtype=torch.int32, device=dev)
        rc = pack(
            *lanes, lane_off.data_ptr(), lane_span.data_ptr(), words.data_ptr(),
            lane_bytes.data_ptr(), L, S, nw, stream,
        )
        if rc != 0:
            raise RuntimeError(f"rice_pack launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return words.view(torch.uint8), lane_bytes, lane_off
