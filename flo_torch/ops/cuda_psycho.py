"""Wrapper of the hand-written CUDA temporal-masking scan.

The counterpart of the ``lax.scan`` inside the reference's XLA program
``ops/psycho.py`` ``smr``: the kernel is ``csrc/temporal_mask.cu``, built at
first use by ``ops/_build.py`` and called through ctypes on PyTorch's current
stream. Its plain version is ``ops/psycho.temporal_mask_plain``.

The kernel is a segmented scan that is exact: a block owns a chunk of
``CHUNK`` hops of a lane and finds the carry into it by walking two chains, a
lower and an upper one, over a window before the chunk until they meet (the
step is monotone in the carry, so where they meet the true chain is too). The
starts of the two chains come from a first small kernel's facts (a block of
``FACT_HOPS`` hops' largest input a band). :func:`segmented_model` is that
algorithm in numpy, for the tests that cannot run the kernel, and
:func:`scan_cases` gives the shapes and inputs that reach its branches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build
from ._build import check_tensor

#: Kernel launches made by :func:`temporal_mask_cuda` in this process.
LAUNCHES = 0

#: Width of the band axis (``psycho.NUM_BARK_BANDS``, ``kBands`` of the source).
BANDS = 25
#: The source's ``kFact``, ``kChunk``, ``kNear`` and ``kWarm``: hops a fact
#: covers, hops a block owns, and the two windows a carry is looked for in.
FACT_HOPS, CHUNK, NEAR, WARM = 32, 128, 32, 320


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = _build.load("temporal_mask")
    if lib.flo_temporal_mask_fact_hops() != FACT_HOPS:
        raise RuntimeError("csrc/temporal_mask.cu and ops/cuda_psycho.py disagree on kFact")
    if (lib.flo_temporal_mask_chunk_hops(), lib.flo_temporal_mask_warm_hops()) != (CHUNK, WARM):
        raise RuntimeError("csrc/temporal_mask.cu and ops/cuda_psycho.py disagree on the chunk")
    fn = lib.flo_temporal_mask
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_void_p]
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
    facts = torch.empty((R, -(-T // FACT_HOPS), BANDS), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = kernel(masking.data_ptr(), facts.data_ptr(), out.data_ptr(), R, T,
                    torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"temporal_mask launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out


# ---------------- the algorithm in numpy, and the cases that reach its branches ----------------

_DECAY = np.float32(0.7)


def _fmax(a, b):
    """``fmaxf`` as the card has it: the other operand for a NaN, and +0 over
    -0 whichever comes first."""
    r = np.fmax(a, b)
    zeros = (a == 0) & (b == 0)
    both_negative = np.signbit(a) & np.signbit(b)
    return np.where(zeros, np.where(both_negative, np.float32(-0.0), np.float32(0.0)), r)


def _bits_equal(a, b):
    return a.view(np.int32) == b.view(np.int32)


def segmented_model(masking: np.ndarray) -> np.ndarray:
    """The kernel's algorithm on [R, T, 25] float32, hop by hop in numpy (all
    lanes and bands of a step at once): facts, the near and the warm window's
    two chains, the chain from the lane's start where they do not meet, then
    the chunk. Equal to ``temporal_mask_plain`` bit for bit."""
    m = np.ascontiguousarray(masking, dtype=np.float32)
    R, T, B = m.shape
    out = np.empty_like(m)
    nblk = -(-T // FACT_HOPS)
    fact_max = np.full((R, nblk, B), -np.inf, np.float32)
    fact_nan = np.zeros((R, nblk, B), bool)
    for j in range(nblk):
        block = m[:, j * FACT_HOPS : (j + 1) * FACT_HOPS]
        fact_nan[:, j] = np.isnan(block).any(axis=1)
        fact_max[:, j] = np.fmax.reduce(block, axis=1)

    def window(w0: int, t0: int):
        lo = np.zeros((R, B), np.float32)
        up = np.zeros((R, B), np.float32)
        nan = np.zeros((R, B), bool)
        if w0 > 0:
            behind = w0 // FACT_HOPS
            nan = fact_nan[:, :behind].any(axis=1)
            hist = np.fmax.reduce(fact_max[:, :behind], axis=1)
            positive = hist > 0
            lo = np.where(positive, np.float32(1e-45), np.float32(0.0)).astype(np.float32)
            up = np.where(positive, hist, np.float32(0.0)).astype(np.float32)
        for t in range(w0, t0):
            nan = nan | np.isnan(m[:, t])
            lo = _fmax(m[:, t], lo * _DECAY)
            up = _fmax(m[:, t], up * _DECAY)
        return lo, up, nan

    with np.errstate(invalid="ignore", under="ignore"):
        for t0 in range(0, T, CHUNK):
            lo, up, nan = window(max(t0 - NEAR, 0), t0)
            met = nan | _bits_equal(lo, up)
            if not met.all():
                warm0 = max(t0 - WARM, 0)
                lo2, up2, nan2 = window(warm0, t0)
                met2 = nan2 | _bits_equal(lo2, up2)
                if not met2.all():  # one chain from the lane's start
                    prev = np.zeros((R, B), np.float32)
                    nanx = np.zeros((R, B), bool)
                    for t in range(t0):
                        nanx = nanx | np.isnan(m[:, t])
                        prev = _fmax(m[:, t], prev * _DECAY)
                    lo2 = np.where(met2, lo2, prev)
                    nan2 = np.where(met2, nan2, nanx)
                lo = np.where(met, lo, lo2)
                nan = np.where(met, nan, nan2)
            prev = lo.astype(np.float32)
            for t in range(t0, min(T, t0 + CHUNK)):
                nan = nan | np.isnan(m[:, t])
                prev = _fmax(m[:, t], prev * _DECAY)
                out[:, t] = np.where(nan, np.float32(np.nan), prev)
    return out


def music_like(rng, shape) -> np.ndarray:
    """Masking levels [..., T, 25] as ``smr`` makes them: dB values in
    [-120, 100] with runs of -106 (silent bands) and exact zeros."""
    m = rng.uniform(-120.0, 100.0, shape).astype(np.float32)
    if m.size:
        m[..., shape[-2] // 3 : shape[-2] // 2, 3::7] = -106.0
        m[..., ::5, 11] = 0.0
    return m


def scan_cases(seed: int = 6):
    """(name, masking [R, T, 25] float32) for every branch of the kernel: hop
    counts around a fact block and a chunk, the main path's 2,585 and a
    longer lane; lanes of 1, 8, 16 and 33; a loud hop followed by silence
    (the chains do not meet in the near window, and the carry crosses many
    chunks); negative input only; NaN in the first, a middle and the last
    chunk; an infinity (the chain from the lane's start); denormals; -0.0."""
    rng = np.random.default_rng(seed)
    cases = []
    hops = (1, FACT_HOPS - 1, FACT_HOPS, FACT_HOPS + 1, CHUNK - 1, CHUNK, CHUNK + 1, 2585, 5000)
    for T, R in zip(hops, (1, 8, 16, 33, 1, 8, 16, 33, 3)):
        cases.append((f"music-like [{R}, {T}, 25]", music_like(rng, (R, T, BANDS))))

    loud = np.full((8, 2001, BANDS), -100.0, np.float32)
    loud[:, 0] = 96.0
    cases.append(("+96 dB then 2,000 hops of -100 dB", loud))
    late = music_like(rng, (2, 1500, BANDS))
    late[:, 700:] = -100.0
    late[0, 699] = 96.0
    cases.append(("music, a loud hop, then silence", late))
    cases.append(("negative input only",
                  rng.uniform(-120.0, -1.0, (16, 300, BANDS)).astype(np.float32)))
    for where, t in (("first", 5), ("a middle", 1300), ("the last", 2580)):
        m = music_like(rng, (8, 2585, BANDS))
        m[1, t, 4] = np.nan
        m[5, t, ::3] = np.nan
        cases.append((f"NaN in {where} chunk", m))
    inf = music_like(rng, (3, 1000, BANDS))
    inf[0, 100, 2] = np.inf
    inf[2, 500, 7] = -np.inf
    cases.append(("+inf and -inf", inf))
    huge = music_like(rng, (2, 900, BANDS))
    huge[0, 10] = np.float32(3e38)
    cases.append(("a hop near the largest float", huge))
    den = rng.uniform(-1.0, 1.0, (4, 700, BANDS)).astype(np.float32) * np.float32(1e-41)
    den[:, 300:500] = 0.0
    cases.append(("denormal input", den))
    zeros = np.where(rng.random((8, 400, BANDS)) < 0.5, np.float32(-0.0), np.float32(0.0))
    zeros[3, 200:] = rng.uniform(-1.0, 1.0, (200, BANDS)).astype(np.float32)
    cases.append(("-0.0 and +0.0", zeros.astype(np.float32)))
    return cases
