"""Rice / raw-LE16 bitstream pack: the plain PyTorch version and the backend
choice.

Contract (the reference's ``flo_tpu/ops/blockspread.py:48-54``): for every
lane, ``payload[off[l] : off[l] + n[l]]`` is byte for byte
``rice_host.encode(residuals[l, :nvalid[l]], k[l])``; raw lanes carry their
samples verbatim as little-endian int16 (with Rust's ``as i16`` wrap); lane
offsets are word-aligned (multiples of 4 bytes).

A Rice code is ``min(u >> k, 255)`` one bits, a zero, then the low ``k`` bits
of the zigzag ``u``, MSB first: up to 255 + 1 + 15 = 271 bits, spanning up to
10 32-bit words. Every code is written whole: the reference's ``bad`` lanes,
patch capacity and host re-pack, and its superrow layout, have no
counterpart.

On a CUDA tensor :func:`pack_best` launches the hand-written kernel
(``ops/cuda_ricepack.py``, ``csrc/rice_pack.cu``: a block a lane walks it in
tiles, assembles each tile's words in shared memory and stores every word of
the stream once, in byte order); on a CPU tensor it runs
:func:`pack_lanes_words`, the yardstick of exactness.
"""

from __future__ import annotations

import torch

from .select import zigzag_u32

#: Worst-case packed bits per sample of a search winner (the raw baseline).
WORST_BITS_PER_SAMPLE = 16

#: Samples per encode chunk, so that the worst case of a chunk's bit offsets
#: stays below 2**30 (the reference's int32 bound, kept as the chunking rule).
MAX_BATCH_SAMPLES = (1 << 30) // WORST_BITS_PER_SAMPLE - 1

_M32 = 0xFFFFFFFF


def code_fields(residuals, k, nvalid, is_raw):
    """Per-code (length in bits, unary ones, tail value, tail length), int64
    [L, S], zero past nvalid. The code is ``ones`` one bits followed by the
    ``tail_len``-bit value ``tail``, MSB first: for Rice, a zero terminator
    and the low k bits of u (``tail_len = 1 + k``); for raw, the two bytes
    of the LE16 sample (``ones = 0``, ``tail_len = 16``)."""
    L, S = residuals.shape
    k64 = k.to(torch.int64)[:, None]
    u = zigzag_u32(residuals)
    q = (u >> k64).clamp(max=255)
    rem = u & ((1 << k64) - 1)
    raw = residuals.to(torch.int64) & 0xFFFF
    raw_be = ((raw & 0xFF) << 8) | (raw >> 8)
    israw = is_raw[:, None]
    valid = torch.arange(S, device=residuals.device)[None, :] < nvalid[:, None]
    ones = torch.where(israw, 0, q)
    tail_len = torch.where(israw, 16, 1 + k64).expand(L, S)
    tail = torch.where(israw, raw_be, rem)
    clen = ones + tail_len
    zero = torch.zeros((), dtype=torch.int64, device=residuals.device)
    return tuple(torch.where(valid, t, zero) for t in (clen, ones, tail, tail_len))


def lane_layout(lane_bits: torch.Tensor):
    """Per-lane (bytes, word offset, words) from bit counts [L] int64; lanes
    are word-aligned and back to back."""
    lane_bytes = (lane_bits + 7) >> 3
    lane_words = (lane_bits + 31) >> 5
    lane_woff = torch.cumsum(lane_words, 0) - lane_words
    return lane_bytes, lane_woff, lane_words


def words_to_bytes(words: torch.Tensor) -> torch.Tensor:
    """MSB-first int64 word values in [0, 2**32) [NW] -> the byte stream
    uint8 [4 * NW]."""
    shifts = torch.tensor([24, 16, 8, 0], device=words.device)
    return ((words[:, None] >> shifts) & 0xFF).to(torch.uint8).reshape(-1)


def pack_lanes_words(residuals, k, nvalid, is_raw, size_hint=None):
    """Plain pack of every lane's code stream.

    residuals [L, S] int32 (Rice lanes: residuals; raw lanes: samples);
    k [L] int32; nvalid [L] int32; is_raw [L] bool. Returns (payload uint8
    [4 * total_words], lane_bytes int64 [L], lane_off int64 [L] in bytes,
    word-aligned).

    Code lengths, an int64 cumsum per lane for the bit offsets, then for
    each word a code touches its 32 bits by ``index_add_`` into int64
    words: the bits of different codes are disjoint, so the sum is an OR.

    ``size_hint`` [L] (integers), as the kernel takes it: lane ``l`` gets
    ``ceil(size_hint[l] / 4)`` words instead of what its own count asks for,
    the words of its stream past that span are dropped, and ``lane_bytes``
    stays the pack's own count. With the true byte counts the result is the
    same as without a hint.
    """
    L, S = residuals.shape
    dev = residuals.device
    clen, ones, tail, tail_len = code_fields(residuals, k, nvalid, is_raw)
    lane_bits = clen.sum(1) if S else torch.zeros(L, dtype=torch.int64, device=dev)
    lane_bytes, lane_woff, lane_words = lane_layout(lane_bits)
    if size_hint is not None:
        lane_words = (size_hint.to(torch.int64).clamp(min=0) + 3) >> 2
        lane_woff = torch.cumsum(lane_words, 0) - lane_words
    total_words = int(lane_words.sum()) if L else 0
    words = torch.zeros(total_words, dtype=torch.int64, device=dev)
    live = clen > 0
    start = ((lane_woff << 5)[:, None] + torch.cumsum(clen, 1) - clen)[live]
    lane_end = (lane_woff + lane_words)[:, None].expand(L, S)[live]
    clen, ones, tail, tail_len = clen[live], ones[live], tail[live], tail_len[live]
    first = start >> 5
    span = ((start + clen - 1) >> 5) - first + 1
    for t in range(int(span.max()) if len(span) else 0):
        w = first + t
        off = (w << 5) - start  # code-relative position of the word's MSB
        # Unary ones [0, ones) land on word bits [lo, hi) from the MSB.
        lo = (-off).clamp(0, 32)
        hi = (ones - off).clamp(0, 32)
        run = ((1 << (32 - lo)) - 1) - ((1 << (32 - hi)) - 1)
        # The tail's MSB lands on word bit a; shift it into place.
        a = ones - off
        sh = 32 - a - tail_len
        placed = torch.where(sh >= 0, tail << sh.clamp(0, 62), tail >> (-sh).clamp(0, 62))
        placed = torch.where((a < 32) & (a + tail_len > 0), placed & _M32, 0)
        hit = (t < span) & (w < lane_end)
        words.index_add_(0, w[hit], (run + placed)[hit])
    return words_to_bytes(words), lane_bytes, lane_woff * 4


def pack_best(residuals, k, nvalid, is_raw, max_words=None, size_hint=None):
    """:func:`pack_lanes_words` for CPU tensors; the hand-written CUDA kernel
    (``ops/cuda_ricepack.py``) for anything else, which launches or raises.

    ``max_words``, where the caller knows a bound on the packed words, lets
    the kernel's buffer be allocated without waiting on the device; the
    payload may then be longer than the packed bytes, which end at
    ``lane_off[-1] + lane_bytes[-1]``, and is unspecified past them.
    ``size_hint`` [L] int32, where the caller knows the lanes' packed byte
    counts, lets the kernel read the residuals once; ``lane_bytes`` stays the
    pack's own count, for the caller to hold against the hint."""
    if residuals.device.type == "cpu":
        return pack_lanes_words(residuals, k, nvalid, is_raw, size_hint=size_hint)
    from .cuda_ricepack import pack_lanes_cuda

    return pack_lanes_cuda(residuals, k, nvalid, is_raw, max_words=max_words,
                           size_hint=size_hint)
