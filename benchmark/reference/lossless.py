"""Plain lossless decoder, for the benchmark's checks: Rice streams, the
fixed and LPC predictors, mid/side, in numpy over int64.

Format (the flo lossless codec):

- a residual is zigzagged, ``u = 2s`` or ``-2s - 1``, and coded as ``u >> k``
  one bits, a zero bit and the low ``k`` bits of ``u``, most significant
  first; a lane's stream is whole bytes, its last byte padded with zeros;
- a lane of order ``p`` predicts ``s[i] = r[i] + (sum_j c[j] s[i-1-j] >> shift)``
  wrapped to int32; while ``i < p`` an LPC lane predicts 0 and a fixed lane
  uses the fixed predictor of order ``i``; the fixed predictors of orders
  0..4 have the binomial taps of the order's difference filter, shift 0;
- a stereo frame with flag bit 0 holds mid = l + r and side = l - r, undone
  as ``l = (m + s) / 2``, ``r = (m - s) / 2`` (int32, truncating).

The decode of a file gives its int32 samples, [samples, channels].
"""

from __future__ import annotations

import numpy as np

from .container import FormatError

FIXED_TAPS = {0: (), 1: (1,), 2: (2, -1), 3: (3, -3, 1), 4: (4, -6, 4, -1)}


def _bits_at(words: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """The 32 bits of the stream from bit ``pos`` on, as uint64 values below
    2**32 (``words[b]`` holds bytes b..b+7 big-endian)."""
    return (words[pos >> 3] << (pos & 7).astype(np.uint64)) >> np.uint64(32)


def rice_decode_lanes(streams, ks, ns) -> list:
    """Residuals of many lanes, decoded side by side: ``streams[i]`` holds
    exactly ``ns[i]`` codes of parameter ``ks[i]`` (and zero padding to its
    last byte), else ``FormatError``. Returns one int64 array a lane."""
    L = len(streams)
    if L == 0:
        return []
    ks = np.asarray(ks, np.int64)
    ns = np.asarray(ns, np.int64)
    if ks.max() > 30:
        raise FormatError("Rice parameter")
    lens = np.array([len(s) for s in streams], np.int64)
    offs = np.concatenate([[0], np.cumsum(lens)])
    # 8 zero bytes after every lane and 16 at the end: a lane that runs over
    # its stream reads zeros, and the length check below catches it.
    buf = np.zeros(int(offs[-1]) + 8 * L + 16, np.uint8)
    starts = offs[:-1] + 8 * np.arange(L)
    for s, o in zip(streams, starts):
        buf[o : o + len(s)] = np.frombuffer(s, np.uint8)
    wide = np.lib.stride_tricks.sliding_window_view(buf, 8)
    words = np.zeros(len(wide), np.uint64)
    for j in range(8):
        words |= wide[:, j].astype(np.uint64) << np.uint64(56 - 8 * j)
    pos = 8 * starts  # bit position of each lane's next code
    n_max = int(ns.max())
    out = np.zeros((L, n_max), np.int64)
    live = np.arange(L)
    kk = ks.astype(np.uint64)
    for i in range(n_max):
        if i and ns.min() <= i:
            live = live[ns[live] > i]
        p = pos[live]
        v = _bits_at(words, p)
        # Leading ones of v: the quotient, when under 32.
        q = 32 - np.frexp((~v & np.uint64(0xFFFFFFFF)).astype(np.float64))[1].astype(np.int64)
        long = np.flatnonzero(q >= 32)
        for j in long:  # a quotient of 32 or more: count on, 32 bits at a time
            qq, pp = 0, int(p[j])
            while True:
                w = int(_bits_at(words, np.array([pp]))[0])
                lead = 32 - (~w & 0xFFFFFFFF).bit_length()
                qq += lead
                if lead < 32:
                    break
                pp += 32
            q[j] = qq
        r = p + q + 1
        k = kk[live]
        rem = _bits_at(words, r) >> (np.uint64(32) - k)
        rem = np.where(k == 0, np.uint64(0), rem).astype(np.int64)
        u = (q << ks[live]) | rem
        out[live, i] = (u >> 1) ^ -(u & 1)
        pos[live] = r + ks[live]
    end_bits = pos - 8 * starts
    res = []
    for lane in range(L):
        e, n_bytes = int(end_bits[lane]), int(lens[lane])
        if (e + 7) // 8 != n_bytes:
            raise FormatError("Rice stream length")
        if e % 8 and int(buf[starts[lane] + e // 8]) & (0xFF >> (e % 8)):
            raise FormatError("Rice stream padding")
        res.append(out[lane, : ns[lane]])
    return res


def reconstruct(residuals: np.ndarray, taps: np.ndarray, shifts: np.ndarray,
                orders: np.ndarray, fixed: np.ndarray) -> np.ndarray:
    """Samples of many lanes at once: residuals [L, S] int64, taps [L, 12]
    (tap j meets sample i-1-j), shifts, orders [L], fixed [L] bool. Returns
    [L, S] int64 values of int32 samples."""
    L, S = residuals.shape
    hist = np.zeros((L, S + 12), np.int64)  # hist[:, 12 + i] = s[i]
    rev = taps[:, ::-1].astype(np.int64)  # meets hist[:, i : i + 12]
    ramp = np.zeros((5, 12), np.int64)
    for o, t in FIXED_TAPS.items():
        ramp[o, 12 - len(t) :] = t[::-1]
    warm = int(orders.max(initial=0))
    sh = shifts.astype(np.int64)
    for i in range(S):
        c = rev
        if i < warm:
            c = np.where((i < orders)[:, None], np.where(fixed[:, None], ramp[min(i, 4)], 0), rev)
        pred = np.einsum("lj,lj->l", c, hist[:, i : i + 12]) >> sh
        hist[:, 12 + i] = (pred + residuals[:, i]).astype(np.int32)
    return hist[:, 12:]


def _div2(x: np.ndarray) -> np.ndarray:
    return np.where(x >= 0, x >> 1, -((-x) >> 1))


def decode(files) -> list:
    """Parsed lossless files' samples, each [total, channels] int64; the
    lanes of all the files are decoded side by side."""
    lanes = []  # (file, frame, channel, Channel, samples)
    for fi, f in enumerate(files):
        for t, fr in enumerate(f.frames):
            if fr.ftype == 253:
                raise FormatError("a transform frame in a lossless file")
            lanes += [(fi, t, ci, ch, fr.samples) for ci, ch in enumerate(fr.channels)]
    L = len(lanes)
    S = max((n for *_, n in lanes), default=0)
    res = np.zeros((L, S), np.int64)
    taps = np.zeros((L, 12), np.int64)
    shifts, orders = np.zeros(L, np.int64), np.zeros(L, np.int64)
    fixed = np.zeros(L, bool)
    jobs = []  # (lane, stream, k, n)
    for lane, (_, _, _, ch, n) in enumerate(lanes):
        if ch.kind == "raw":
            res[lane, :n] = np.frombuffer(ch.payload, "<i2")
        elif ch.kind in ("lpc", "fixed"):
            jobs.append((lane, ch.payload, ch.k, n))
            orders[lane] = ch.order
            if ch.kind == "fixed":
                fixed[lane] = True
                taps[lane, : ch.order] = FIXED_TAPS[ch.order]
            else:
                taps[lane, : ch.order] = ch.coeffs
                shifts[lane] = ch.shift
    if jobs:
        idx, streams, ks, ns = zip(*jobs)
        for lane, r in zip(idx, rice_decode_lanes(streams, ks, ns)):
            res[lane, : len(r)] = r
    samples = reconstruct(res, taps, shifts, orders, fixed)
    out, lane = [], 0
    for f in files:
        C = f.channels
        pieces = []
        for fr in f.frames:
            x = samples[lane : lane + C, : fr.samples]
            lane += C
            if C == 2 and fr.flags & 1:
                m, s = x[0], x[1]
                x = np.stack([_div2((m + s).astype(np.int32).astype(np.int64)),
                              _div2((m - s).astype(np.int32).astype(np.int64))])
            pieces.append(x.T)
        out.append(np.concatenate(pieces) if pieces else np.zeros((0, C), np.int64))
    return out


def pcm_to_int(pcm: np.ndarray) -> np.ndarray:
    """float32 samples to the codec's integers: ``x * 32767`` in float32,
    clamped to [-32768, 32767] and truncated toward zero."""
    x = np.asarray(pcm, np.float32) * np.float32(32767.0)
    return np.trunc(np.clip(x, np.float32(-32768.0), np.float32(32767.0))).astype(np.int64)
