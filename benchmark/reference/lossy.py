"""Plain lossy codec, for the benchmark's checks: the flo transform codec's
encode and decode in numpy float64, with a lower-precision form (bfloat16)
for the control.

Format (the flo lossy codec, Long blocks and the Vorbis window only, which
is all its encoder writes):

- framing: a channel of ``n`` samples gets a 1024-sample zero pre-roll and is
  zero-padded to ``(hops + 1) * 1024``, ``hops = ceil((n + 1024) / 1024)``;
  block ``t`` is samples ``[1024 t, 1024 t + 2048)``, one frame a hop;
- MDCT ``X[k] = sum_i x[i] w[i] cos(pi / 1024 (i + 0.5 + 512)(k + 0.5))``, ``w``
  the Vorbis window;
- psychoacoustic model: Bark bands of the bins' centre frequencies, the
  band's mean energy in dB, simultaneous masking ``max_j(db[j] + spread[j,
  i]) - 6`` with a spread of -25 dB a band upward and 0 downward, temporal
  masking ``thr[t] = max(mask[t], 0.7 thr[t - 1])`` from 0, a bin's threshold
  ``max(thr[band], ATH) - 10``, and the bin's SMR ``20 log10|X| - threshold``;
- quantizer: a band's scale ``sf = 30000 / max|X|`` (1 for a band at most
  1e-10), ``q = round half away(X sf)`` clamped to int16, zero where the SMR
  is at most the quality's gate ``-60 (1 - sqrt(1 - quality))``;
- a frame's blob: ``0`` (a long block), the channel count, each channel's 25
  scale factors as u16 ``trunc(256 log2 sf + 32768)``, and each channel's
  coefficients as a u32 length and a run-length stream: runs of (zero count
  varint, nonzero count u8, that many int16), covering the 1024 bins exactly;
- decode: ``X = q / 2**((u - 32768) / 256)`` (0 where ``u`` is 0), the inverse
  MDCT windowed and scaled by 2/1024, 50% overlap-add, the pre-roll hop
  dropped.
"""

from __future__ import annotations

import struct
from functools import lru_cache

import numpy as np

from .container import FormatError, File

N, HOP = 2048, 1024
BANDS = 25
EDGES = np.array([0, 100, 200, 300, 400, 510, 630, 770, 920, 1080, 1270, 1480, 1720, 2000,
                  2320, 2700, 3150, 3700, 4400, 5300, 6400, 7700, 9500, 12000, 15500, 20500],
                 np.float64)


def smr_gate(quality: float) -> float:
    """The quality's SMR gate in dB."""
    q = min(max(float(quality), 0.0), 1.0)
    if q >= 0.99:
        return -100.0
    return -60.0 * (1.0 - max(1.0 - q, 0.001) ** 0.5)


def bf16(x: np.ndarray) -> np.ndarray:
    """``x`` rounded to bfloat16 (nearest, ties to even), as float64."""
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32).astype(np.float64)


@lru_cache(maxsize=None)
def _tables() -> tuple:
    """(Vorbis window [N], pre-twiddle [N], post-twiddle [N/2]) in float64 /
    complex128: with ``n0 = 0.5 + N/4``, ``X[k] = Re(post[k] FFT_N(x w pre)[k])``,
    ``pre[n] = exp(-i pi n / N)``, ``post[k] = exp(-2 pi i n0 (k + 0.5) / N)``."""
    i = np.arange(N, dtype=np.float64)
    win = np.sin(np.pi / 2 * np.sin(np.pi * (i + 0.5) / N) ** 2)
    n0 = 0.5 + HOP / 2
    pre = np.exp(-1j * np.pi * i / N)
    post = np.exp(-2j * np.pi * n0 * (np.arange(HOP) + 0.5) / N)
    return win, pre, post


@lru_cache(maxsize=None)
def _model(rate: int) -> tuple:
    """(ATH [1024] dB, band of each bin [1024], bins a band [25], spread [25,
    25] dB) for a sample rate."""
    f = (np.arange(HOP) + 0.5) * rate / N
    fk = f / 1000.0
    with np.errstate(divide="ignore"):
        ath = 3.64 * fk**-0.8 - 6.5 * np.exp(-0.6 * (fk - 3.3) ** 2) + 0.001 * fk**4
    ath = np.where((f < 20) | (f > 20000), 96.0, np.clip(ath, -10.0, 96.0))
    band = np.minimum(np.searchsorted(EDGES[1:], f, side="right"), BANDS - 1)
    count = np.bincount(band, minlength=BANDS)  # bands are runs of bins, in order
    d = np.arange(BANDS)[None, :] - np.arange(BANDS)[:, None]  # target - masker
    spread = np.where(d >= 0, -25.0 * d, 0.0)
    return ath, band, count, spread


def _frames(pcm: np.ndarray, C: int) -> np.ndarray:
    """Interleaved samples -> blocks [C, hops, N] float64."""
    x = np.asarray(pcm, np.float64).reshape(-1, C).T
    n = x.shape[1]
    hops = -(-(n + HOP) // HOP)
    padded = np.zeros((C, (hops + 1) * HOP))
    padded[:, HOP : HOP + n] = x
    return np.lib.stride_tricks.sliding_window_view(padded, N, axis=1)[:, ::HOP][:, :hops]


def mdct(blocks: np.ndarray, low: bool = False) -> np.ndarray:
    """[..., N] -> [..., N/2]: the MDCT's sum, by an N-point FFT (``low``:
    the windowed input and the coefficients rounded to bfloat16)."""
    win, pre, post = _tables()
    out = np.empty(blocks.shape[:-1] + (HOP,))
    flat_in, flat_out = blocks.reshape(-1, N), out.reshape(-1, HOP)
    for lo in range(0, len(flat_in), 4096):  # bounded temporaries
        x = flat_in[lo : lo + 4096] * win
        if low:
            x = bf16(x)
        flat_out[lo : lo + 4096] = (np.fft.fft(x * pre, axis=-1)[:, :HOP] * post).real
    return bf16(out) if low else out


def imdct(coef: np.ndarray, low: bool = False) -> np.ndarray:
    """[..., N/2] -> [..., N]: ``y[n] = sum_k X[k] cos(2 pi (n + n0)(k + 0.5) / N)``
    windowed and scaled by 2 / (N/2), by an N-point FFT (``low``: the
    coefficients and the output rounded to bfloat16)."""
    win, pre, post = _tables()
    out = np.empty(coef.shape[:-1] + (N,))
    flat_in, flat_out = coef.reshape(-1, HOP), out.reshape(-1, N)
    n0 = 0.5 + HOP / 2
    twist = np.exp(2j * np.pi * n0 * np.arange(HOP) / N)
    phase = np.exp(1j * np.pi * (np.arange(N) + n0) / N)
    for lo in range(0, len(flat_in), 4096):
        c = flat_in[lo : lo + 4096]
        if low:
            c = bf16(c)
        z = np.zeros((len(c), N), np.complex128)
        z[:, :HOP] = c * twist
        flat_out[lo : lo + 4096] = (np.fft.ifft(z, axis=-1) * N * phase).real * win * (2.0 / HOP)
    return bf16(out) if low else out


def _per_band(ufunc, x: np.ndarray, count: np.ndarray) -> np.ndarray:
    """``ufunc`` reduced over each band's bins of x [..., 1024] -> [..., 25],
    0 for a band with no bin."""
    starts = np.concatenate([[0], np.cumsum(count)[:-1]])
    out = ufunc.reduceat(x, np.minimum(starts, HOP - 1), axis=-1)
    return np.where(count > 0, out, 0.0)


def smr(coef: np.ndarray, rate: int) -> np.ndarray:
    """coef [C, T, 1024] -> SMR [C, T, 1024] in dB."""
    ath, band, count, spread = _model(rate)
    energy = _per_band(np.add, np.square(coef), count)
    with np.errstate(divide="ignore", invalid="ignore"):
        db = np.where((count > 0) & (energy > 1e-10),
                      10 * np.log10(np.maximum(energy / np.maximum(count, 1), 1e-300)), -100.0)
    mask = (db[..., :, None] + spread).max(axis=-2) - 6.0
    thr = np.empty_like(mask)
    prev = np.zeros(mask.shape[:-2] + (BANDS,))
    for t in range(mask.shape[-2]):
        prev = np.maximum(mask[..., t, :], 0.7 * prev)
        thr[..., t, :] = prev
    per_bin = np.maximum(thr[..., band], ath) - 10.0
    mag = np.abs(coef)
    with np.errstate(divide="ignore"):
        sig = np.where(mag > 1e-10, 20 * np.log10(np.maximum(mag, 1e-300)), -100.0)
    return sig - per_bin


def encode(pcm: np.ndarray, C: int, rate: int, quality: float, low: bool = False):
    """Interleaved samples -> (q [C, hops, 1024] int64, sf u16 [C, hops, 25]).
    ``low`` computes in bfloat16: the control."""
    x = _frames(bf16(pcm) if low else pcm, C)
    coef = mdct(x, low)
    _, band, count, _ = _model(rate)
    bmax = _per_band(np.maximum, np.abs(coef), count)
    sf = np.where(bmax > 1e-10, 30000.0 / np.maximum(bmax, 1e-300), 1.0)
    scaled = coef * sf[..., band]
    q = np.clip(np.sign(scaled) * np.floor(np.abs(scaled) + 0.5), -32768, 32767)
    q = np.where(smr(coef, rate) > smr_gate(quality), q, 0).astype(np.int64)
    u16 = np.trunc(np.clip(np.log2(np.maximum(sf, 1e-37)) * 256 + 32768, 0, 65535))
    return q, np.where(sf > 1e-10, u16, 0).astype(np.int64)


def rle_many(streams) -> np.ndarray:
    """Many channels' run-length streams -> their coefficients [len, 1024]
    int64, decoded side by side, one run of every stream a step. Raises
    ``FormatError`` unless each stream's runs cover the block exactly."""
    S = len(streams)
    out = np.zeros((S, HOP), np.int64)
    lens = np.array([len(s) for s in streams], np.int64)
    start = np.concatenate([[0], np.cumsum(lens)])[:-1]
    end = start + lens
    buf = np.frombuffer(b"".join(streams) + bytes(8), np.uint8).astype(np.int64)
    pos, idx = start.copy(), np.zeros(S, np.int64)
    live = np.flatnonzero(pos < end)
    while live.size:
        p, e = pos[live], end[live]
        zeros = np.zeros(live.size, np.int64)
        more = np.ones(live.size, bool)
        for j in range(5):  # the zero count, a varint of at most 5 bytes
            byte = buf[p]
            zeros |= np.where(more, (byte & 0x7F) << (7 * j), 0)
            p = p + more
            more &= (byte & 0x80) != 0
            if not more.any():
                break
        if more.any() or (p >= e).any():
            raise FormatError("run header")
        nz = buf[p]
        p = p + 1
        first = idx[live] + zeros
        if (first + nz > HOP).any() or (p + 2 * nz > e).any():
            raise FormatError("run outside the block")
        who = np.repeat(np.arange(live.size), nz)
        within = np.arange(who.size) - np.repeat(np.cumsum(nz) - nz, nz)
        at = p[who] + 2 * within
        vals = (buf[at] | (buf[at + 1] << 8)).astype(np.uint16).view(np.int16)
        out[live[who], first[who] + within] = vals
        idx[live] = first + nz
        pos[live] = p + 2 * nz
        live = live[pos[live] < end[live]]
    if (idx != HOP).any():
        raise FormatError("runs do not cover the block")
    return out


def parse(f: File) -> tuple:
    """A parsed lossy file's (q [C, hops, 1024] int64, sf u16 [C, hops, 25])."""
    C, T = f.channels, len(f.frames)
    sf = np.zeros((C, T, BANDS), np.int64)
    streams = []  # frame-major, channel-minor
    for t, fr in enumerate(f.frames):
        if fr.ftype != 253 or fr.samples != HOP or len(fr.channels) != 1:
            raise FormatError("not a long transform frame")
        blob = fr.channels[0]
        if len(blob) < 2 + 50 * C or blob[0] != 0 or blob[1] != C:
            raise FormatError("transform frame header")
        sf[:, t] = np.frombuffer(blob, "<u2", BANDS * C, 2).reshape(C, BANDS)
        pos = 2 + 50 * C
        for c in range(C):
            if pos + 4 > len(blob):
                raise FormatError("channel length")
            (ln,) = struct.unpack_from("<I", blob, pos)
            streams.append(blob[pos + 4 : pos + 4 + ln])
            pos += 4 + ln
        if pos != len(blob):
            raise FormatError("transform frame length")
    q = rle_many(streams).reshape(T, C, HOP).transpose(1, 0, 2) if streams else np.zeros((C, 0, HOP), np.int64)
    return np.ascontiguousarray(q), sf


def decode(q: np.ndarray, sf: np.ndarray, rate: int, low: bool = False) -> np.ndarray:
    """(q, sf u16) of a file -> interleaved samples [(hops - 1) * 1024 * C]
    in float64 (``low``: the inverse transform in bfloat16)."""
    _, band, _, _ = _model(rate)
    scale = np.where(sf > 0, np.exp2((sf.astype(np.float64) - 32768) / 256), 0.0)[..., band]
    coef = np.where(scale > 0, q / np.where(scale > 0, scale, 1.0), 0.0)
    C = coef.shape[0]
    y = imdct(coef, low)
    seg = y[:, :, :HOP].copy()
    seg[:, 1:] += y[:, :-1, HOP:]
    out = seg[:, 1:].reshape(C, -1).T.reshape(-1)
    return bf16(out) if low else out
