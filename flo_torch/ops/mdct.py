"""Batched MDCT/IMDCT in PyTorch.

Same transform math as the reference (libflo/src/lossy/mdct.rs:166-291):
window -> fold N samples into N/4 complex points -> N/4 FFT -> twiddle,
with twiddle factors e^{i*(pi/n2)*(k+1/8)} and IMDCT output scaled by 2/n2 and
windowed. Every (lane, block) is one row of a [..., N] tensor, the FFT is
``torch.fft.fft`` on complex64 over the whole batch (the reference leaves it
to its library's FFT too), and overlap-add is one shifted add over the block
axis (no sequential state).

Windows: Sine, Vorbis, KBD(alpha=4) per mdct.rs:99-161. The window and
twiddle tables are computed in numpy, exactly as the reference computes
them, and turned into tensors by :func:`tables_to_device`.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

LONG_N = 2048
SHORT_N = 256


def sine_window(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.float32)
    return np.sin(np.pi * (i + 0.5) / n).astype(np.float32)


def vorbis_window(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.float32)
    x = np.sin(np.pi * (i + 0.5) / n)
    return np.sin(np.pi / 2.0 * x * x).astype(np.float32)


def kbd_window(n: int, alpha: float = 4.0) -> np.ndarray:
    half = n // 2
    i = np.arange(half + 1, dtype=np.float64)
    arg = np.pi * alpha * np.sqrt(np.maximum(0.0, 1.0 - (2.0 * i / half - 1.0) ** 2))
    kaiser = np.i0(arg)
    cumsum = np.cumsum(kaiser)
    w = np.zeros(n, dtype=np.float32)
    w[:half] = np.sqrt(cumsum[:half] / cumsum[half]).astype(np.float32)
    w[n - half :] = w[:half][::-1]
    return w


_WINDOWS = {"sine": sine_window, "vorbis": vorbis_window, "kbd": kbd_window}


@lru_cache(maxsize=None)
def _tables(n: int, window: str):
    """Window [n] float32 and twiddle [n/4] complex64 as host numpy."""
    n2, n4 = n // 2, n // 4
    k = np.arange(n4, dtype=np.float32)
    ang = np.float32(np.pi) / np.float32(n2) * (k + np.float32(0.125))
    tw = np.cos(ang).astype(np.float32) + 1j * np.sin(ang).astype(np.float32)
    win = _WINDOWS[window](n)
    return win, tw.astype(np.complex64)


@lru_cache(maxsize=None)
def tables_to_device(n: int, window: str, device):
    """(window [n], twiddle real [n/4], twiddle imaginary [n/4]) as float32
    tensors on ``device``; cached per arguments and device."""
    win, tw = _tables(n, window)
    parts = (win, np.ascontiguousarray(tw.real), np.ascontiguousarray(tw.imag))
    return tuple(torch.from_numpy(a).to(device) for a in parts)


def _rev(t):
    return torch.flip(t, (-1,))


def forward(samples, n: int = LONG_N, window: str = "vorbis"):
    """Forward MDCT: [..., n] samples -> [..., n/2] coefficients, on the
    tensor's device.

    Vectorized restatement of the FFmpeg-style fold in mdct.rs:166-226.
    """
    win, wr, wi = tables_to_device(n, window, samples.device)
    n2, n4 = n // 2, n // 4
    n3 = 3 * n4
    x = samples * win

    # First butterfly (z[0:n8]):
    #   re = -x[2i+3n/4] - x[3n/4-1-2i], im = -x[n/4+2i] + x[n/4-1-2i]
    re_a = -x[..., n3::2] - _rev(x[..., n2 + 1 : n3 : 2])
    im_a = -x[..., n4:n2:2] + _rev(x[..., 1:n4:2])
    # Second butterfly (z[n8:n4]):
    #   re = x[2i] - x[n/2-1-2i], im = -x[n/2+2i] - x[n-1-2i]
    re_b = x[..., 0:n4:2] - _rev(x[..., n4 + 1 : n2 : 2])
    im_b = -x[..., n2:n3:2] - _rev(x[..., n3 + 1 :: 2])

    re = torch.cat([re_a, re_b], dim=-1)
    im = torch.cat([im_a, im_b], dim=-1)
    del x, re_a, im_a, re_b, im_b
    z = torch.complex(-re * wr - im * wi, re * wi - im * wr)
    del re, im

    zf = torch.fft.fft(z, dim=-1)
    del z
    zr, zi = zf.real, zf.imag

    r = -(zr * wr + zi * wi)
    s = -zr * wi + zi * wr
    out = torch.stack([r, _rev(s)], dim=-1)
    return out.reshape(*out.shape[:-2], n2)


def inverse(spec, n: int = LONG_N, window: str = "vorbis"):
    """Inverse MDCT: [..., n/2] coefficients -> [..., n] windowed+scaled
    samples ready for 50%-overlap-add (mdct.rs:231-291, Symphonia algorithm).
    """
    win, wr, wi = tables_to_device(n, window, spec.device)
    n2, n8 = n // 2, n // 8

    even = spec[..., 0::2]
    odd = -_rev(spec[..., 1::2])  # spec[n2-1], spec[n2-3], ..., spec[1]
    z = torch.complex(odd * wi - even * wr, odd * wr + even * wi)

    zf = torch.fft.fft(z, dim=-1)
    del z
    zr, zi = zf.real, zf.imag

    vr = wr * zr + wi * zi
    vi = wi * zr - wr * zi
    del zf

    vr1, vr2 = vr[..., :n8], vr[..., n8:]
    vi1, vi2 = vi[..., :n8], vi[..., n8:]

    def interleave(a, b):
        return torch.stack([a, b], dim=-1).flatten(-2)

    q1 = interleave(-vr2, -_rev(vi1))
    q2 = interleave(vi1, _rev(vr2))
    q3 = interleave(vi2, _rev(vr1))
    q4 = interleave(vr1, _rev(vi2))
    out = torch.cat([q1, q2, q3, q4], dim=-1)
    return out * (win * (2.0 / n2))  # a power of two: exact in float32


def overlap_add(blocks):
    """Stateless 50% overlap-add over the block axis.

    blocks: [..., T, n] IMDCT outputs (already windowed+scaled).
    Returns [..., T, n/2] stream segments: segment t = blocks[t, :n/2] +
    blocks[t-1, n/2:], with zeros before block 0: the stateful per-block
    overlap buffer of mdct.rs:437-468 unrolled over the batch.
    """
    n2 = blocks.shape[-1] // 2
    out = blocks[..., :n2].clone()
    out[..., 1:, :] += blocks[..., :-1, n2:]
    return out


def mdct_oracle(samples: np.ndarray, n: int, window: str = "vorbis") -> np.ndarray:
    """O(N^2) direct MDCT for testing (mdct.rs):
    X[k] = sum_i x[i] w[i] cos(pi/n2 (i + 0.5 + n2/2) (k + 0.5)), n2 = n/2.
    """
    win = _WINDOWS[window](n).astype(np.float64)
    n2 = n // 2
    x = samples.astype(np.float64) * win
    nn = np.arange(n)[:, None]
    kk = np.arange(n2)[None, :]
    basis = np.cos(np.pi / n2 * (nn + 0.5 + n2 / 2.0) * (kk + 0.5))
    return (x[..., None, :] @ basis).squeeze(-2) if samples.ndim > 1 else x @ basis
