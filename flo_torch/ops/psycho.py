"""Psychoacoustic model: Bark bands, ATH, spreading, temporal masking.

Behavioral mirror of libflo/src/lossy/psychoacoustic.rs, vectorized as in the
reference's ``ops/psycho.py``: per-bin constants (ATH, Bark band map) and the
25x25 spreading matrix are computed once per (sample_rate, fft_size) in
numpy; masking thresholds for a whole [..., T, n2] block batch are computed
with one one-hot matmul per reduction, and the temporal-masking carry over
the hop axis (psychoacoustic.rs:195-202; the reference's quirk of decaying
the previous *dB threshold* by 0.7 as if it were energy is kept for parity)
is a scan: the hand-written kernel ``csrc/temporal_mask.cu`` on a CUDA
tensor, the plain loop :func:`temporal_mask_plain` on a CPU tensor.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

NUM_BARK_BANDS = 25

BARK_BAND_EDGES = np.array(
    [
        0.0, 100.0, 200.0, 300.0, 400.0, 510.0, 630.0, 770.0, 920.0, 1080.0,
        1270.0, 1480.0, 1720.0, 2000.0, 2320.0, 2700.0, 3150.0, 3700.0, 4400.0,
        5300.0, 6400.0, 7700.0, 9500.0, 12000.0, 15500.0, 20500.0,
    ],
    dtype=np.float32,
)

MASKING_OFFSET_DB = -6.0
TEMPORAL_DECAY = 0.7
HEADROOM_DB = 10.0


def ath_db(freq: np.ndarray) -> np.ndarray:
    """Terhardt ATH in dB, clamped [-10, 96] (psychoacoustic.rs:90-104).

    Frequencies outside [20, 20000] Hz return 96 dB.
    """
    freq = np.asarray(freq, dtype=np.float32)
    f = freq / np.float32(1000.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        term1 = 3.64 * np.power(f, -0.8, dtype=np.float32)
    term2 = 6.5 * np.exp(-0.6 * (f - 3.3) ** 2, dtype=np.float32)
    term3 = 0.001 * f**4
    val = np.clip(term1 - term2 + term3, -10.0, 96.0)
    out_of_range = (freq < 20.0) | (freq > 20000.0)
    return np.where(out_of_range, np.float32(96.0), val).astype(np.float32)


def freq_to_bark_band(freq: np.ndarray) -> np.ndarray:
    """Bark band index per frequency (psychoacoustic.rs:114-121): first band
    whose upper edge exceeds the frequency, else the last band."""
    freq = np.asarray(freq, dtype=np.float32)
    idx = np.searchsorted(BARK_BAND_EDGES[1:], freq, side="right")
    return np.minimum(idx, NUM_BARK_BANDS - 1).astype(np.int32)


def freq_to_bark(freq: np.ndarray) -> np.ndarray:
    """Traunmueller bark value, clamped [0, 24] (psychoacoustic.rs:107-111)."""
    freq = np.asarray(freq, dtype=np.float32)
    return np.clip((26.81 * freq) / (1960.0 + freq) - 0.53, 0.0, 24.0).astype(np.float32)


def spreading_matrix_db() -> np.ndarray:
    """[masker j, target i] spreading attenuation in dB.

    Reproduces the reference's dB->linear->clamp->dB round trip
    (psychoacoustic.rs:125-147, 151-174): upper slope -25 dB/Bark; the lower
    slope's positive dB clamps to 0 dB (full masking downward, a reference
    quirk kept for parity).
    """
    j = np.arange(NUM_BARK_BANDS, dtype=np.float32)[:, None]
    i = np.arange(NUM_BARK_BANDS, dtype=np.float32)[None, :]
    delta = i - j
    spread_db = np.where(delta >= 0, -25.0 * delta, -10.0 * delta).astype(np.float32)
    linear = np.minimum(np.power(np.float32(10.0), spread_db / 10.0), 1.0).astype(np.float32)
    with np.errstate(divide="ignore"):
        return (10.0 * np.log10(linear)).astype(np.float32)


@lru_cache(maxsize=None)
@lru_cache(maxsize=None)
def model_tables(sample_rate: int, fft_size: int):
    """Per-bin constants for a model instance (psychoacoustic.rs:36-76).

    Returns (ath [n2], band [n2] int32, band_onehot [n2, 25] f32,
    inv_count [25] f32, spread_db [25, 25] f32) as host numpy arrays.
    """
    n2 = fft_size // 2
    freq = (np.arange(n2, dtype=np.float32) + 0.5) * (sample_rate / np.float32(fft_size))
    ath = ath_db(freq)
    band = freq_to_bark_band(freq)
    onehot = np.zeros((n2, NUM_BARK_BANDS), dtype=np.float32)
    onehot[np.arange(n2), band] = 1.0
    count = onehot.sum(axis=0)
    inv_count = np.where(count > 0, 1.0 / np.maximum(count, 1.0), 0.0).astype(np.float32)
    return ath, band, onehot, inv_count, spreading_matrix_db()


@lru_cache(maxsize=None)
def tables_to_device(sample_rate: int, fft_size: int, device):
    """:func:`model_tables` as tensors on ``device`` (``band`` as int64, an
    index), cached per arguments and device."""
    ath, band, onehot, inv_count, spread = model_tables(sample_rate, fft_size)
    parts = (ath, band.astype(np.int64), onehot, inv_count, spread)
    return tuple(torch.from_numpy(a).to(device) for a in parts)


@lru_cache(maxsize=None)
def band_bounds(sample_rate: int, fft_size: int) -> tuple:
    """The bins of band b are ``bounds[b]:bounds[b + 1]``: the band map is
    monotone, so each band is one run of bins (an empty one where the rate
    is too low to reach it)."""
    band = model_tables(sample_rate, fft_size)[1]
    return tuple(int(i) for i in np.searchsorted(band, np.arange(NUM_BARK_BANDS + 1)))


def temporal_mask_plain(masking):
    """Plain version of the temporal-masking scan: [..., T, 25] float32 ->
    thr[t] = max(masking[t], thr[t - 1] * 0.7), thr[-1] = 0, one step of two
    small ops a hop. NaN propagates, as ``torch.maximum`` has it."""
    out = torch.empty_like(masking)
    prev = torch.zeros_like(masking[..., 0, :]) if masking.shape[-2] else None
    for t in range(masking.shape[-2]):
        prev = torch.maximum(masking[..., t, :], prev * TEMPORAL_DECAY)
        out[..., t, :] = prev
    return out


def temporal_mask(masking):
    """The temporal-masking scan over the hop axis of [..., T, 25] float32:
    the CUDA kernel for a tensor on the card (it launches or raises), the
    plain loop for a tensor on the CPU. Both give the same bits."""
    if masking.device.type == "cuda":
        from .cuda_psycho import temporal_mask_cuda

        shape = masking.shape
        flat = masking.reshape(-1, shape[-2], shape[-1]).contiguous()
        return temporal_mask_cuda(flat).reshape(shape)
    return temporal_mask_plain(masking)


def smr(coeffs, sample_rate: int, fft_size: int):
    """Signal-to-mask ratio for batched MDCT blocks.

    coeffs: [..., T, n2] float32: T is the sequential hop axis (temporal
    masking carries across it, initial state 0 as in psychoacoustic.rs:73).
    Returns SMR [..., T, n2] (psychoacoustic.rs:218-235).
    """
    ath, band, onehot, inv_count, spread = tables_to_device(sample_rate, fft_size, coeffs.device)

    band_energy = (coeffs * coeffs) @ onehot  # [..., T, 25]; float32, never TF32
    band_mean = band_energy * inv_count
    band_db = torch.where(
        (inv_count > 0) & (band_energy > 1e-10),
        10.0 * torch.log10(band_mean.clamp_min(1e-30)),
        -100.0,
    )

    # Simultaneous masking: max over maskers j of band_db[j] + spread[j, i].
    masking = (band_db[..., :, None] + spread).amax(dim=-2) + MASKING_OFFSET_DB

    spread_thr = temporal_mask(masking)  # [..., T, 25]

    per_bin_thr = torch.maximum(spread_thr.index_select(-1, band), ath) - HEADROOM_DB

    mag = coeffs.abs()
    signal_db = torch.where(mag > 1e-10, 20.0 * torch.log10(mag.clamp_min(1e-30)), -100.0)
    return signal_db - per_bin_thr
