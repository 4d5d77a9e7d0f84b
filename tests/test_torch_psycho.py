"""flo_torch's psychoacoustic model against flo_tpu's, on the CPU.

Tolerances: the tables are the same numpy code, bit-equal. The plain
temporal-masking scan is one float32 multiply and one maximum a step, the
same two operations as flo_tpu's ``lax.scan`` step: bit-equal. ``smr`` sums
the band energies in another order than XLA and calls another ``log10``, so
it is held to 1e-3 dB, wherever ``|c|`` is not within 1% of the 1e-10 cut
(there one ulp decides between a level and -100 dB). Every test ends with
the kernel's launch counter at 0: CPU tensors take the plain loop.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flo_torch.ops import cuda_psycho, psycho
from flo_tpu.ops import psycho as tpu_psycho

RATES = [8000, 22050, 44100, 48000, 96000]
SIZES = [2048, 256]


@pytest.fixture(autouse=True)
def _no_kernel_launch():
    yield
    assert cuda_psycho.LAUNCHES == 0


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("rate", RATES)
def test_tables_bit_equal(rate, n):
    ours = psycho.model_tables(rate, n)
    theirs = tpu_psycho.model_tables(rate, n)
    on_device = psycho.tables_to_device(rate, n, "cpu")
    for a, b, d in zip(ours, theirs, on_device):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b, equal_nan=True)
        assert np.array_equal(d.numpy(), b, equal_nan=True)
    assert on_device[1].dtype == torch.int64
    assert all(t.dtype == torch.float32 for i, t in enumerate(on_device) if i != 1)
    # The band map is monotone, so a band is the run of bins between its bounds.
    bounds = psycho.band_bounds(rate, n)
    band = theirs[1]
    assert len(bounds) == 26 and bounds[0] == 0 and bounds[-1] == n // 2
    for b in range(25):
        assert np.array_equal(np.flatnonzero(band == b), np.arange(bounds[b], bounds[b + 1]))


def test_constants_equal():
    assert psycho.NUM_BARK_BANDS == tpu_psycho.NUM_BARK_BANDS == cuda_psycho.BANDS
    assert np.array_equal(psycho.BARK_BAND_EDGES, tpu_psycho.BARK_BAND_EDGES)
    for name in ("MASKING_OFFSET_DB", "TEMPORAL_DECAY", "HEADROOM_DB"):
        assert getattr(psycho, name) == getattr(tpu_psycho, name)


def _masking(seed, shape):
    """dB values in [-120, 100] with runs of -100 (silent bands) and a few
    exact zeros."""
    rng = np.random.default_rng(seed)
    m = rng.uniform(-120.0, 100.0, shape).astype(np.float32)
    T = shape[-2]
    for _ in range(6):
        lo = int(rng.integers(0, max(T - 1, 1)))
        m[..., lo : lo + int(rng.integers(1, 9)), rng.integers(0, 25)] = -100.0
    m[..., T // 2 :, 3] = -100.0
    m[..., ::7, 5] = 0.0
    return m


def _reference_scan(masking):
    """flo_tpu's scan (ops/psycho.py: the step inside ``smr``) on its own."""
    def step(prev, cur):
        thr = jnp.maximum(cur, prev * tpu_psycho.TEMPORAL_DECAY)
        return thr, thr

    m = jnp.moveaxis(jnp.asarray(masking), -2, 0)
    _, thr = jax.lax.scan(step, jnp.zeros_like(m[0]), m)
    return np.asarray(jnp.moveaxis(thr, 0, -2))


@pytest.mark.parametrize("shape", [(2, 40, 25), (1, 1, 25), (3, 2, 7, 25), (2, 0, 25)])
def test_plain_scan_bit_equal_to_reference_scan(shape):
    m = _masking(len(shape), shape) if shape[-2] else np.zeros(shape, np.float32)
    got = psycho.temporal_mask(torch.from_numpy(m)).numpy()
    assert got.shape == m.shape and got.dtype == np.float32
    if shape[-2] == 0:
        return
    assert np.array_equal(got.view(np.int32), _reference_scan(m).view(np.int32))
    # And the float32 loop in numpy, step by step.
    prev = np.zeros(m.shape[:-2] + (25,), np.float32)
    for t in range(shape[-2]):
        prev = np.maximum(m[..., t, :], prev * np.float32(0.7))
        assert np.array_equal(got[..., t, :], prev)


def test_plain_scan_propagates_nan_and_inf():
    m = _masking(9, (2, 12, 25))
    m[0, 3, 4], m[1, 5, 6], m[1, 2, 7] = np.nan, np.inf, -np.inf
    got = psycho.temporal_mask_plain(torch.from_numpy(m)).numpy()
    ref = _reference_scan(m)
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    assert np.isnan(got[0, 3:, 4]).all() and not np.isnan(got[0, :3, 4]).any()
    assert np.isinf(got[1, 5:, 6]).all()
    assert np.array_equal(got[~np.isnan(got)], ref[~np.isnan(ref)])


def _coeffs(seed, shape):
    """MDCT-like coefficients: a decaying spectrum with tones, silent hops,
    a silent lane tail, and tiny values on both sides of the 1e-10 cut."""
    rng = np.random.default_rng(seed)
    n2 = shape[-1]
    c = rng.standard_normal(shape) * (20.0 / (1.0 + np.arange(n2) / 8.0))
    c[..., 3, :] = 0.0
    c[..., 5, n2 // 2 :] *= 1e-7
    c[..., 6, :] = rng.choice([3e-11, 4e-10, -2e-12], n2)
    c[0, ..., 10:, :] = 0.0
    return c.astype(np.float32)


@pytest.mark.parametrize("rate,n", [(44100, 2048), (8000, 2048), (48000, 256), (96000, 2048)])
def test_smr_matches_reference(rate, n):
    c = _coeffs(rate, (2, 16, n // 2))
    got = psycho.smr(torch.from_numpy(c), rate, n).numpy()
    ref = np.asarray(tpu_psycho.smr(c, rate, n))
    assert got.shape == ref.shape == c.shape and got.dtype == np.float32
    clear = np.abs(np.abs(c) / 1e-10 - 1.0) > 0.01
    assert clear.mean() > 0.99
    assert np.abs(got - ref)[clear].max() < 1e-3


def test_smr_tone_peaks_in_tone_band():
    """tests/test_lossy.py::TestPsycho::test_smr_tone_peaks_in_tone_band on
    the port."""
    from flo_torch.ops import mdct

    rate = 44100
    block = np.zeros((1, 1, 2048), np.float32)
    block[0, 0] = 0.5 * np.sin(2 * np.pi * 1000 * np.arange(2048) / rate)
    coeffs = mdct.forward(torch.from_numpy(block))
    s = psycho.smr(coeffs, rate, 2048).numpy()
    assert s.shape == (1, 1, 1024)
    assert s[0, 0, int(coeffs[0, 0].abs().argmax())] > 0


def test_cuda_wrapper_refuses_what_the_kernel_does_not_take():
    """The wrapper raises on a CPU tensor and on a wrong shape, before any
    build: it never gives way to the plain loop."""
    with pytest.raises(ValueError):
        cuda_psycho.temporal_mask_cuda(torch.zeros(2, 3, 25))
    with pytest.raises(ValueError):
        cuda_psycho.temporal_mask_cuda(torch.zeros(3, 25))


_SCAN_CASES = cuda_psycho.scan_cases()


@pytest.mark.parametrize("index", range(len(_SCAN_CASES)), ids=[name for name, _ in _SCAN_CASES])
def test_segmented_scan_model_equals_plain_loop(index):
    """The kernel's algorithm (``cuda_psycho.segmented_model``: facts, two
    chains over a window until they meet, the chain from the lane's start
    where they do not) gives the plain loop's bits on every case the card is
    held to. The kernel itself runs only on the card; this holds its
    arithmetic. Zero signs are set aside here and only here: PyTorch's CPU
    ``maximum`` returns either zero of a -0 and a +0 depending on whether its
    vector loop or its tail handles the element, so the plain loop on the CPU
    does not agree with itself from band to band (on the card both sides
    give +0, and the smoke compares the signs too)."""
    name, m = _SCAN_CASES[index]
    want = psycho.temporal_mask_plain(torch.from_numpy(m)).numpy()
    got = cuda_psycho.segmented_model(m)
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    zero = ok & (want == 0)
    assert np.array_equal(got[zero], want[zero])  # a zero where the loop has one
    assert not np.signbit(got[zero]).any()  # and the card's sign of it: thr >= +0
    rest = ok & ~zero
    assert np.array_equal(got.view(np.int32)[rest], want.view(np.int32)[rest])


def test_scan_cases_reach_every_branch():
    """The cases cover hop counts around a fact block and a chunk, the four
    lane counts, and inputs whose chains meet in the near window, in the warm
    window, and not at all."""
    hops = {m.shape[1] for _, m in _SCAN_CASES}
    lanes = {m.shape[0] for _, m in _SCAN_CASES}
    C, F = cuda_psycho.CHUNK, cuda_psycho.FACT_HOPS
    assert {1, F - 1, F, F + 1, C - 1, C, C + 1, 2585, 5000} <= hops
    assert {1, 8, 16, 33} <= lanes
    assert cuda_psycho.NEAR % F == 0 and cuda_psycho.WARM % F == 0 and C % F == 0
    names = " ".join(name for name, _ in _SCAN_CASES)
    for word in ("NaN in first", "NaN in a middle", "NaN in the last", "+inf", "denormal",
                 "-0.0", "negative input only", "+96 dB"):
        assert word in names
