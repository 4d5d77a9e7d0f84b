"""flo_torch's MDCT against flo_tpu's, on the CPU.

Seeded numpy inputs go through both packages. Tolerances: the windows and
the twiddle table are the same numpy code, bit-equal; ``forward`` and
``inverse`` call two different float32 FFTs (XLA:CPU's and PyTorch's), so
they are held to 1e-5 of the block's largest magnitude, against flo_tpu and
against the O(N^2) float64 oracle; ``overlap_add`` is one float32 add a
sample, bit-equal on equal input.
"""

import numpy as np
import pytest
import torch

from flo_torch.ops import mdct
from flo_tpu.ops import mdct as tpu_mdct

SIZES = [2048, 256]
WINDOWS = ["sine", "vorbis", "kbd"]


def _blocks(seed, n, shape=(2, 5)):
    return np.random.default_rng(seed).standard_normal((*shape, n)).astype(np.float32)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("window", WINDOWS)
def test_tables_bit_equal(n, window):
    win, tw = mdct._tables(n, window)
    ref_win, ref_tw = tpu_mdct._tables(n, window)
    assert win.dtype == np.float32 and tw.dtype == np.complex64
    assert np.array_equal(win, ref_win) and np.array_equal(tw, ref_tw)
    d_win, d_wr, d_wi = mdct.tables_to_device(n, window, "cpu")
    assert d_win.dtype == d_wr.dtype == d_wi.dtype == torch.float32
    assert np.array_equal(d_win.numpy(), ref_win)
    assert np.array_equal(d_wr.numpy(), ref_tw.real) and np.array_equal(d_wi.numpy(), ref_tw.imag)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("window", WINDOWS)
def test_forward_matches_reference_and_oracle(n, window):
    x = _blocks(n, n)
    got = mdct.forward(torch.from_numpy(x), n, window).numpy()
    ref = np.asarray(tpu_mdct.forward(x, n, window))
    oracle = mdct.mdct_oracle(x, n, window)
    assert got.shape == ref.shape == (2, 5, n // 2) and got.dtype == np.float32
    peak = np.abs(oracle).max()
    assert np.abs(got - ref).max() < 1e-5 * peak
    assert np.abs(got - oracle).max() < 1e-5 * peak
    assert np.array_equal(oracle, tpu_mdct.mdct_oracle(x, n, window))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("window", WINDOWS)
def test_inverse_matches_reference(n, window):
    spec = _blocks(n + 1, n // 2)
    got = mdct.inverse(torch.from_numpy(spec), n, window).numpy()
    ref = np.asarray(tpu_mdct.inverse(spec, n, window))
    assert got.shape == ref.shape == (2, 5, n) and got.dtype == np.float32
    assert np.abs(got - ref).max() < 1e-5 * np.abs(ref).max()


def test_inverse_picks_the_reversed_odd_bins():
    """Only bin n2 - 1 set: the reference's reversed strided slice puts it
    first; a wrong pick of the odd bins would move the impulse."""
    n = 256
    spec = np.zeros((1, n // 2), np.float32)
    spec[0, -1] = 1.0
    got = mdct.inverse(torch.from_numpy(spec), n).numpy()
    ref = np.asarray(tpu_mdct.inverse(spec, n))
    assert np.abs(got - ref).max() < 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("shape", [(3, 4, 256), (2, 2, 1, 2048), (1, 256)])
def test_overlap_add_bit_equal(shape):
    blocks = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    got = mdct.overlap_add(torch.from_numpy(blocks)).numpy()
    assert np.array_equal(got, np.asarray(tpu_mdct.overlap_add(blocks)))


@pytest.mark.parametrize("n", SIZES)
def test_perfect_reconstruction(n):
    """tests/test_lossy.py::TestMdct::test_perfect_reconstruction on the
    port: forward, inverse and overlap-add give the signal back."""
    hop = n // 2
    sig = (0.5 * np.random.default_rng(1).standard_normal((1, 8 * hop))).astype(np.float32)
    blocks = torch.from_numpy(sig).unfold(-1, n, hop)
    segs = mdct.overlap_add(mdct.inverse(mdct.forward(blocks, n), n))
    out = segs.reshape(-1).numpy()
    assert np.abs(out[hop : 6 * hop] - sig[0, hop : 6 * hop]).max() < 1e-5


def test_windows_invariants():
    for name in WINDOWS:
        for n in SIZES:
            w = mdct._WINDOWS[name](n)
            assert w.shape == (n,) and np.all(w >= 0) and np.all(w <= 1.0 + 1e-6)
            np.testing.assert_allclose(w, w[::-1], atol=2e-6)
