"""flo_torch's LPC reconstruction and integer helpers against flo_tpu's.

The same seeded numpy inputs go through the port's plain PyTorch recurrence
and through each of the reference's three formulations: the lax.scan, the
Pallas kernel in interpret mode and the numpy oracle. Tolerance: exact
(lossless decode is bit-exact). The CUDA kernel itself runs only on the card
(chip_smoke.py compares it with the plain version there); here the tests pin
that CPU tensors never reach it.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flo_tpu.ops import intmath as tpu_intmath
from flo_tpu.ops import lpc as tpu_lpc
from flo_tpu.ops.pallas_lpc import S_TILE, reconstruct_pallas
from flo_torch.ops import _build, cuda_lpc, intmath, lpc
from tests.test_pallas_lpc import _mixed_lanes

INT32_MIN, INT32_MAX = -(1 << 31), (1 << 31) - 1


def _full_range_lanes(seed, L=6, S=200):
    """Lanes in int32-wrap territory: full-range residuals, coefficients of
    +-(2**31 - 1) (sums of products that overflow int64), and warm-up orders
    beyond the 12 taps."""
    rng = np.random.default_rng(seed)
    residuals = rng.integers(INT32_MIN, INT32_MAX, (L, S), endpoint=True).astype(np.int32)
    coeffs = np.zeros((L, tpu_lpc.MAX_ORDER), np.int32)
    shifts = np.zeros(L, np.int32)
    orders = np.zeros(L, np.int32)
    is_fixed = np.zeros(L, bool)
    for l in range(L):
        coeffs[l] = rng.choice([-INT32_MAX, INT32_MAX], tpu_lpc.MAX_ORDER)
        shifts[l] = l * 3 % 16
        orders[l] = 12
    orders[1] = 17  # LPC warm-up longer than the taps
    coeffs[2] = tpu_lpc._FIXED_COEFFS[4]
    orders[2], is_fixed[2] = 4, True
    orders[3], is_fixed[3] = 9, True  # fixed ramp held past FIXED[4]
    return residuals, coeffs, shifts, orders, is_fixed


_CASES = {
    "mixed-7x300": lambda: _mixed_lanes(0, 7, 300),
    "mixed-20x1500": lambda: _mixed_lanes(1, 20, 1500),
    "time-tile-boundary": lambda: _mixed_lanes(3, 5, S_TILE + 37),
    "full-range-wrap": lambda: _full_range_lanes(4),
}


def _jax_scan(*args):
    return np.asarray(tpu_lpc.reconstruct(*map(jnp.asarray, args)))


def _pallas_interpret(*args):
    return np.asarray(reconstruct_pallas(*map(jnp.asarray, args), interpret=True))


_ORACLES = {
    "lax-scan": _jax_scan,
    "pallas-interpret": _pallas_interpret,
    "numpy-host": tpu_lpc.reconstruct_host,
}


def _plain(args):
    return lpc.reconstruct(*map(torch.from_numpy, args)).numpy()


@pytest.mark.parametrize("oracle", sorted(_ORACLES))
@pytest.mark.parametrize("case", sorted(_CASES))
def test_plain_reconstruct_matches_reference(case, oracle):
    args = _CASES[case]()
    got = _plain(args)
    assert got.dtype == np.int32 and got.shape == args[0].shape
    np.testing.assert_array_equal(got, _ORACLES[oracle](*args))


def test_constants_match_reference():
    assert lpc.MAX_ORDER == tpu_lpc.MAX_ORDER
    np.testing.assert_array_equal(lpc._FIXED_COEFFS, tpu_lpc._FIXED_COEFFS)


@pytest.mark.parametrize("L,S", [(0, 5), (3, 0)])
def test_plain_reconstruct_empty(L, S):
    z = np.zeros((L, S), np.int32)
    out = lpc.reconstruct(
        torch.from_numpy(z), torch.zeros((L, 12), dtype=torch.int32),
        torch.zeros(L, dtype=torch.int32), torch.zeros(L, dtype=torch.int32),
        torch.zeros(L, dtype=torch.bool),
    )
    assert out.shape == (L, S) and out.dtype == torch.int32


def test_div2_trunc_matches_reference():
    x = np.array([INT32_MIN, -3, -1, 0, 1, 3, INT32_MAX], np.int32)
    want = np.asarray(tpu_intmath.div2_trunc(jnp.asarray(x)))
    got = intmath.div2_trunc(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0] == 1 << 30  # the reference's wrapping negation, kept


def test_reconstruct_best_on_cpu_uses_plain_version():
    args = _mixed_lanes(5, 9, 64)
    before = cuda_lpc.LAUNCHES
    got = lpc.reconstruct_best(*map(torch.from_numpy, args)).numpy()
    assert cuda_lpc.LAUNCHES == before == 0
    np.testing.assert_array_equal(got, tpu_lpc.reconstruct_host(*args))


def test_reconstruct_cuda_rejects_cpu_tensors():
    args = [torch.from_numpy(a) for a in _mixed_lanes(6, 4, 32)]
    with pytest.raises(ValueError, match="CUDA"):
        cuda_lpc.reconstruct_cuda(*args)
    assert cuda_lpc.LAUNCHES == 0


def test_build_raises_without_nvcc(monkeypatch):
    from torch.utils import cpp_extension

    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(cpp_extension, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()


def test_build_library_is_keyed_by_source():
    names = [p.stem for p in _build.sources()]
    assert "lpc_reconstruct" in names
    path = _build.library_path("lpc_reconstruct")
    assert path.parent == _build.BUILD_DIR
    assert path == _build.library_path("lpc_reconstruct")
    assert path.name.startswith("liblpc_reconstruct-") and path.suffix == ".so"
