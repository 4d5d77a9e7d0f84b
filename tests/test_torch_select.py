"""flo_torch's candidate search and its analysis against flo_tpu's, on the CPU.

Seeded numpy inputs go to both packages. Tolerances: exact everywhere,
except the float32 device analysis, where the summation order differs
between PyTorch and XLA: the autocorrelation agrees within 1e-5 of lag 0,
and the float32 Levinson-Durbin, given the same autocorrelation, gives equal
shifts and valid flags and quantized coefficients within +-1.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.signal import lfilter

from flo_tpu.lossless import encoder as tpu_encoder
from flo_tpu.ops import intmath as tpu_intmath
from flo_tpu.ops import lpc as tpu_lpc
from flo_tpu.ops import select as tpu_select
from flo_torch import native
from flo_torch.lossless import encoder
from flo_torch.ops import cuda_select, intmath, lpc, select

KIND_CODE = {"raw": 0, "fixed": 1, "lpc": 2}


def _lanes(seed, L, S):
    """Lanes of five kinds (a tone with noise, loud noise, a near-constant
    signal, a square wave at the int16 rails, a random walk to +-60000 as a
    mid channel reaches) with ragged lengths, including 0 and 5."""
    rng = np.random.default_rng(seed)
    t = np.arange(S)
    lanes = np.zeros((L, S), np.int32)
    for l in range(L):
        kind = l % 5
        if kind == 0:
            x = 12000 * np.sin(2 * np.pi * (50 + 13 * l) * t / 8000) + rng.normal(0, 30, S)
        elif kind == 1:
            x = rng.normal(0, 8000, S)
        elif kind == 2:
            x = rng.integers(-2, 3, S)
        elif kind == 3:
            x = 30000 * np.sign(np.sin(t / 7.0))
        else:
            x = np.cumsum(rng.normal(0, 200, S)).clip(-60000, 60000)
        lanes[l] = np.asarray(x).astype(np.int32)
    nvalid = rng.integers(0, S + 1, L).astype(np.int32)
    nvalid[:3] = [S, 0, 5]
    return lanes, nvalid


def _search_inputs(level, L=25, S=900, seed=0):
    lanes, nvalid = _lanes(seed, L, S)
    kinds, orders, max_order = encoder._candidate_plan(level)
    _, tables = encoder.host_analysis(lanes, nvalid.astype(np.int64), 1, kinds, orders)
    return lanes, nvalid, tables, kinds, max_order


def test_predict_shift_taps_matches_reference():
    rng = np.random.default_rng(1)
    L, S = 16, 300
    samples = rng.integers(-(1 << 17), 1 << 17, (L, S)).astype(np.int32)
    coeffs = rng.integers(-(1 << 15), 1 << 15, (L, 12)).astype(np.int32)
    coeffs[0] = (1 << 31) - 1  # the largest coefficient the stream holds
    coeffs[1] = -(1 << 31)
    shifts = rng.integers(0, 16, (L, 1)).astype(np.int32)
    want = np.asarray(tpu_intmath.predict_shift_taps(samples, coeffs, shifts))
    got = intmath.predict_shift_taps(*(torch.from_numpy(a) for a in (samples, coeffs, shifts)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _mixed_candidates(seed, L, S):
    """One candidate per lane: LPC of random order and shift, fixed 0-4,
    warm-ups longer than the lane, ragged lengths."""
    rng = np.random.default_rng(seed)
    lanes, nvalid = _lanes(seed, L, S)
    coeffs = np.zeros((L, 12), np.int32)
    shifts = np.zeros(L, np.int32)
    orders = np.zeros(L, np.int32)
    is_fixed = np.zeros(L, bool)
    for l in range(L):
        if l % 2:
            o = int(rng.integers(0, 5))
            coeffs[l] = lpc._FIXED_COEFFS[o]
            orders[l], is_fixed[l] = o, True
        else:
            o = int(rng.integers(1, 13))
            coeffs[l, :o] = rng.integers(-(1 << 14), 1 << 14, o)
            shifts[l], orders[l] = rng.integers(0, 16), o
    nvalid[3] = 2  # shorter than its warm-up
    return lanes, nvalid, coeffs, shifts, orders, is_fixed


def test_residuals_one_and_candidate_size_match_reference():
    args = _mixed_candidates(2, 30, 700)
    want_r = np.asarray(tpu_select.residuals_one(*(jnp.asarray(a) for a in args)))
    got_r = select.residuals_one(*(torch.from_numpy(a) for a in args))
    np.testing.assert_array_equal(got_r.numpy(), want_r)
    nvalid = args[1]
    want = [np.asarray(x) for x in tpu_select.candidate_size(jnp.asarray(want_r), jnp.asarray(nvalid))]
    got = select.candidate_size(got_r, torch.from_numpy(nvalid))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_lanes_from_pcm16_matches_reference():
    rng = np.random.default_rng(3)
    pcm = rng.integers(-(1 << 15), 1 << 15, (6, 2, 50)).astype(np.int16)
    ms = np.array([True, False, True, True, False, False])
    want = np.asarray(tpu_select._lanes_from_pcm16(jnp.asarray(pcm), jnp.asarray(ms)))
    got = select._lanes_from_pcm16(torch.from_numpy(pcm), torch.from_numpy(ms))
    np.testing.assert_array_equal(got.numpy(), want)


def test_autocorr_and_levinson_all_orders_match_reference():
    lanes, nvalid = _lanes(4, 20, 800)
    ac = encoder._autocorr_int_exact(lanes, nvalid, 12)
    np.testing.assert_array_equal(ac, tpu_encoder._autocorr_int_exact(lanes, nvalid, 12))
    for g, w in zip(lpc.levinson_durbin_all_orders(ac, 12),
                    tpu_lpc.levinson_durbin_all_orders(ac, 12)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_autocorrelation_device_within_float32_order():
    lanes, nvalid = _lanes(5, 20, 800)
    want = np.asarray(tpu_lpc.autocorrelation_device(jnp.asarray(lanes), jnp.asarray(nvalid), 12))
    got = lpc.autocorrelation_device(torch.from_numpy(lanes), torch.from_numpy(nvalid), 12)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert (np.abs(got.numpy() - want) <= 1e-5 * want[:, :1]).all()


def test_device_analysis_sums_are_exact_and_batch_free():
    """The device analysis's sums are the exact integer sums rounded once to
    float32, so a lane's values (and a frame's mid/side flag) are the same
    whatever batch it is in: a sharded encode gives the unsharded bytes."""
    lanes, nvalid = _lanes(7, 20, 800)
    got = lpc.autocorrelation_device(torch.from_numpy(lanes), torch.from_numpy(nvalid), 12)
    exact = encoder._autocorr_int_exact(lanes, nvalid.astype(np.int64), 12)
    np.testing.assert_array_equal(got.numpy(), exact.astype(np.float32))
    halves = [lpc.autocorrelation_device(torch.from_numpy(lanes[i : i + 10]),
                                         torch.from_numpy(nvalid[i : i + 10]), 12)
              for i in (0, 10)]
    assert torch.equal(torch.cat(halves), got)
    pcm = torch.from_numpy(lanes.reshape(10, 2, 800))
    nv = torch.from_numpy(nvalid[::2].copy())
    whole = select.device_analysis(pcm, nv, ("raw", "fixed", "lpc"), (0, 1, 8))
    parts = [select.device_analysis(pcm[i : i + 5], nv[i : i + 5], ("raw", "fixed", "lpc"),
                                    (0, 1, 8)) for i in (0, 5)]
    assert torch.equal(torch.cat([p[-1] for p in parts]), whole[-1])  # mid/side flags
    for t, *ps in zip(whole[2], *(p[2] for p in parts)):
        assert torch.equal(torch.cat(ps), t)


def test_levinson_device_within_one_step():
    """On well-conditioned lanes (second-order autoregressive noise): a pure
    tone's recursion is near-singular and amplifies the float32 rounding
    differences between XLA and PyTorch far past one step."""
    rng = np.random.default_rng(6)
    L, S = 24, 800
    e = rng.normal(0, 3000, (L, S))
    lanes = np.stack(
        [lfilter([1.0], [1.0, -0.9 * np.cos(0.3 * l), 0.3], e[l]) for l in range(L)]
    ).astype(np.int32)
    nvalid = rng.integers(100, S + 1, L).astype(np.int32)
    ac = np.asarray(tpu_lpc.autocorrelation_device(jnp.asarray(lanes), jnp.asarray(nvalid), 12))
    want = [np.asarray(x) for x in tpu_lpc.levinson_device(jnp.asarray(ac), 12)]
    got = [x.numpy() for x in lpc.levinson_device(torch.from_numpy(ac.copy()), 12)]
    np.testing.assert_array_equal(got[1], want[1])  # shifts
    np.testing.assert_array_equal(got[2], want[2])  # valid
    assert np.abs(got[0].astype(np.int64) - want[0]).max() <= 1


@pytest.mark.parametrize("level", [0, 5, 8])
def test_plain_search_matches_cpp(level):
    lanes, nvalid, tables, kinds, max_order = _search_inputs(level)
    is_lpc = tuple(kd == "lpc" for kd in kinds)
    sel, k, size, res, win_c, win_s = select.encode_select_step(
        torch.from_numpy(lanes), torch.from_numpy(nvalid), *tables, is_lpc
    )
    kind, order, ck, ccoef, cshift, csize, cres = native.lossless_search_batch(
        lanes, nvalid.astype(np.int64), max_order, any(is_lpc)
    )
    sel = sel.numpy()
    np.testing.assert_array_equal([KIND_CODE[kinds[s]] for s in sel], kind)
    np.testing.assert_array_equal(k.numpy(), ck)
    np.testing.assert_array_equal(size.numpy(), csize)
    np.testing.assert_array_equal(res.numpy(), cres)
    lpc_won = np.array([kinds[s] == "lpc" for s in sel], bool)
    np.testing.assert_array_equal(win_c.numpy()[lpc_won], ccoef[lpc_won])
    np.testing.assert_array_equal(win_s.numpy()[lpc_won], cshift[lpc_won])
    assert len(set(kind.tolist())) == (2 if level == 0 else 3)  # every kind wins somewhere
    assert cuda_select.LAUNCHES == 0


@pytest.mark.parametrize("level", [5, 8])
def test_plain_search_against_reference_select_step(level):
    """Every lane equals flo_tpu's encode_select_step, or, where its float32
    steering picked another candidate, the port's exact size is smaller."""
    lanes, nvalid, tables, kinds, _ = _search_inputs(level, seed=level)
    is_lpc = tuple(kd == "lpc" for kd in kinds)
    tabs = [t.numpy() for t in tables]
    want = [np.asarray(x) for x in tpu_select.encode_select_step(lanes, nvalid, *tabs, is_lpc)]
    got = [x.numpy() for x in select.encode_select_step(
        torch.from_numpy(lanes), torch.from_numpy(nvalid), *tables, is_lpc)]
    same = got[0] == want[0]
    assert (got[2][~same] < want[2][~same]).all()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[same], w[same])


def test_encode_select_cuda_rejects_cpu_tensors():
    lanes, nvalid, tables, kinds, _ = _search_inputs(5, L=4, S=64)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_select.encode_select_cuda(
            torch.from_numpy(lanes), torch.from_numpy(nvalid), *tables,
            tuple(kd == "lpc" for kd in kinds),
        )
    assert cuda_select.LAUNCHES == 0


# Host-side arithmetic of the kernel's launch (ops/cuda_select.py): the plan
# of a candidate list, which lanes follow it, and the tiles and shared memory
# of a CTA.

_PLAN_BY_LEVEL = {0: (1, 0), 1: (3, 0), 2: (5, 0), 3: (5, 0), 4: (5, 2), 5: (5, 4),
                  6: (5, 4), 7: (5, 6), 8: (5, 8), 9: (5, 8)}


@pytest.mark.parametrize("level", range(10))
def test_every_level_has_a_planned_instantiation(level):
    kinds, _, _ = encoder._candidate_plan(level)
    plan = cuda_select.plan_index(tuple(kd == "lpc" for kd in kinds))
    assert cuda_select.PLANS[plan] == _PLAN_BY_LEVEL[level]


@pytest.mark.parametrize("is_lpc", [
    (False, True), (False, False, False, False, False, False, True),
    (False, False, True, False), (False,) * 7, (False,) * 6 + (True,) * 9,
])
def test_other_candidate_lists_take_the_general_kernel(is_lpc):
    assert cuda_select.plan_index(is_lpc) == -1


@pytest.mark.parametrize("level", [0, 1, 2, 4, 5, 7, 8])
def test_host_tables_follow_their_plan(level):
    """The analysis's tables are the plan's on every lane (so the planned
    path runs them), and a lane whose table is not is told apart."""
    lanes, nvalid, tables, kinds, _ = _search_inputs(level, L=30, S=500, seed=level)
    plan = cuda_select.plan_index(tuple(kd == "lpc" for kd in kinds))
    coeffs, shifts, orders, fixed, _ = (t.clone() for t in tables)
    assert cuda_select.follows_plan(coeffs, shifts, orders, fixed, plan).all()
    shifts[3, 1] = 2   # a fixed candidate with a shift
    coeffs[5, 1, 11] = 7  # a tap in FIXED[0]'s row
    if len(kinds) > 6:
        coeffs[6, 6, 5] = 7  # a tap past LPC order 5
    orders[7, 1] = 4
    ok = cuda_select.follows_plan(coeffs, shifts, orders, fixed, plan)
    bad = (3, 5, 7, 6) if len(kinds) > 6 else (3, 5, 7)
    assert ok.tolist() == [lane not in bad for lane in range(30)]


def test_select_tiles_and_shared_memory_for_every_length():
    """Every n from 1 to 192,000: the tiles cover the lane with no tile to
    spare, the padded row holds whole 16-byte chunks, and a CTA's shared
    memory (independent of n) fits the 227 KB a CTA may have."""
    T = cuda_select.tile()
    assert T % 4 == 0
    for n in range(1, 192_001):
        k = cuda_select.tiles(n)
        assert (k - 1) * T < n <= k * T
        row = cuda_select.padded_length(n)
        assert row % 4 == 0 and n <= row < n + 4
    assert cuda_select.smem_bytes() <= cuda_select.SMEM_LIMIT


def test_shipped_select_design_leaves_room_for_four_ctas_an_sm():
    assert 4 * (cuda_select.smem_bytes() + 1024) <= 228 * 1024
