"""The frozen copies held to their originals: the rates and ``bound`` to
``chip_smoke.py``'s, the work formulas to its counts on cases whose lane
classes and orders coincide; and the content generator."""

import numpy as np
import pytest
import torch

import chip_smoke
from benchmark import frozen, harness
from flo_torch import batch
from flo_torch.lossless import encoder
from flo_torch.ops import blockspread, lpc, select


def test_rates_and_bound_are_chip_smoke():
    assert (frozen.HBM_BYTES_PER_S, frozen.INT_OPS_PER_S, frozen.F32_OPS_PER_S) == (
        chip_smoke.HBM_BYTES_PER_S, chip_smoke.INT_OPS_PER_S, chip_smoke.F32_OPS_PER_S)
    for args in ((1e9, 1e6), (1e3, 1e12), (5e8, 5e8, frozen.F32_OPS_PER_S)):
        assert frozen.bound(*args) == chip_smoke.bound(*args)


def test_lpc_work_is_chip_smoke():
    # Lanes whose class gives taps equal to the order: fixed cascade lanes
    # (orders 1-4, shift 0), LPC lanes of even order with a last tap, raw.
    S, rows = 300, []
    for o in (1, 2, 3, 4):
        rows.append((lpc._FIXED_COEFFS[o], 0, o, True))
    for o in (2, 6, 8, 12):
        c = np.zeros(12, np.int32)
        c[:o] = np.arange(1, o + 1)
        rows.append((c, 9, o, False))
    rows.append((np.zeros(12, np.int32), 0, 0, False))
    coeffs = torch.from_numpy(np.stack([r[0] for r in rows]).astype(np.int32))
    args = (torch.zeros((len(rows), S), dtype=torch.int32), coeffs,
            torch.tensor([r[1] for r in rows], dtype=torch.int32),
            torch.tensor([r[2] for r in rows], dtype=torch.int32),
            torch.tensor([r[3] for r in rows]))
    taps = [r[2] for r in rows]
    assert frozen.lpc_work([S] * len(rows), taps) == chip_smoke.lpc_work(args)


def _search_case(level: int):
    rng = np.random.default_rng(level)
    C, S = 2, 400
    nvalid = np.array([400, 400, 257], np.int64)
    lanes = (rng.standard_normal((len(nvalid) * C, S)) * 300).astype(np.int32)
    kinds, orders, _ = encoder._candidate_plan(level)
    _, tables = encoder.host_analysis(lanes, nvalid, C, kinds, orders)
    nv = torch.from_numpy(np.repeat(nvalid, C).astype(np.int32))
    args = (torch.from_numpy(lanes), nv, *tables)
    is_lpc = tuple(kd == "lpc" for kd in kinds)
    return args, select.encode_select_step(*args, is_lpc), is_lpc, int(nv.sum())


@pytest.mark.parametrize("level", [0, 2, 5, 9])
def test_select_work_is_chip_smoke(level):
    args, outs, is_lpc, valid = _search_case(level)
    L, S = args[0].shape
    plan = frozen.candidate_plan(level, frozen.MAX_ORDER_BY_LEVEL[level])
    assert plan[0] == is_lpc
    assert frozen.select_work(L, S, valid, *plan) == chip_smoke.select_work(args, outs, is_lpc)


def test_pack_work_is_chip_smoke():
    args, outs, _, _ = _search_case(5)
    sel, k, size, residuals = outs[:4]
    pargs = (residuals, k, args[1], sel == 0)
    payload, lane_bytes, _ = blockspread.pack_lanes_words(*pargs)
    L, S = residuals.shape
    assert frozen.pack_work(L, S, lane_bytes.numpy()) == chip_smoke.pack_work(pargs, payload.numel())


TRAFFIC = {"tracks_s": [1, 2, 3], "pool_batches": 2, "content_base_s": 1}
CFG = {"sample_rate": 8000, "channels": 2, "host_threads": 2}


def test_content_repeats_for_a_seed():
    a, b = harness.make_pool(CFG, TRAFFIC, 2**33 + 1), harness.make_pool(CFG, TRAFFIC, 2**33 + 1)
    assert all(np.array_equal(x, y) for p, q in zip(a, b) for x, y in zip(p, q))
    c = harness.make_pool(CFG, TRAFFIC, 7)
    assert not np.array_equal(a[0][0], c[0][0])


@pytest.mark.parametrize("seed", [0, 1, 2**31 + 11, -3])
def test_audio_seconds_do_not_depend_on_the_seed(seed):
    pool = harness.make_pool(CFG, TRAFFIC, seed)
    assert [[t.size for t in b] for b in pool] == [[s * 8000 * 2 for s in TRAFFIC["tracks_s"]]] * 2
    for batch in pool:
        for t in batch:
            assert t.dtype == np.float32
            k = t.astype(np.float64) * 32768
            assert np.array_equal(k, np.rint(k)) and np.abs(k).max() <= 32768


@pytest.mark.parametrize("config", ["cd_lossless_l5", "cd_lossy_high"])
def test_content_reaches_the_configurations_ratio(config):
    # Two 8 s tracks at the configuration's own rate, through the port on
    # the CPU: the ratio lies in the range the configuration states.
    cfg = harness.load("configs", config)
    pool = harness.make_pool(cfg, dict(TRAFFIC, tracks_s=[8, 8], pool_batches=1, content_base_s=8), 5)
    rate, C = cfg["sample_rate"], cfg["channels"]
    if cfg["mode"] == "lossless":
        datas = batch.encode_many_async(pool[0], rate, C, 16, cfg["level"], analyze=False,
                                        device="cpu").result()
    else:
        datas = batch.encode_lossy_many_async(pool[0], rate, C, quality=cfg["quality"],
                                              analyze=False, device="cpu").result()
    lo, hi = cfg["ratio_range"]
    harness.describe_bytes(cfg, pool, [datas])
    assert lo <= sum(t.size * 2 for t in pool[0]) / sum(map(len, datas)) <= hi
