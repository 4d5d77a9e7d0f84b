"""``correct`` tells right from wrong: on the CPU, at a size a test run can
hold, a sound run of each cell comes out correct; the control (the reference
in bfloat16 in the program's place) comes out not correct; and a run with
the timed path broken underneath comes out not correct (or stops in set-up,
where its bytes leave the configuration's ratio), for each fault the cells
can have: an answer altered where it is produced, and half of the batch left
out."""

import time

import numpy as np
import pytest

import flo_torch.batch as fb
from benchmark import correct, harness
from flo_torch.container import writer

CELLS = ["cd_lossless_l5.ingest", "cd_lossy_high.ingest", "cd_lossless_l5.decode",
         "cd_lossy_high.decode"]


def small(cell: str):
    config, traffic = cell.split(".")
    cfg = harness.load("configs", config)
    tr = dict(harness.load("traffic", traffic), tracks_s=[1, 2, 2, 3], content_base_s=1,
              warmup={"min_batches": 2, "max_batches": 2, "agree": 0.1})
    return cfg, tr


def run(cell: str, seed: int = 2**31 + 17) -> dict:
    cfg, tr = small(cell)
    return harness.run_cell(cell, cfg, tr, seed, 0.2, False, time.perf_counter(), "cpu")


NUMBERS = {
    "cd_lossless_l5.ingest": ["format_errors", "gap_steps"],
    "cd_lossy_high.ingest": ["format_errors", "q_gap_pct", "snr_gap_db"],
    "cd_lossless_l5.decode": ["format_errors", "gap_steps"],
    "cd_lossy_high.decode": ["format_errors", "q_gap_pct", "snr_gap_db", "decode_gap_steps"],
}


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    res = run(cell)
    assert res["correct"] and res["failed"] == 0, res["checks"]
    assert list(res["checks"]) == NUMBERS[cell]
    assert res["attempted"] > 0 and res["attempted"] % 4 == 0


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell, seed):
    cfg, tr = small(cell)
    pool = harness.make_pool(cfg, tr, seed)
    tally = correct.Tally(cfg["limits"])
    sample = correct.sample_tracks(seed, tr["tracks_s"], len(pool))
    harness.load_entry(tr["entry"]).control(tally, cfg, [(key, pool[key[0]][key[1]]) for key in sample])
    numbers = tally.numbers(cfg)
    assert not correct.verdict(numbers, cfg["limits"]), numbers


def _altered_frames(write):
    """``writer.write`` with the middle byte of every frame's first payload
    changed (Rice codes, or a lossy frame's coefficients)."""
    def wrapped(rate, channels, bits, level, frames, *args, **kwargs):
        frames = list(frames)
        for fr in frames:
            if fr.channels and len(fr.channels[0].residuals) > 60:
                blob = bytearray(fr.channels[0].residuals)
                blob[len(blob) // 2] ^= 0x5A
                fr.channels[0].residuals = bytes(blob)
        return write(rate, channels, bits, level, frames, *args, **kwargs)
    return wrapped


def _altered_samples(decode):
    def wrapped(datas, **kw):
        fut = decode(datas, **kw)

        def fin():
            outs = [o.copy() for o in fut.result()]
            for o in outs:
                o[100] += np.float32(100 / 32767)
            return outs
        return fb.BulkFuture(fin)
    return wrapped


def _half_left_out(fn):
    """The entry run on the first half of the batch, whose outputs stand in
    for the second half's."""
    def wrapped(items, *args, **kw):
        half = len(items) // 2
        fut = fn(items[:half], *args, **kw)
        return fb.BulkFuture(lambda: list(fut.result()) * 2)
    return wrapped


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["altered", "half"])
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    cfg, tr = small(cell)
    name = "decode_many_async" if tr["entry"] == "decode" else (
        "encode_many_async" if cfg["mode"] == "lossless" else "encode_lossy_many_async")
    original = getattr(fb, name)
    if fault == "half":
        monkeypatch.setattr(fb, name, _half_left_out(original))
    elif tr["entry"] == "decode":
        monkeypatch.setattr(fb, name, _altered_samples(original))
    else:
        monkeypatch.setattr(writer, "write", _altered_frames(writer.write))
    try:
        res = run(cell)
    except harness.SetupError:
        return  # its bytes leave the configuration's ratio: the run stops with no result
    assert not res["correct"], res["checks"]
    assert res["failed"] > 0
