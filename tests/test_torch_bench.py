"""bench_torch.py, the port's twin of bench.py, held to bench.py on the CPU:
its synthetic content and corpus tiling, one quick run of four configs with
the plain versions of the kernels, and its refusal to run without a card
unless asked for the CPU."""

import ast
import contextlib
import io
import json
import pathlib

import numpy as np
import pytest
import torch

import bench
import bench_torch
from flo_torch.container import reader
from flo_torch.lossless import decoder as port_decoder

REPO = pathlib.Path(__file__).resolve().parents[1]
SELECTED = ("lossless_l5", "lossy_q1", "device_reconstruct", "streaming_decode")
#: The quick geometry's corpus round trip: three short files, all exact.
QUICK_CORPUS = f"{len(bench_torch.QUICK.corpus)}/{len(bench_torch.QUICK.corpus)}"
RENAMES = {"platform": "device", "tunnel_mbs": "copy_mbs"}
#: Keys the port's result line has beyond bench.py's: setup_seconds split
#: into its build and its first pass, the headline's stage times, peak
#: device memory and the run's wall time.
ADDED = {"build_seconds", "first_pass_seconds", "pass_stages_seconds", "peak_device_mb",
         "wall_seconds"}


def _bench_py_dicts():
    """bench.py's result dict keys and its summary dict keys, from its source."""
    tree = ast.parse((REPO / "bench.py").read_text())
    result = next(
        n.value for n in ast.walk(tree)
        if isinstance(n, ast.Assign) and isinstance(n.value, ast.Dict)
        and any(isinstance(t, ast.Name) and t.id == "result" for t in n.targets)
    )
    summary = next(
        n.args[0] for n in ast.walk(tree)
        if isinstance(n, ast.Call) and getattr(n.func, "attr", None) == "dumps"
        and n.args and isinstance(n.args[0], ast.Dict)
    )
    return ([RENAMES.get(k.value, k.value) for k in result.keys],
            [RENAMES.get(k.value, k.value) for k in summary.keys])


@pytest.mark.parametrize("seed", list(range(42, 50)) + list(range(7, 15)))
def test_make_audio_is_bench_py_bit_for_bit(seed):
    got = bench_torch.make_audio(2, bench_torch.RATE, seed=seed)
    want = bench.make_audio(2, bench.RATE, seed=seed)
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes()


def test_geometry_is_bench_py():
    names = ("WORKLOAD_SECONDS", "BATCH_FILES", "RATE", "CHANNELS", "ITERS", "NORTH_STAR",
             "BREADTH_SECONDS", "BREADTH_FILES")
    assert [getattr(bench_torch, n) for n in names] == [getattr(bench, n) for n in names]
    full = bench_torch.FULL
    assert (full.files, full.seconds, full.iters, full.breadth_files, full.breadth_seconds) == (
        bench.BATCH_FILES, bench.WORKLOAD_SECONDS, bench.ITERS, bench.BREADTH_FILES,
        bench.BREADTH_SECONDS)


def test_corpus_tiling_matches_flo_tpu_decode():
    """bench.py:120-130's tiling of flo_tpu's decode of the stereo chord,
    against the port's tiling of its own decode: 5 s from a 2 s file, so the
    tiles repeat and the roll moves them."""
    from flo_tpu.lossless import decoder as tpu_decoder

    raw = (bench_torch.EXAMPLES / "chord_cmajor_stereo.flo").read_bytes()
    base = np.asarray(tpu_decoder.decode(raw))
    n_files, seconds, rate, ch = 3, 5, 44100, 2
    need = seconds * rate * ch
    tiled = np.tile(base, -(-need // len(base)))[:need]
    want = [np.roll(tiled, i * ch * rate) for i in range(n_files)]
    got, got_rate, got_ch = bench_torch.corpus_content("chord_cmajor_stereo", n_files, seconds,
                                                        device="cpu")
    assert (got_rate, got_ch) == (rate, ch) and len(got) == n_files
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


def test_main_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_torch.main([])


def test_unknown_config_is_refused():
    with pytest.raises(ValueError, match="unknown configs"):
        bench_torch.run("cpu", bench_torch.QUICK, ["lossless_l7"])


def test_imports_nothing_of_bench_py():
    tree = ast.parse((REPO / "bench_torch.py").read_text())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
    assert not {m for m in names if m.split(".")[0] in ("bench", "jax", "jaxlib", "flo_tpu")}


@pytest.fixture(scope="module")
def quick_run():
    """One ``--quick --device cpu`` run of four configs, its printed lines
    parsed, and the returned result (with the headline's lossless files)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = bench_torch.run("cpu", bench_torch.QUICK, SELECTED)
    lines = [json.loads(line) for line in out.getvalue().splitlines()]
    return lines, result


def test_quick_run_prints_a_line_for_every_config(quick_run):
    lines, _ = quick_run
    cfgs = [line for line in lines if "config" in line]
    assert [c["config"] for c in cfgs] == [c for c in bench_torch.CONFIGS if c in SELECTED]
    assert len(bench_torch.CONFIGS) == 21
    for c in cfgs:
        assert "skipped" not in c and "value" in c
    assert "headline" in lines[1] and lines[2] == {"corpus_bit_exact": QUICK_CORPUS}


def test_quick_run_gates_hold(quick_run):
    lines, result = quick_run
    assert result["corpus_bit_exact"] == QUICK_CORPUS and result["corpus_bit_exact_rate"] == 1.0
    configs = result["configs"]
    assert configs["lossless_l5"]["ratio"] > 1.5 and configs["lossless_l5"]["value"] > 0
    assert configs["lossy_q1"]["snr_db"] > bench_torch.MEDIUM_SNR_FLOOR
    assert configs["streaming_decode"]["value"] > 0
    assert result["lossless_ratio"] == configs["lossless_l5"]["ratio"]
    assert lines[-1]["skipped"] == []


def test_result_keys_are_bench_py_with_two_renames(quick_run):
    lines, _ = quick_run
    result_keys, summary_keys = _bench_py_dicts()
    assert set(lines[-2]) == set(result_keys) | ADDED
    # The summary also names the device, the wall time and the configs the
    # budget skipped.
    assert set(lines[-1]) == set(summary_keys) | {"device", "wall_seconds", "skipped"}
    assert lines[-1]["summary"] is True and lines[-1]["value"] == lines[-2]["value"]


def test_cpu_run_writes_no_device_number(quick_run):
    lines, result = quick_run
    assert result["device"] == {"name": "cpu", "power_limit": None, "count": 0}
    assert result["copy_mbs"] is None and result["peak_device_mb"] is None
    assert "chip" not in result["unit"]
    rec = result["configs"]["device_reconstruct"]
    assert rec["value"] is None and rec["ms"] is None and rec["latency_ms"] is None
    assert rec["kernels"] == ["lpc_reconstruct"]
    assert set(rec["roofline"]) == {"bound", "bytes", "operations", "ops_type"}
    assert rec["roofline"]["bytes"] > 0 and rec["roofline"]["operations"] > 0


def test_headline_bytes_decode_through_flo_tpu_as_through_the_port(quick_run):
    from flo_tpu.container import reader as tpu_reader
    from flo_tpu.lossless import decoder as tpu_decoder

    datas = quick_run[1]["headline_lossless"]
    assert len(datas) == bench_torch.QUICK.files
    ours = port_decoder.decode_many([reader.read(d) for d in datas], device="cpu")
    theirs = tpu_decoder.decode_many([tpu_reader.read(d) for d in datas])
    for a, b in zip(ours, theirs):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_a_spent_budget_skips_the_config_and_says_so():
    printed = []
    b = bench_torch.Bench("cpu", bench_torch.QUICK, bench_torch.CONFIGS, 0.0, printed.append)
    b.run("lossless_l0", lambda: pytest.fail("a config ran past its budget"))
    assert printed == [{"config": "lossless_l0", "skipped": "budget"}]
    assert b.configs == {"lossless_l0": {"skipped": "budget"}}
