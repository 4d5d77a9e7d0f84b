"""One run of a cell: content from the seed, set-up, warm-up, the measured
window, the check against the reference, and with ``trace`` a profiled slice
of the window and the per-layer metrics.

A cell is ``<config>.<traffic>``: ``configs/<config>.json`` is the deployment
(rate, channels, mode, level or quality, the host's thread team, the range
of its compression ratio, the comparisons' limits) and
``traffic/<traffic>.json`` the load (its entry, the tracks of a batch,
batches in flight and in the pool, the warm-up and the traced slice). The
entry the window drives is ``entries/<entry>.py``: its inputs, its call, the
files a batch holds and its check against the reference. A per-layer metric
is ``metrics/<name>.py``, whose ``read(ctx)`` returns the metric or None
where the cell has nothing for it to read. A later cell, mix, entry or
metric is a new file of its own.

The window: one client in a closed loop, batch k + 1 dispatched through the
entry before batch k's ``result()``, the pool's batches in turn. It opens at
the first dispatch, dispatches until ``seconds`` have passed and closes when
the last batch in flight completes; the rate is the audio of every batch
completed over exactly that time.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import os
import pathlib
import sys
import tempfile
import time
from collections import Counter, deque
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import torch

from . import content, correct, devtrace, frozen
from .reference import container

HERE = pathlib.Path(__file__).resolve().parent
KERNEL_MODULES = ("cuda_select", "cuda_ricepack", "cuda_psycho", "cuda_lpc")


class SetupError(RuntimeError):
    """The run cannot measure what its cell states."""


def load(kind: str, name: str) -> dict:
    """``configs/<name>.json`` or ``traffic/<name>.json``."""
    return json.loads((HERE / kind / f"{name}.json").read_text())


def load_entry(name: str):
    """``entries/<name>.py``."""
    return importlib.import_module(f"benchmark.entries.{name}")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def make_pool(cfg: dict, traffic: dict, seed: int) -> list:
    """The pool's batches of tracks, interleaved float32 at 16-bit values
    (k / 32768): each track is ``content.make_music`` from its own seed,
    drawn from ``seed``, over ``content_base_s`` seconds, tiled to the
    track's length. The lengths are the traffic's, whatever the seed."""
    rate, C = cfg["sample_rate"], cfg["channels"]

    def track(b: int, j: int, secs: float) -> np.ndarray:
        rng = np.random.default_rng(np.random.SeedSequence([seed % (1 << 64), b, j]))
        base = content.make_music(traffic["content_base_s"], rate, rng)
        base = (np.clip(np.rint(base * 32768.0), -32768, 32767) * (1 / 32768)).astype(np.float32)
        need = int(round(secs * rate)) * C
        return np.tile(base, -(-need // base.size))[:need]

    with ThreadPoolExecutor(cfg["host_threads"]) as ex:
        futs = [[ex.submit(track, b, j, secs) for j, secs in enumerate(traffic["tracks_s"])]
                for b in range(traffic["pool_batches"])]
        return [[f.result() for f in batch] for batch in futs]


def describe_bytes(cfg: dict, pool_pcm: list, pool_files: list) -> None:
    """Each batch's compression ratio, and the histogram of predictor orders
    (lossless) or of nonzero coefficients a channel block (lossy). A ratio
    outside the configuration's ``ratio_range`` is not the deployment the
    cell states: ``SetupError``."""
    lo, hi = cfg["ratio_range"]
    for b, (tracks, datas) in enumerate(zip(pool_pcm, pool_files)):
        ratio = sum(t.size * 2 for t in tracks) / sum(len(d) for d in datas)
        files = [container.parse(d) for d in datas]
        if cfg["mode"] == "lossless":
            hist = Counter(f"{c.kind}{c.order}" for f in files for fr in f.frames for c in fr.channels)
            log(f"[setup] batch {b}: {ratio:.4f}x; predictor orders {dict(sorted(hist.items()))}")
        else:
            from flo_torch import native  # the program's own parser: a count for the log only

            streams = []
            for f in files:
                for fr in f.frames:
                    blob, pos = fr.channels[0], 2 + 50 * f.channels
                    for _ in range(f.channels):
                        ln = int.from_bytes(blob[pos : pos + 4], "little")
                        streams.append(blob[pos + 4 : pos + 4 + ln])
                        pos += 4 + ln
            got = native.sparse_decode_entries(streams, 1024)
            nnz = got[1] if got is not None else np.zeros(0)
            qs = np.percentile(nnz, [0, 10, 50, 90, 100]).tolist() if len(nnz) else []
            log(f"[setup] batch {b}: {ratio:.4f}x; nonzeros a channel block: min/p10/p50/p90/max "
                f"{qs}, mean {float(np.mean(nnz)) if len(nnz) else 0:.1f}")
        if not lo <= ratio <= hi:
            raise SetupError(f"batch {b} compresses {ratio:.4f}x, outside the configuration's "
                             f"range {lo}-{hi}x: the content is not the deployment's")


class Loop:
    """The closed loop over the pool: ``in_flight`` batches dispatched ahead
    of the one collected. Each batch leaves a span (k, pool index, dispatch
    start and end, collect start and end) on the host's clock."""

    def __init__(self, call, inputs: list, in_flight: int, annotate: bool):
        self.call, self.inputs, self.in_flight = call, inputs, in_flight
        self.annotate = annotate
        self.kept = {}  # pool index -> its newest output

    def _span(self, name: str):
        if self.annotate:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()

    def run(self, go_on, on_collect=None) -> list:
        """Dispatch while ``go_on(spans)``; returns the spans."""
        spans, queue, k = [], deque(), 0
        while True:
            while len(queue) < self.in_flight and go_on(spans, k):
                p = k % len(self.inputs)
                t0 = time.perf_counter()
                with self._span("dispatch"):
                    fut = self.call(self.inputs[p])
                queue.append((k, p, t0, time.perf_counter(), fut))
                k += 1
            if not queue:
                return spans
            kk, p, d0, d1, fut = queue.popleft()
            c0 = time.perf_counter()
            with self._span("collect"):
                out = fut.result()
            c1 = time.perf_counter()
            self.kept[p] = out
            spans.append(SimpleNamespace(k=kk, pool=p, d0=d0, d1=d1, c0=c0, c1=c1))
            if on_collect is not None:
                on_collect(spans)


def host_s(span) -> float:
    """A batch's host time: its dispatch and its collect."""
    return (span.d1 - span.d0) + (span.c1 - span.c0)


def warm_up(loop: Loop, warm: dict) -> list:
    """The cell's own traffic until steady: at least ``min_batches``, then
    until the last two batches' host times agree within ``agree``, at most
    ``max_batches``."""

    def go_on(spans, k):
        if k < warm["min_batches"]:
            return True
        if k >= warm["max_batches"] or len(spans) < 2:
            return k < warm["max_batches"]
        a, b = host_s(spans[-1]), host_s(spans[-2])
        return abs(a - b) > warm["agree"] * max(a, b)

    return loop.run(go_on)


class TracedSlice:
    """The profiler (CPU and CUDA activity) over ``batches`` whole batches of
    the window: it starts after batch ``skip``'s collect and stops after the
    collect ``batches`` later, so batches ``skip + 1`` to ``skip + batches``
    are dispatched, and their kernels run, inside it; the card is
    synchronised at both ends. Inside it a ``traced_slice`` annotation."""

    def __init__(self, skip: int, batches: int, dev):
        self.skip, self.batches, self.dev = skip, batches, dev
        self.on_card = dev.type == "cuda"
        self.prof, self.mark, self.done = None, None, False
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.on_card:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
            with torch.profiler.profile(activities=acts):  # its first start, before the window
                torch.ones(1, device=dev).sum().item()
        self.acts = acts

    def on_collect(self, spans) -> None:
        n = len(spans)
        if n == self.skip and self.prof is None:
            self._sync()
            self.prof = torch.profiler.profile(activities=self.acts)
            self.prof.start()
            self.mark = torch.profiler.record_function("traced_slice")
            self.mark.__enter__()
        elif self.prof is not None and not self.done and n == self.skip + self.batches:
            self._sync()
            self.mark.__exit__(None, None, None)
            self.prof.stop()
            self.done = True

    def _sync(self) -> None:
        if self.on_card:
            torch.cuda.synchronize(self.dev)

    def read(self, pool_size: int):
        """The slice (``devtrace.Slice``) with the pool index of each batch
        whose kernels it holds, or None where the window ended inside it."""
        if not self.done:
            if self.prof is not None:
                self.mark.__exit__(None, None, None)
                self.prof.stop()
            return None
        with tempfile.TemporaryDirectory() as td:
            path = os.path.join(td, "trace.json")
            self.prof.export_chrome_trace(path)
            sl = devtrace.read(path)
        sl.pool = [(self.skip + 1 + i) % pool_size for i in range(self.batches)]
        return sl


def launches() -> dict:
    from flo_torch.ops import cuda_lpc, cuda_psycho, cuda_ricepack, cuda_select

    mods = {"cuda_select": cuda_select, "cuda_ricepack": cuda_ricepack,
            "cuda_psycho": cuda_psycho, "cuda_lpc": cuda_lpc}
    return {n: mods[n].LAUNCHES for n in KERNEL_MODULES}


def per_layer(metrics, ctx) -> dict:
    """Each per-layer metric's reader (``BENCHMARK.json``'s entries), found
    by its name, on ``ctx``."""
    out = {}
    for m in metrics:
        spec = importlib.util.spec_from_file_location(
            f"benchmark_metric_{m['name'].replace('.', '_')}", HERE / "metrics" / f"{m['name']}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        value = mod.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(workload: str, cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool,
             t_start: float, device="cuda", metrics=()) -> dict:
    """One run; returns what the result line reports (see ``run.py``)."""
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    ent = load_entry(traffic["entry"])
    pool_pcm = make_pool(cfg, traffic, seed)
    audio_s = sum(traffic["tracks_s"])
    log(f"[setup] content: {len(pool_pcm)} batches of {len(traffic['tracks_s'])} tracks, "
        f"{audio_s} audio-s a batch, {time.perf_counter() - t_start:.2f} s since start")
    inputs = ent.prepare(cfg, traffic, pool_pcm, device)
    call = ent.call(cfg, traffic, device)
    loop = Loop(call, inputs, traffic["in_flight"], annotate=trace)
    warm = warm_up(loop, traffic["warmup"])
    log(f"[setup] warm-up: {len(warm)} batches, host s (dispatch + collect) "
        f"{[round(host_s(b), 3) for b in warm]}")
    pool_files = [ent.files(inputs[p], loop.kept[p]) for p in range(len(inputs))]
    describe_bytes(cfg, pool_pcm, pool_files)
    loop.kept.clear()
    gc.collect()
    if on_card:
        torch.cuda.synchronize(dev)
    before = launches()

    tr = traffic["trace"]
    traced = TracedSlice(tr["skip_batches"], tr["batches"], dev) if trace else None

    t_open = None

    def go_on(spans, k):
        nonlocal t_open
        if t_open is None:
            t_open = time.perf_counter()
            return True
        if trace and k <= tr["skip_batches"] + tr["batches"]:
            return True  # the traced slice's batches are all dispatched
        return time.perf_counter() - t_open < seconds

    spans = loop.run(go_on, traced.on_collect if traced else None)
    t_close = spans[-1].c1
    setup_s = t_open - t_start
    rate = audio_s * len(spans) / (t_close - t_open)
    delta = {n: v - before[n] for n, v in launches().items()}
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    log(f"[window] {len(spans)} batches in {t_close - t_open:.3f} s: {rate:.4f} audio-s/s; "
        f"kernel launches {delta}")
    log("[window] dispatch / collect ms: " + " ".join(
        f"{1e3 * (b.d1 - b.d0):.0f}/{1e3 * (b.c1 - b.c0):.0f}" for b in spans))

    kept = dict(loop.kept)
    del loop
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    result = {
        "metrics": {traffic["metric"]: {"value": rate, "unit": "audio-s/s"},
                    "setup_s": {"value": setup_s, "unit": "s"}},
        "attempted": len(spans) * len(traffic["tracks_s"]),
        "memory_peak_bytes": int(peak),
        "launches": delta,
    }

    if trace:
        sl = traced.read(len(inputs))
        ctx = SimpleNamespace(
            workload=workload, entry=traffic["entry"], mode=cfg["mode"], cfg=cfg, traffic=traffic,
            spans=spans, trace=sl, frozen=frozen,
            files=lambda p: [container.parse(d) for d in ent.files(inputs[p], kept.get(p))],
        )
        result["per_layer"] = per_layer(metrics, ctx)
        if sl is not None:
            result["busy_s"], result["window_s"] = sl.busy_s, sl.window_s
            result["breakdown"] = sl.breakdown()

    # The check: once the window has closed and the program's state is freed.
    t0 = time.perf_counter()
    tally = correct.Tally(cfg["limits"])
    sample = correct.sample_tracks(seed, traffic["tracks_s"], len(pool_pcm))
    present = [(p, j) for p, j in sample if p in kept]
    for key in set(sample) - set(present):
        tally.bad(key)
    ent.check(tally, cfg, [((p, j), kept[p][j], inputs[p][j], pool_pcm[p][j]) for p, j in present])
    numbers = tally.numbers(cfg)
    result["correct"] = correct.verdict(numbers, cfg["limits"])
    result["failed"] = len(tally.failed_tracks)
    result["checks"] = {k: {"value": v, "limit": cfg["limits"][k]} for k, v in numbers.items()}
    log(f"[check] reference over tracks {sample} in {time.perf_counter() - t0:.2f} s")
    return result
