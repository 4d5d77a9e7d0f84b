"""The traced slice of a window, read from the profiler's Chrome trace.

The harness profiles a few whole batches of its window (CPU and CUDA
activity) inside a ``traced_slice`` annotation, with ``dispatch`` and
``collect`` annotations around the entry's calls. From the trace: the device
operations (kernels, copies, sets) that fall in the slice, the time in which
any of them ran (``busy_s``), the slice's length (``window_s``), and the idle
gaps between them, each named by the harness's annotation that was open on
the host at the gap's middle.
"""

from __future__ import annotations

import json
import statistics
from collections import defaultdict

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}


class Slice:
    def __init__(self, t0: float, t1: float, ops: list, spans: list):
        self.t0, self.t1 = t0, t1  # microseconds
        self.ops = ops  # (name, cat, start, end), clipped to the slice
        self.spans = spans  # (name, start, end) of dispatch / collect
        self.pool = []  # pool index of each batch whose kernels lie in the slice
        merged = []
        for _, _, s, e in sorted(ops, key=lambda o: o[2]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.busy = merged

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) * 1e-6

    @property
    def batches(self) -> int:
        return len(self.pool)

    def seconds(self, match) -> float:
        """Device seconds of the operations whose (name, cat) ``match`` takes."""
        return sum(e - s for n, c, s, e in self.ops if match(n, c)) * 1e-6

    def copy_s(self) -> float:
        return self.seconds(lambda n, c: c == "gpu_memcpy")

    def gaps(self) -> list:
        """[(what the host was in, seconds)] of every idle stretch."""
        out, last = [], self.t0
        for s, e in self.busy + [[self.t1, self.t1]]:
            if s > last:
                mid = 0.5 * (s + last)
                what = next((n for n, a, b in self.spans if a <= mid <= b), "other")
                out.append((what, (s - last) * 1e-6))
            last = max(last, e)
        return out

    def breakdown(self) -> dict:
        """The ten device operations (by name, cut to 100 characters) that
        took most time, and the ten longest idle gaps, in seconds."""
        by_name = defaultdict(float)
        for n, _, s, e in self.ops:
            by_name[n] += (e - s) * 1e-6
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gaps(), key=lambda g: -g[1])[:10]
        return {"device_ops": [[n[:100], v] for n, v in top],
                "idle_gaps": [[n, v] for n, v in gaps]}


def read(path: str) -> Slice:
    """The slice of a Chrome trace written by ``torch.profiler``."""
    with open(path) as fh:
        events = json.load(fh)
    events = events.get("traceEvents", events) if isinstance(events, dict) else events
    marks = [e for e in events if e.get("ph") == "X" and e.get("name") == "traced_slice"
             and e.get("cat", "").lower() == "user_annotation"]
    if not marks:
        raise RuntimeError("the trace has no traced_slice annotation")
    t0 = float(marks[0]["ts"])
    t1 = t0 + float(marks[0]["dur"])
    ops, spans = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = str(e.get("cat", "")).lower()
        s, d = float(e["ts"]), float(e["dur"])
        if cat in DEVICE_CATS:
            s, end = max(s, t0), min(s + d, t1)
            if end > s:
                ops.append((e.get("name", "?"), cat, s, end))
        elif cat == "user_annotation" and e.get("name") in ("dispatch", "collect"):
            spans.append((e["name"], s, s + d))
    return Slice(t0, t1, ops, spans)


# --- Readers the per-layer metrics share: each reads the cells that report
# ``rate`` (``encode_rate`` or ``decode_rate``), and None in any other. ------


def _spans(ctx, rate: str):
    return ctx.spans if ctx.traffic["metric"] == rate and ctx.spans else None


def dispatch_ms(ctx, rate: str):
    """Median over the window's batches of the entry's call, in ms."""
    spans = _spans(ctx, rate)
    return None if spans is None else statistics.median((s.d1 - s.d0) * 1e3 for s in spans)


def collect_ms(ctx, rate: str):
    """Median over the window's batches of the future's ``result()``, in ms."""
    spans = _spans(ctx, rate)
    return None if spans is None else statistics.median((s.c1 - s.c0) * 1e3 for s in spans)


def copy_ms(ctx, rate: str):
    """The device's copy time a batch of the traced slice, in ms."""
    sl = ctx.trace
    if ctx.traffic["metric"] != rate or sl is None or not sl.batches:
        return None
    return 1e3 * sl.copy_s() / sl.batches


def idle_pct(ctx, rate: str):
    """The share of the traced slice in which no kernel, copy or set ran on
    the device, in %."""
    sl = ctx.trace
    if ctx.traffic["metric"] != rate or sl is None or sl.window_s <= 0:
        return None
    return 100.0 * (1.0 - sl.busy_s / sl.window_s)
