"""The program's own spans (``flo_torch.tracing``) in a traced run.

While the profiler records the traced slice, the program records a span at
each stage of its bulk paths (``encode.marshal``, ``encode.upload``, ...,
``decode.finish``) on ``time.perf_counter_ns()``, the clock of the
harness's own spans. The readers take them once a run
(``flo_torch.tracing.take()``, cached on ``ctx``) and keep those inside the
slice on the host's clock: from batch ``skip``'s collect to batch ``skip +
batches``'s, so the dispatches of batches ``skip + 1`` to ``skip + batches``
and the collects of batches ``skip`` to ``skip + batches - 1``, ``batches``
of each. A program without the tracing module (an older commit) gives no
span, and every reader None.

To lay the spans on the device trace, the program's clock is mapped onto
the trace's by the harness's ``collect`` spans, which both records hold: the
n-th ``collect`` annotation of the trace is window batch ``skip + n`` on the
host's clock. The offset is the median over those pairs of the difference of
their midpoints; where any pair's durations differ by more than
``MISMATCH_US``, the clocks do not match and the readers give None.
"""

from __future__ import annotations

import statistics
import sys

#: The most a matched pair's durations may differ, in microseconds.
MISMATCH_US = 200.0


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def taken(ctx):
    """The program's spans inside the traced slice, or None (no slice, or a
    program without spans)."""
    if not hasattr(ctx, "program_spans"):
        ctx.program_spans = _take(ctx)
    return ctx.program_spans


def _take(ctx):
    try:
        from flo_torch import tracing
    except ImportError:
        return None
    spans = tracing.take()
    sl, tr = ctx.trace, ctx.traffic["trace"]
    skip, n = tr["skip_batches"], tr["batches"]
    if sl is None or not spans or len(ctx.spans) < skip + n:
        return None
    lo = ctx.spans[skip - 1].c1 * 1e9 if skip else float("-inf")
    hi = ctx.spans[skip + n - 1].c1 * 1e9
    return [s for s in spans if lo <= s.start_ns and s.end_ns <= hi] or None


def ms_a_batch(ctx, name: str, rate: str):
    """The traced slice's spans called ``name``, in ms a batch: the sum of
    their durations over the slice's batches. None in a cell that does not
    report ``rate``, or where no such span was recorded."""
    if ctx.traffic["metric"] != rate:
        return None
    spans = taken(ctx)
    if spans is None or not ctx.trace.batches:
        return None
    durs = [s.end_ns - s.start_ns for s in spans if s.name == name]
    return 1e-6 * sum(durs) / ctx.trace.batches if durs else None


def align(ctx):
    """(offset, largest mismatch), in microseconds: the program's clock in
    µs plus the offset is the trace's. None where the matched pairs'
    durations differ by more than ``MISMATCH_US``, or there is no pair."""
    sl = ctx.trace
    if sl is None:
        return None
    skip = ctx.traffic["trace"]["skip_batches"]
    marks = sorted((a, b) for name, a, b in sl.spans if name == "collect")
    pairs = list(zip(ctx.spans[skip:], marks))
    if not pairs:
        return None
    worst = max(abs((h.c1 - h.c0) * 1e6 - (b - a)) for h, (a, b) in pairs)
    if worst > MISMATCH_US:
        _log(f"[spans] the harness's collect spans and the trace's differ by up to "
             f"{worst / 1e3:.4f} ms: no alignment")
        return None
    offset = statistics.median(0.5 * (a + b) - 0.5e6 * (h.c0 + h.c1) for h, (a, b) in pairs)
    return offset, worst


def _merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _overlap(a, b) -> float:
    """Length of the intersection of two sorted, merged interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def leaves(spans, prefix: str) -> list:
    """The spans named ``<prefix>*`` that are no kept span's parent."""
    parents = {s.parent for s in spans}
    return [s for s in spans if s.name.startswith(prefix) and s.id not in parents]


def idle_unattributed_pct(ctx, prefix: str, rate: str):
    """The share of the traced slice's idle time (no kernel, copy or set on
    the device) that no leaf span named ``<prefix>*``, on any thread, covers
    on the aligned clock, in %."""
    if ctx.traffic["metric"] != rate:
        return None
    spans, al, sl = taken(ctx), align(ctx), ctx.trace
    if spans is None or al is None:
        return None
    offset, worst = al
    idle = [[s, e] for s, e in zip([sl.t0] + [e for _, e in sl.busy],
                                   [s for s, _ in sl.busy] + [sl.t1]) if e > s]
    idle_us = sum(e - s for s, e in idle)
    if idle_us <= 0:
        return None
    leaf = leaves(spans, prefix)
    covered = _overlap(idle, _merged((s.start_ns / 1e3 + offset, s.end_ns / 1e3 + offset)
                                     for s in leaf))
    skip, n = ctx.traffic["trace"]["skip_batches"], sl.batches
    host_ms = 1e3 * (statistics.median(h.d1 - h.d0 for h in ctx.spans)
                     + statistics.median(h.c1 - h.c0 for h in ctx.spans))
    slice_ms = 1e3 * (sum(h.d1 - h.d0 for h in ctx.spans[skip + 1 : skip + n + 1])
                      + sum(h.c1 - h.c0 for h in ctx.spans[skip : skip + n])) / n
    leaf_ms = 1e-6 * sum(s.end_ns - s.start_ns for s in leaf) / n
    _log(f"[spans] clock offset {offset:.1f} us, largest duration mismatch "
         f"{worst / 1e3:.4f} ms; leaf spans {leaf_ms:.2f} ms a batch: "
         f"{100 * leaf_ms / host_ms:.2f}% of the window's median dispatch + median collect "
         f"({host_ms:.2f} ms), {100 * leaf_ms / slice_ms:.2f}% of the slice's "
         f"({slice_ms:.2f} ms); idle {idle_us / 1e3:.2f} ms, {covered / 1e3:.2f} ms of it "
         f"under a leaf span")
    return 100.0 * (1.0 - covered / idle_us)
