"""``spans``: the program's spans laid on a synthetic device trace. The
clocks are aligned by the harness's ``collect`` spans (None where their
durations disagree by more than 0.2 ms), the spans are cut to the slice,
the stage times are summed over the slice's batches, and the idle time no
leaf span covers is found."""

import sys
from types import SimpleNamespace

import pytest

from benchmark import devtrace, spans
from flo_torch import tracing
from flo_torch.tracing import Span

OFFSET_US = 5_000_000.0  # the trace's clock = the host's (in us) + this


def host(k, d0, d1, c0, c1):
    """A harness span, times in ms on the host clock (seconds in the span)."""
    return SimpleNamespace(k=k, pool=k % 2, d0=d0 / 1e3, d1=d1 / 1e3, c0=c0 / 1e3, c1=c1 / 1e3)


def sp(i, name, a_ms, b_ms, parent=0, thread=1):
    return Span(i, name, int(a_ms * 1e6), int(b_ms * 1e6), thread, parent, {})


def trace_us(ms):
    return ms * 1e3 + OFFSET_US


#: The window as the harness's loop runs it (dispatch k + 1, then collect
#: k): d0 d1 c0 | d2 c1 d3 c2 | c3. With skip 1 and 2 batches the profiler
#: runs from c0's end (100 ms) to c2's (300 ms).
HOST = [host(0, 0, 10, 30, 100), host(1, 10, 30, 150, 200),
        host(2, 100, 150, 240, 300), host(3, 200, 240, 300, 350)]
PROGRAM = [
    sp(1, "encode.dispatch", 100.1, 149.9),
    sp(2, "encode.marshal", 100.2, 140, parent=1),
    sp(3, "encode.upload", 140, 149, parent=1),
    sp(4, "encode.collect", 150.1, 199.9),
    sp(5, "encode.download", 150.2, 190, parent=4),
    sp(6, "encode.dispatch", 200.1, 239.9),
    sp(7, "encode.enqueue", 200.2, 239, parent=6),
    sp(8, "encode.sparse_rle", 245, 280, thread=2),  # a worker thread's
    sp(9, "encode.collect", 240.1, 299.9),
    sp(10, "encode.assemble", 240.2, 290, parent=9),
    sp(11, "encode.marshal", 0, 5),  # before the slice
    sp(12, "encode.collect", 300.1, 349.9),  # after it
]


def make_ctx(monkeypatch, skew_us=0.0, metric="encode_rate"):
    """The device is busy 120-130 and 200-240 ms of the slice."""
    marks = [("collect", trace_us(h.c0 * 1e3), trace_us(h.c1 * 1e3) + skew_us)
             for h in HOST[1:3]]
    marks += [("dispatch", trace_us(h.d0 * 1e3), trace_us(h.d1 * 1e3)) for h in HOST[2:4]]
    ops = [("k", "kernel", trace_us(120), trace_us(130)),
           ("copy", "gpu_memcpy", trace_us(200), trace_us(240))]
    sl = devtrace.Slice(trace_us(100), trace_us(300), ops, marks)
    sl.pool = [0, 1]
    monkeypatch.setattr(tracing, "take", lambda: list(PROGRAM))
    return SimpleNamespace(traffic={"metric": metric, "trace": {"skip_batches": 1, "batches": 2}},
                           spans=HOST, trace=sl)


def test_the_slice_keeps_only_its_own_spans(monkeypatch):
    ctx = make_ctx(monkeypatch)
    kept = spans.taken(ctx)
    assert [s.id for s in kept] == list(range(1, 11))
    monkeypatch.setattr(tracing, "take", lambda: [])  # taken once a run
    assert spans.taken(ctx) is kept


def test_alignment_recovers_the_offset(monkeypatch):
    offset, worst = spans.align(make_ctx(monkeypatch))
    assert offset == pytest.approx(OFFSET_US, abs=1e-3)
    assert worst == pytest.approx(0.0, abs=1e-3)
    offset, worst = spans.align(make_ctx(monkeypatch, skew_us=150.0))
    assert worst == pytest.approx(150.0, abs=1e-3)
    assert offset == pytest.approx(OFFSET_US + 75.0, abs=1e-3)


def test_alignment_refuses_clocks_that_disagree(monkeypatch):
    assert spans.align(make_ctx(monkeypatch, skew_us=250.0)) is None
    ctx = make_ctx(monkeypatch, skew_us=-250.0)
    assert spans.idle_unattributed_pct(ctx, "encode.", "encode_rate") is None


def test_stage_times_are_summed_over_the_slices_batches(monkeypatch):
    ctx = make_ctx(monkeypatch)
    assert spans.ms_a_batch(ctx, "encode.marshal", "encode_rate") == pytest.approx(39.8 / 2)
    assert spans.ms_a_batch(ctx, "encode.enqueue", "encode_rate") == pytest.approx(38.8 / 2)
    assert spans.ms_a_batch(ctx, "encode.write", "encode_rate") is None
    assert spans.ms_a_batch(ctx, "encode.marshal", "decode_rate") is None


def test_idle_time_under_no_leaf_span(monkeypatch):
    """Idle: 100-120, 130-200, 240-300 ms (150 ms). The leaves (the
    dispatches and collects are parents) cover 100.2-149, 150.2-190,
    200.2-239 and 240.2-290, a worker's span among them; under a leaf:
    19.8 + 19 + 39.8 + 49.8 = 128.4 ms of the idle."""
    ctx = make_ctx(monkeypatch)
    got = spans.idle_unattributed_pct(ctx, "encode.", "encode_rate")
    assert got == pytest.approx(100.0 * (1.0 - 128.4 / 150.0), abs=1e-6)
    assert sorted(s.id for s in spans.leaves(spans.taken(ctx), "encode.")) == [2, 3, 5, 7, 8, 10]
    assert spans.idle_unattributed_pct(ctx, "decode.", "encode_rate") == pytest.approx(100.0)
    other = make_ctx(monkeypatch, metric="decode_rate")
    assert spans.idle_unattributed_pct(other, "encode.", "encode_rate") is None


def test_a_program_without_spans_reads_none(monkeypatch):
    ctx = make_ctx(monkeypatch)
    import flo_torch

    monkeypatch.delattr(flo_torch, "tracing")  # as in a program without the module
    monkeypatch.setitem(sys.modules, "flo_torch.tracing", None)
    assert spans.taken(ctx) is None
    assert spans.ms_a_batch(ctx, "encode.marshal", "encode_rate") is None
    assert spans.idle_unattributed_pct(ctx, "encode.", "encode_rate") is None


def test_no_slice_reads_none(monkeypatch):
    ctx = make_ctx(monkeypatch)
    ctx.trace = None
    assert spans.taken(ctx) is None and spans.align(ctx) is None
    assert spans.idle_unattributed_pct(ctx, "encode.", "encode_rate") is None
