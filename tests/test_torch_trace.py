"""flo_torch.tracing on the CPU: off it keeps nothing and opens no profiler
annotation; on (the switch, or a torch profiler) the bulk paths leave one
leaf span a chunk at each stage, with their counts, inside a top span for a
bulk call's dispatch and one for its ``result()``; the decodes keep their
order of uploads and launches; the bytes and samples do not depend on
whether anything records."""

import json
import threading

import numpy as np
import pytest
import torch

from flo_torch import batch, tracing
from flo_torch.container import reader
from flo_torch.lossless import decoder as ll_decoder
from flo_torch.lossless import encoder as ll_encoder
from flo_torch.lossy import decoder as ly_decoder
from flo_torch.lossy import encoder as ly_encoder
from flo_torch.parallel import pipeline

RATE, C = 4000, 2


def _clips():
    """Four stereo clips of 1-3 s (two chunks in each path)."""
    rng = np.random.default_rng(7)
    out = []
    for n in (3 * RATE, 2 * RATE + 77, RATE, 2 * RATE):
        t = np.arange(n) / RATE
        x = np.stack([0.3 * np.sin(2 * np.pi * 220 * t), 0.2 * np.sin(2 * np.pi * 97 * t)], 1)
        out.append((x + 0.01 * rng.standard_normal(x.shape)).astype(np.float32).reshape(-1))
    return out


@pytest.fixture(autouse=True)
def _clean():
    tracing.disable()
    tracing.take()
    yield
    tracing.disable()
    tracing.take()


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def _leaves(spans):
    parents = {s.parent for s in spans}
    return [s for s in spans if s.id not in parents]


def test_off_keeps_nothing_and_opens_no_annotation(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function called with no profiler recording")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not tracing.recording()
    sp = tracing.span("encode.marshal", frames=3)
    assert sp is tracing.NULL and not sp
    clips = _clips()
    datas = batch.encode_many(clips, RATE, C, analyze=False, device="cpu")
    batch.decode_many(datas, device="cpu")
    assert tracing.take() == []
    counters = tracing.counters()
    assert set(counters) == {"cuda_select.launches", "cuda_ricepack.launches",
                             "cuda_psycho.launches", "cuda_lpc.launches"}


def test_the_switch_alone_opens_no_annotation(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function called with no profiler recording")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    tracing.enable()
    with tracing.span("encode.marshal"):
        pass
    assert [s.name for s in tracing.take()] == ["encode.marshal"]


def test_nesting_gives_parents_and_counts():
    tracing.enable()
    with tracing.span("outer", mode="lossless") as outer:
        with tracing.span("inner", frames=2) as inner:
            assert inner
            inner.add(frames=3, bytes=100)
        outer.add(bytes=7)
    got = _by_name(tracing.take())
    (o,), (i,) = got["outer"], got["inner"]
    assert o.parent == 0 and i.parent == o.id == outer.id and i.id == inner.id
    assert i.thread == o.thread
    assert o.start_ns <= i.start_ns <= i.end_ns <= o.end_ns
    assert i.counts == {"frames": 5, "bytes": 100}
    assert o.counts == {"mode": "lossless", "bytes": 7}


@pytest.mark.parametrize("kind", ["lossless", "lossy", "decode"])
def test_a_call_and_its_result_are_top_spans(kind):
    """Two calls in flight, as the benchmark's loop runs them: dispatch A,
    dispatch B, collect A, collect B. Each is one top span, and every other
    span lies inside one of them."""
    clips = _clips()
    datas = batch.encode_many(clips, RATE, C, analyze=False, device="cpu")
    top = "decode" if kind == "decode" else "encode"

    def call():
        if kind == "decode":
            return batch.decode_many_async(datas, device="cpu")
        if kind == "lossless":
            return batch.encode_many_async(clips, RATE, C, analyze=False, device="cpu")
        return batch.encode_lossy_many_async(clips, RATE, C, 2, analyze=False, device="cpu")

    tracing.enable()
    a = call()
    b = call()
    a.result()
    b.result()
    spans = tracing.take()
    tops = sorted((s for s in spans if s.parent == 0), key=lambda s: s.start_ns)
    assert [s.name for s in tops] == [f"{top}.dispatch"] * 2 + [f"{top}.collect"] * 2
    assert all(x.end_ns <= y.start_ns for x, y in zip(tops, tops[1:]))
    by_id = {s.id: s for s in spans}
    for s in spans:
        root = s
        while root.parent:
            root = by_id[root.parent]
        assert root in tops and root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
    for t in tops:
        assert sum(1 for s in spans if s.parent == t.id) >= 2


def _leaf_counts(spans):
    return {name: len(v) for name, v in _by_name(_leaves(spans)).items()}


def test_lossless_encode_spans_a_chunk():
    clips = _clips()
    lanes, nvalid, frames, active = ll_encoder._marshal(clips, C, RATE)
    assert len(ll_encoder._chunk_bounds(len(nvalid), lanes.size)) == 2
    tracing.enable()
    batch.encode_many(clips, RATE, C, analyze=False, device="cpu")
    spans = tracing.take()
    assert _leaf_counts(spans) == {
        "encode.marshal": 1, "encode.upload": 2, "encode.enqueue": 2, "encode.download": 2,
        "encode.assemble": 2, "encode.write": 1,
    }
    got = _by_name(spans)
    assert sum(s.counts["lanes"] for s in got["encode.enqueue"]) == lanes.shape[0]
    assert got["encode.marshal"][0].counts == {
        "frames": sum(map(len, frames)), "active_frames": len(active)}
    assert sum(s.counts["frames"] for s in got["encode.assemble"]) == len(active)
    (disp,) = got["encode.dispatch"]
    assert disp.counts == {"mode": "lossless", "files": 4, "samples": sum(map(np.size, clips))}
    assert got["encode.write"][0].counts["files"] == 4


def test_lossy_encode_spans_a_chunk():
    clips = _clips()
    stacked, hops = ly_encoder._marshal(clips, C, np.float32)
    tracing.enable()
    batch.encode_lossy_many(clips, RATE, C, 2, analyze=False, device="cpu")
    spans = tracing.take()
    assert _leaf_counts(spans) == {
        "encode.marshal": 1, "encode.upload": 2, "encode.enqueue": 2, "encode.download": 2,
        "encode.sparse_rle": 1, "encode.assemble": 1, "encode.write": 1,
    }
    got = _by_name(spans)
    assert sum(s.counts["lanes"] for s in got["encode.enqueue"]) == stacked.shape[0]
    assert got["encode.marshal"][0].counts == {"frames": sum(hops)}
    assert got["encode.assemble"][0].counts == {"frames": sum(hops)}
    assert got["encode.sparse_rle"][0].counts["nonzeros"] > 0
    assert got["encode.write"][0].counts["bytes"] > 0


def test_lossless_decode_spans():
    clips = _clips()
    datas = batch.encode_many(clips, RATE, C, analyze=False, device="cpu")
    flos = [reader.read(d) for d in datas]
    arrays = ll_decoder._concat_group([(i, ll_decoder._marshal_lanes(f))
                                       for i, f in enumerate(flos)])
    tracing.enable()
    batch.decode_many(datas, device="cpu")
    spans = tracing.take()
    # decode.parse twice: the files' Rice parse, then the channel group's
    # concatenation.
    assert _leaf_counts(spans) == {
        "decode.read": 1, "decode.parse": 2, "decode.upload": 1, "decode.enqueue": 1,
        "decode.download": 1, "decode.finish": 1,
    }
    got = _by_name(spans)
    assert got["decode.read"][0].counts == {"bytes": sum(map(len, datas))}
    assert [s.counts for s in got["decode.parse"]] == [
        {"mode": "lossless"}, {"mode": "lossless", "frames": len(arrays[5])}]
    assert got["decode.enqueue"][0].counts == {"lanes": len(arrays[0])}


def test_lossy_decode_spans_a_chunk():
    clips = _clips()
    datas = batch.encode_lossy_many(clips, RATE, C, 2, analyze=False, device="cpu")
    flos = [reader.read(d) for d in datas]
    n, ch, _, counts, sf, streams = ly_decoder._parse_batch(flos)
    entries, nnz = ly_decoder._sparse_entries(streams, n // 2)
    tracing.enable()
    batch.decode_many(datas, device="cpu")
    spans = tracing.take()
    assert _leaf_counts(spans) == {
        "decode.read": 1, "decode.parse": 1, "decode.upload": 2, "decode.enqueue": 2,
        "decode.download": 2, "decode.finish": 2,
    }
    got = _by_name(spans)
    assert sum(s.counts["files"] for s in got["decode.enqueue"]) == len(datas)
    assert got["decode.parse"][0].counts == {
        "mode": "lossy", "frames": int(counts.sum()), "nonzeros": len(entries)}


def _stages(spans, names):
    return [s.name for s in sorted(spans, key=lambda s: s.start_ns) if s.name in names]


def test_the_decodes_upload_and_launch_a_shard_or_group_at_a_time():
    """Each shard of a lossy chunk, and each channel group of a lossless
    batch, is uploaded and then launched before the next is uploaded, so a
    device's decode overlaps the next upload."""
    clips = _clips()
    mono = [c.reshape(-1, C)[:, 0].copy() for c in clips[:2]]
    lossless = (batch.encode_many(clips[:2], RATE, C, analyze=False, device="cpu")
                + batch.encode_many(mono, RATE, 1, analyze=False, device="cpu"))
    lossy = batch.encode_lossy_many(clips, RATE, C, 2, analyze=False, device="cpu")
    stages = {"decode.parse", "decode.upload", "decode.enqueue"}
    tracing.enable()
    batch.decode_many(lossless, device="cpu")
    assert _stages(tracing.take(), stages) == ["decode.parse"] + [
        "decode.parse", "decode.upload", "decode.enqueue"] * 2
    with pipeline.use_mesh(pipeline.Mesh(("cpu", "cpu"))):
        batch.decode_many(lossy, device="cpu")
    assert _stages(tracing.take(), stages) == ["decode.parse"] + [
        "decode.upload", "decode.enqueue"] * 4


def _all_outputs(clips):
    ll = batch.encode_many(clips, RATE, C, analyze=False, device="cpu")
    ly = batch.encode_lossy_many(clips, RATE, C, 2, analyze=False, device="cpu")
    return ll, ly, batch.decode_many(ll, device="cpu"), batch.decode_many(ly, device="cpu")


def test_outputs_do_not_depend_on_tracing(tmp_path):
    clips = _clips()
    off = _all_outputs(clips)
    tracing.enable()
    on = _all_outputs(clips)
    tracing.disable()
    assert tracing.take()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        profiled = _all_outputs(clips)
    kept = tracing.take()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    for got in (on, profiled):
        assert got[0] == off[0] and got[1] == off[1]
        assert all(np.array_equal(a, b) for a, b in zip(got[2] + got[3], off[2] + off[3]))
    events = json.loads(path.read_text())
    events = events.get("traceEvents", events) if isinstance(events, dict) else events
    marks = {e["name"] for e in events if str(e.get("cat", "")).lower() == "user_annotation"}
    assert {s.name for s in kept} <= marks
    assert {"encode.marshal", "encode.write", "decode.parse", "decode.finish"} <= marks
    assert not tracing.recording()


def test_a_worker_threads_span_is_kept():
    tracing.enable()
    box = []

    def work():
        with tracing.span("encode.worker", files=1):
            box.append(threading.get_ident())

    t = threading.Thread(target=work)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    (s,) = tracing.take()
    assert s.name == "encode.worker" and s.thread == box[0] != threading.get_ident()
    assert s.parent == 0 and s.counts == {"files": 1}


def test_the_record_is_bounded_and_summarised():
    tracing.enable()
    for _ in range(tracing.CAPACITY + 10):
        with tracing.span("outer"):
            with tracing.span("inner"):
                pass
    summary = tracing.summary()["spans"]
    assert summary["outer"]["calls"] + summary["inner"]["calls"] == tracing.CAPACITY
    for d in summary.values():
        assert 0 <= d["self_ms"] <= d["total_ms"]
    assert len(tracing.take()) == tracing.CAPACITY
    assert tracing.take() == []
