"""Spans at the layer boundaries of the bulk paths.

A span is a named stretch of one thread's time: its start and end on
``time.perf_counter_ns()``, the thread, the span open on that thread when it
began (its parent), and counts given at the boundary (frames, lanes, bytes).
A bulk call's collect is a span of its own, recorded by its
:class:`~flo_torch.futures.BulkFuture` when ``result()`` runs.

Recording is on while the switch is on (:func:`enable`) or while a torch
profiler records. Under a profiler each span also opens
``torch.profiler.record_function(name)``, so the stages lie in the
profiler's trace beside the kernels and copies they launched. Off, a span is
one flag test and a shared null context, which is false, so a caller counts
what costs time only ``if sp:``; nothing is kept.

Spans sit at chunk or batch granularity, never inside a loop over frames,
lanes or files. Names are ``<direction>.<stage>`` (``encode.marshal``,
``decode.parse``); the mode is a count field. The newest :data:`CAPACITY`
spans are kept in memory. Readers: :func:`take`, :func:`counters`,
:func:`summary`. Whoever wants a timeline runs the torch profiler.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import defaultdict, deque
from typing import NamedTuple

import torch.autograd.profiler as _profiler

#: Spans kept in memory; older ones are dropped first.
CAPACITY = 65536


class Span(NamedTuple):
    id: int
    name: str
    start_ns: int
    end_ns: int
    thread: int
    parent: int  # the id of the span open on the thread when it began, or 0
    counts: dict


_switch = False
_spans: deque = deque(maxlen=CAPACITY)
_local = threading.local()
_span_ids = itertools.count(1)


def enable() -> None:
    """Record spans until :func:`disable`."""
    global _switch
    _switch = True


def disable() -> None:
    global _switch
    _switch = False


def recording() -> bool:
    """Whether spans are kept now: the switch, or a profiler."""
    return _switch or _profiler._is_profiler_enabled


class _Null:
    """The context every span is while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __bool__(self) -> bool:
        return False


NULL = _Null()


def _stack() -> list:
    """The calling thread's open spans, innermost last."""
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class _Open:
    __slots__ = ("name", "counts", "id", "parent", "start", "mark")

    def __init__(self, name: str, counts: dict):
        self.name, self.counts = name, counts

    def __enter__(self):
        stack = _stack()
        self.id = next(_span_ids)
        self.parent = stack[-1].id if stack else 0
        self.mark = None
        if _profiler._is_profiler_enabled:
            self.mark = _profiler.record_function(self.name)
            self.mark.__enter__()
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end = time.perf_counter_ns()
        _local.stack.pop()
        if self.mark is not None:
            self.mark.__exit__(*exc)
        _spans.append(Span(self.id, self.name, self.start, end, threading.get_ident(),
                           self.parent, self.counts))
        return False

    def add(self, **counts) -> None:
        for k, v in counts.items():
            self.counts[k] = self.counts.get(k, 0) + v


def span(name: str, **counts):
    """A context that records one span (see the module's docstring). ``as
    sp``: ``if sp: sp.add(**counts)`` adds counts known only inside."""
    if not recording():
        return NULL
    return _Open(name, counts)


def take() -> list:
    """The spans kept so far, oldest end first; the record is emptied."""
    out = []
    while True:
        try:
            out.append(_spans.popleft())
        except IndexError:
            return out


def counters() -> dict:
    """Each kernel wrapper's ``LAUNCHES``, read from its module, as
    ``<module>.launches``."""
    from .ops import cuda_lpc, cuda_psycho, cuda_ricepack, cuda_select

    return {f"{mod.__name__.rsplit('.', 1)[1]}.launches": mod.LAUNCHES
            for mod in (cuda_select, cuda_ricepack, cuda_psycho, cuda_lpc)}


def summary() -> dict:
    """Per span name among the kept spans (not emptied): ``total_ms``,
    ``self_ms`` (less the time of its child spans) and ``calls``; and the
    counters, under ``"counters"``."""
    kept = list(_spans)
    child_ns = defaultdict(int)
    for s in kept:
        if s.parent:
            child_ns[s.parent] += s.end_ns - s.start_ns
    names: dict = {}
    for s in kept:
        d = names.setdefault(s.name, {"total_ms": 0.0, "self_ms": 0.0, "calls": 0})
        dur = s.end_ns - s.start_ns
        d["total_ms"] += dur * 1e-6
        d["self_ms"] += (dur - child_ns[s.id]) * 1e-6
        d["calls"] += 1
    return {"spans": names, "counters": counters()}
