"""Futures for the bulk pipelines: dispatch now, collect later.

A bulk ``*_many_async`` call marshals its input on the host, uploads it and
enqueues the device work on the CUDA stream of each device, then returns a
:class:`BulkFuture` without waiting for the card. Stream order keeps the
work of successive calls in sequence, so a caller can dispatch the next batch
before collecting this one, and the host's marshal of one batch overlaps the
card's work on the other. ``result()`` does the blocking downloads and the
host's finishing work (frame assembly, the container writer, the trim and
interleave of a decode), once; later calls return the same value.
"""

from __future__ import annotations

from typing import Callable, Generic, TypeVar

from . import tracing

T = TypeVar("T")


class BulkFuture(Generic[T]):
    """Deferred collection of an already-dispatched bulk operation. With
    ``span``, ``result()`` records a span of that name, with ``counts``,
    around the collect."""

    __slots__ = ("_collect", "_out", "_span", "_counts")

    def __init__(self, collect: Callable[[], T], span: str | None = None, **counts):
        self._collect = collect
        self._out: T | None = None
        self._span, self._counts = span, counts

    def result(self) -> T:
        if self._collect is not None:
            if self._span is None:
                self._out = self._collect()
            else:
                with tracing.span(self._span, **self._counts):
                    self._out = self._collect()
            self._collect = None
        return self._out  # type: ignore[return-value]

    def then(self, fn: Callable[[T], "BulkFuture | object"], span: str | None = None,
             **counts) -> "BulkFuture":
        """Chain a host-side transformation (lazy; no dispatch happens here);
        ``span`` and ``counts`` name the chained future's collect."""
        def chained():
            out = fn(self.result())
            return out.result() if isinstance(out, BulkFuture) else out
        return BulkFuture(chained, span, **counts)
