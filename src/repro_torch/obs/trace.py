"""Span-based runtime tracing of the port (its own copy of the reference's
``obs/trace.py``).

A :class:`Span` is one timed region of the serving stack —
``span("store.sync")`` around an epoch flip, ``span("repl.publish")``
around a replication round — with monotonic
(``time.perf_counter_ns``) start/duration stamps and parent/child
nesting carried by a ``contextvars`` token, so spans opened inside an
open span become its children automatically (including across the
driver's nested store → kernel call chains, and per *logical* context
in threaded servers).

Every completed span is appended to the owning :class:`Tracer`'s bounded
ring and emitted as a ``kind="span"`` event on the registry's
:class:`~repro_torch.obs.export.TelemetrySink` JSONL log.  Where the
reference enters a ``jax.profiler`` named scope, a span here enters
``torch.profiler.record_function(name)``, so it shows up as a named CPU
event of a ``torch.profiler`` trace beside the card's kernels, and, on a
CUDA build of torch, an NVTX range of the same name for an Nsight Systems
timeline.  The tracer decides once, when it is built, whether torch is a
CUDA build; a CPU build has no NVTX (its ``range_push`` raises).

Determinism: span *structure* (names, nesting, order of completion) is a
pure function of the replayed control flow; only the timestamps are
wall-clock, so two packages replaying one trace give the same tree.
"""
from __future__ import annotations

import contextvars
import itertools
import threading
import time
from dataclasses import dataclass, field

import torch
import torch.cuda.nvtx
import torch.profiler

#: the open-span context (span id of the innermost open span, 0 = root)
_CURRENT: contextvars.ContextVar[int] = contextvars.ContextVar(
    "repro_torch_obs_span", default=0)


@dataclass
class Span:
    """One completed (or open) trace region."""

    name: str
    id: int
    parent: int          # 0 = top-level
    depth: int
    start_us: float      # monotonic, relative to the tracer's epoch
    dur_us: float = 0.0
    attrs: dict = field(default_factory=dict)


class Tracer:
    """Bounded completed-span ring + the nesting machinery.

    ``span(name)`` is a context manager AND re-entrant: nested ``with``
    blocks chain parent ids.  The ring keeps the most recent
    ``max_spans`` completed spans (oldest dropped, ``dropped`` counts
    them) — telemetry must stay O(1) memory under million-event storms.
    """

    def __init__(self, *, max_spans: int = 4096, sink=None):
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._epoch_ns = time.perf_counter_ns()
        self.max_spans = max_spans
        self.spans: list[Span] = []
        self.dropped = 0
        self.sink = sink
        # NVTX ranges only on a CUDA build of torch (a CPU build raises)
        self._nvtx = torch.cuda.nvtx if torch.version.cuda is not None else None

    def _now_us(self) -> float:
        return (time.perf_counter_ns() - self._epoch_ns) / 1e3

    def span(self, name: str, **attrs) -> "_SpanContext":
        return _SpanContext(self, name, attrs)

    def _complete(self, span: Span) -> None:
        with self._lock:
            self.spans.append(span)
            if len(self.spans) > self.max_spans:
                drop = len(self.spans) - self.max_spans
                del self.spans[:drop]
                self.dropped += drop
        if self.sink is not None:
            self.sink.emit("span", name=span.name, id=span.id,
                           parent=span.parent, depth=span.depth,
                           start_us=round(span.start_us, 3),
                           dur_us=round(span.dur_us, 3), **span.attrs)

    # -- reading ------------------------------------------------------------
    def completed(self, name: str | None = None) -> list[Span]:
        with self._lock:
            spans = list(self.spans)
        return spans if name is None else [s for s in spans if s.name == name]

    def children_of(self, span: Span) -> list[Span]:
        return [s for s in self.completed() if s.parent == span.id]

    def tree(self) -> list[tuple[int, str, float]]:
        """(depth, name, dur_us) rows in completion order — the compact
        text rendering quickstarts print."""
        return [(s.depth, s.name, s.dur_us) for s in self.completed()]


class _SpanContext:
    """The ``with tracer.span("..."):`` guard."""

    __slots__ = ("_tracer", "_name", "_attrs", "_span", "_token",
                 "_depth_token", "_scope")

    def __init__(self, tracer: Tracer, name: str, attrs: dict):
        self._tracer = tracer
        self._name = name
        self._attrs = attrs
        self._span: Span | None = None
        self._token = None
        self._scope = None

    def __enter__(self) -> Span:
        t = self._tracer
        parent = _CURRENT.get()
        span = Span(name=self._name, id=next(t._ids), parent=parent,
                    depth=0, start_us=t._now_us(), attrs=self._attrs)
        # depth = chain length to the root; the parent is still open (not
        # in the completed ring), so it rides its own contextvar.
        span.depth = _DEPTH.get() + 1
        self._span = span
        self._token = _CURRENT.set(span.id)
        self._depth_token = _DEPTH.set(span.depth)
        self._scope = torch.profiler.record_function(self._name)
        self._scope.__enter__()
        if t._nvtx is not None:
            t._nvtx.range_push(self._name)
        return span

    def __exit__(self, *exc) -> None:
        try:
            if self._tracer._nvtx is not None:
                self._tracer._nvtx.range_pop()
        finally:
            self._scope.__exit__(*exc)
        span = self._span
        span.dur_us = self._tracer._now_us() - span.start_us
        _CURRENT.reset(self._token)
        _DEPTH.reset(self._depth_token)
        self._tracer._complete(span)


_DEPTH: contextvars.ContextVar[int] = contextvars.ContextVar(
    "repro_torch_obs_depth", default=0)


class _NullSpan:
    name = ""
    id = 0
    parent = 0
    depth = 0
    start_us = 0.0
    dur_us = 0.0
    attrs: dict = {}


_NULL_SPAN = _NullSpan()


class _NullSpanContext:
    __slots__ = ()

    def __enter__(self):
        return _NULL_SPAN

    def __exit__(self, *exc) -> None:
        pass


_NULL_SPAN_CTX = _NullSpanContext()


class NullTracer:
    """No-op tracer: ``span()`` returns a shared do-nothing context."""

    max_spans = 0
    spans: list = []
    dropped = 0
    sink = None

    def span(self, name: str, **attrs) -> _NullSpanContext:
        return _NULL_SPAN_CTX

    def completed(self, name: str | None = None) -> list:
        return []

    def children_of(self, span) -> list:
        return []

    def tree(self) -> list:
        return []
