"""Runtime metric primitives of the port: counters, gauges, log-bucketed
histograms (the port's own copy of the reference's ``obs/metrics.py``).

The serving stack (engine dispatch, :class:`~repro_torch.core.image_store.DeviceImageStore`
syncs, :class:`~repro_torch.serve.router.SessionRouter`,
:class:`~repro_torch.serve.plane.ShardedLookupPlane`,
:mod:`repro_torch.launch.replicate`) reports through ONE
:class:`MetricRegistry`:

* :class:`Counter`   — a monotonically-increasing **integer**.  Counters
  count events, keys, words, bytes and frames — never wall-clock — so a
  counter snapshot of a deterministic replay is bit-identical across runs,
  and equal to the reference package's on the same resolved trace.
* :class:`Gauge`     — a point-in-time value (pending handles, follower
  lag), set from deterministic state.
* :class:`Histogram` — a **log-bucketed** latency/size distribution:
  observations land in buckets at ``2^(i/4)`` boundaries (4 per octave,
  ≤ 19 % relative quantile error) held as a sparse ``index → count``
  dict, so p50/p95/p99/max come out of O(buckets) state without storing
  samples, and two histograms merge by adding bucket counts.

Enable/disable is a *registry swap*, not per-call flags: the process
default starts as the strict no-op :class:`NullRegistry` (``active``
False, every instrument a shared do-nothing singleton), so disabled
telemetry costs the instrumented path one attribute lookup and a falsy
check.  ``enable()`` installs a real registry;
:class:`~repro_torch.sim.driver.ScenarioDriver`'s ``telemetry=`` scopes one
to a replay.  All mutation is lock-protected: registries are shared by
serving threads racing epoch flips.

The bucket math and the snapshot layout are the reference's exactly, so
the two packages' snapshots and expositions compare key for key.
"""
from __future__ import annotations

import math
import threading

#: log-bucket resolution: 4 buckets per power of two (factor 2^0.25).
BUCKETS_PER_OCTAVE = 4
#: smallest representable observation (values at or below clamp here)
MIN_EXP = -16 * BUCKETS_PER_OCTAVE   # 2^-16
#: largest bucket index (values above clamp; 2^48 µs ≈ 8.9 years)
MAX_EXP = 48 * BUCKETS_PER_OCTAVE


def bucket_index(value: float) -> int:
    """The histogram bucket of ``value``: ``floor(log2(v) · 4)`` clamped
    to [MIN_EXP, MAX_EXP].  Bucket ``i`` covers ``(2^(i/4), 2^((i+1)/4)]``
    exactly at the representable boundaries, so the bucket math is a pure
    function tests can pin."""
    if value <= 2.0 ** (MIN_EXP / BUCKETS_PER_OCTAVE):
        return MIN_EXP
    idx = math.floor(math.log2(value) * BUCKETS_PER_OCTAVE)
    # land exact boundaries 2^(i/4) in the bucket BELOW (half-open above)
    if 2.0 ** (idx / BUCKETS_PER_OCTAVE) >= value:
        idx -= 1
    return min(idx, MAX_EXP)


def bucket_upper(index: int) -> float:
    """Inclusive upper edge of bucket ``index``: ``2^((index+1)/4)``."""
    return 2.0 ** ((index + 1) / BUCKETS_PER_OCTAVE)


class Counter:
    """Thread-safe monotonically-increasing integer."""

    __slots__ = ("name", "labels", "_lock", "_value")

    def __init__(self, name: str, labels: dict | None = None):
        self.name = name
        self.labels = dict(labels or {})
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError("counters only go up (use a Gauge)")
        with self._lock:
            self._value += int(n)

    @property
    def value(self) -> int:
        return self._value


class Gauge:
    """Thread-safe point-in-time value (int or float)."""

    __slots__ = ("name", "labels", "_lock", "_value")

    def __init__(self, name: str, labels: dict | None = None):
        self.name = name
        self.labels = dict(labels or {})
        self._lock = threading.Lock()
        self._value = 0

    def set(self, v) -> None:
        with self._lock:
            self._value = v

    def add(self, n=1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self):
        return self._value


class Histogram:
    """Sparse log-bucketed distribution: quantiles without samples.

    ``observe(v)`` increments the ``bucket_index(v)`` count and folds
    ``v`` into exact ``sum``/``min``/``max`` running aggregates.
    ``quantile(q)`` walks the cumulative bucket counts and returns the
    containing bucket's upper edge clipped to the observed max — a
    deterministic function of the bucket state, in error by at most one
    bucket width (≤ 2^0.25 ≈ 1.19×).
    """

    __slots__ = ("name", "labels", "_lock", "buckets", "count", "sum",
                 "min", "max")

    def __init__(self, name: str, labels: dict | None = None):
        self.name = name
        self.labels = dict(labels or {})
        self._lock = threading.Lock()
        self.buckets: dict[int, int] = {}
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, value: float) -> None:
        value = float(value)
        idx = bucket_index(value)
        with self._lock:
            self.buckets[idx] = self.buckets.get(idx, 0) + 1
            self.count += 1
            self.sum += value
            if value < self.min:
                self.min = value
            if value > self.max:
                self.max = value

    def merge(self, other: "Histogram") -> "Histogram":
        """Fold ``other`` into this histogram (associative and
        commutative over the bucket state, up to float-sum ordering)."""
        with self._lock:
            for idx, c in other.buckets.items():
                self.buckets[idx] = self.buckets.get(idx, 0) + c
            self.count += other.count
            self.sum += other.sum
            self.min = min(self.min, other.min)
            self.max = max(self.max, other.max)
        return self

    def quantile(self, q: float) -> float:
        if not 0.0 <= q <= 1.0:
            raise ValueError("quantile q must be in [0, 1]")
        if self.count == 0:
            return 0.0
        rank = max(1, math.ceil(q * self.count))
        cum = 0
        for idx in sorted(self.buckets):
            cum += self.buckets[idx]
            if cum >= rank:
                return min(bucket_upper(idx), self.max)
        return self.max  # unreachable unless racing observers

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def percentiles(self) -> dict[str, float]:
        """The snapshot quartet: p50/p95/p99/max."""
        return {"p50": self.quantile(0.50), "p95": self.quantile(0.95),
                "p99": self.quantile(0.99),
                "max": self.max if self.count else 0.0}


def _key(name: str, labels: dict) -> str:
    if not labels:
        return name
    inner = ",".join(f'{k}="{labels[k]}"' for k in sorted(labels))
    return f"{name}{{{inner}}}"


class MetricRegistry:
    """Thread-safe name → instrument map, plus the attached tracer/sink.

    ``counter/gauge/histogram`` get-or-create by (name, labels) — hot
    paths may call them per batch; after first creation the cost is one
    locked dict hit.  ``snapshot()`` flattens everything into the
    JSON-able dict ``obs/export.py`` renders and a replay summary embeds.
    """

    active = True

    def __init__(self, *, max_spans: int = 4096, max_events: int = 8192):
        from .export import TelemetrySink
        from .trace import Tracer

        self._lock = threading.Lock()
        self._metrics: dict[str, Counter | Gauge | Histogram] = {}
        self.sink = TelemetrySink(max_events=max_events)
        self.tracer = Tracer(max_spans=max_spans, sink=self.sink)

    def _get(self, cls, name: str, labels: dict):
        key = _key(name, labels)
        m = self._metrics.get(key)  # GIL-safe fast path
        if m is None:
            with self._lock:
                m = self._metrics.get(key)
                if m is None:
                    m = self._metrics[key] = cls(name, labels)
        if not isinstance(m, cls):
            raise TypeError(f"metric {key!r} is a {type(m).__name__}, "
                            f"not a {cls.__name__}")
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(Histogram, name, labels)

    def span(self, name: str, **attrs):
        """Open a trace span on this registry's tracer (obs/trace.py)."""
        return self.tracer.span(name, **attrs)

    def metrics(self) -> dict:
        with self._lock:
            return dict(self._metrics)

    def snapshot(self) -> dict:
        """Flatten to ``{"counters", "gauges", "histograms"}`` with sorted
        keys.  Counters and gauges of a deterministic replay are
        bit-identical across runs; histogram COUNTS are deterministic too
        (one observation per timed event) while their bucket spread is
        wall-clock-dependent — the determinism gate compares the former
        and only requires the latter populated."""
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for key, m in sorted(self.metrics().items()):
            if isinstance(m, Counter):
                out["counters"][key] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][key] = m.value
            else:
                out["histograms"][key] = {
                    "count": m.count, "sum": m.sum, "mean": m.mean,
                    **m.percentiles(),
                    "buckets": {str(i): m.buckets[i]
                                for i in sorted(m.buckets)}}
        return out


class _NullMetric:
    """The do-nothing instrument every NullRegistry call returns."""

    __slots__ = ()
    name = ""
    labels: dict = {}
    value = 0
    count = 0
    sum = 0.0
    mean = 0.0
    min = 0.0
    max = 0.0
    buckets: dict = {}

    def inc(self, n: int = 1) -> None:
        pass

    def set(self, v) -> None:
        pass

    def add(self, n=1) -> None:
        pass

    def observe(self, value: float) -> None:
        pass

    def merge(self, other):
        return self

    def quantile(self, q: float) -> float:
        return 0.0

    def percentiles(self) -> dict:
        return {"p50": 0.0, "p95": 0.0, "p99": 0.0, "max": 0.0}


_NULL_METRIC = _NullMetric()


class NullRegistry:
    """Strict no-op registry: telemetry off.

    Every accessor returns the shared :class:`_NullMetric` singleton, the
    tracer/sink are their null twins, and ``active`` is False so
    instrumented hot paths skip their ``perf_counter`` bookkeeping
    entirely — the disabled cost is one attribute lookup plus a falsy
    check."""

    active = False

    def __init__(self):
        from .export import NullSink
        from .trace import NullTracer

        self.sink = NullSink()
        self.tracer = NullTracer()

    def counter(self, name: str, **labels) -> _NullMetric:
        return _NULL_METRIC

    def gauge(self, name: str, **labels) -> _NullMetric:
        return _NULL_METRIC

    def histogram(self, name: str, **labels) -> _NullMetric:
        return _NULL_METRIC

    def span(self, name: str, **attrs):
        return self.tracer.span(name, **attrs)

    def metrics(self) -> dict:
        return {}

    def snapshot(self) -> dict:
        return {"counters": {}, "gauges": {}, "histograms": {}}


_NULL_REGISTRY = NullRegistry()
_default: MetricRegistry | NullRegistry = _NULL_REGISTRY
_default_lock = threading.Lock()


def default_registry() -> MetricRegistry | NullRegistry:
    """The process-global registry instrumented modules consult when no
    registry was injected (starts as the NullRegistry — telemetry off)."""
    return _default


def set_default_registry(reg) -> MetricRegistry | NullRegistry:
    """Install ``reg`` (None → the NullRegistry) as the process default;
    returns the previous one so scoped callers can restore it."""
    global _default
    with _default_lock:
        prev = _default
        _default = reg if reg is not None else _NULL_REGISTRY
    return prev


def enable(registry: MetricRegistry | None = None) -> MetricRegistry:
    """Turn process-wide telemetry on; returns the installed registry."""
    reg = registry if registry is not None else MetricRegistry()
    set_default_registry(reg)
    return reg


def disable() -> None:
    """Back to the NullRegistry (telemetry off)."""
    set_default_registry(None)


def ensure_real(registry=None) -> MetricRegistry:
    """A registry guaranteed to record: the one given (if active), else a
    private :class:`MetricRegistry`.  Components whose counters are part
    of their public API (router stats, replication lag gauges) use this
    so the API works with telemetry globally off while still landing on
    the shared registry when one is injected."""
    if registry is not None and getattr(registry, "active", False):
        return registry
    return MetricRegistry()
