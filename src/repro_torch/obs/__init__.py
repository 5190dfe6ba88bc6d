"""Runtime telemetry plane of the port (its own copy of the reference's
``repro.obs``).

One low-overhead subsystem threaded through every serving layer:

* :mod:`repro_torch.obs.metrics` — thread-safe :class:`MetricRegistry` of
  counters, gauges, and log-bucketed histograms (p50/p95/p99/max without
  stored samples), a process-global default, and the strict no-op
  :class:`NullRegistry` so disabled telemetry costs one attribute lookup;
* :mod:`repro_torch.obs.trace`   — nested ``span("store.sync.flip")``
  tracing with monotonic stamps that also enters
  ``torch.profiler.record_function`` (and an NVTX range on a CUDA build),
  so wall-clock spans line up with the card's kernels in a profiler trace;
* :mod:`repro_torch.obs.export`  — Prometheus-style text exposition plus a
  bounded JSONL :class:`TelemetrySink`.

Instrumented layers: the engine's dispatch (``engine_lookup``,
``engine_diff``, ``engine_chain_walk``, ``bounded_assign``),
:class:`~repro_torch.core.image_store.DeviceImageStore` syncs,
:class:`~repro_torch.serve.router.SessionRouter`,
:class:`~repro_torch.serve.plane.ShardedLookupPlane`, and
:mod:`repro_torch.launch.replicate`.  ``ScenarioDriver(telemetry=True)``
scopes a registry to one replay; ``obs.enable()`` turns the process-global
default on.  Counters, gauges, histogram counts, span trees and sink
events equal the reference's on the same resolved trace.
"""
from .export import NullSink, TelemetrySink, render_prometheus, snapshot_text
from .metrics import (Counter, Gauge, Histogram, MetricRegistry, NullRegistry,
                      bucket_index, bucket_upper, default_registry, disable, enable,
                      ensure_real, set_default_registry)
from .trace import NullTracer, Span, Tracer

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricRegistry", "NullRegistry",
    "NullSink", "NullTracer", "Span", "TelemetrySink", "Tracer",
    "bucket_index", "bucket_upper", "default_registry", "disable",
    "enable", "ensure_real", "render_prometheus", "set_default_registry",
    "snapshot_text",
]
