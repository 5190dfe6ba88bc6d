"""Telemetry export of the port: Prometheus-style exposition and bounded
JSONL events (the port's own copy of the reference's ``obs/export.py``).

Two complementary outputs of one
:class:`~repro_torch.obs.metrics.MetricRegistry`:

* :func:`render_prometheus` — the text exposition format scrape
  endpoints speak: ``# TYPE`` headers, sanitized metric names
  (``store.sync.us`` → ``repro_store_sync_us``), cumulative
  ``_bucket{le="..."}`` lines derived from the registry's log buckets,
  ``_sum``/``_count``, sorted deterministically so two snapshots of the
  same counters render byte-identically.  The port serves the same
  metrics as the reference under the same ``repro_`` prefix, so a
  registry renders to the same bytes in either package.
* :class:`TelemetrySink` — a bounded in-memory JSONL event log (span
  completions from :mod:`repro_torch.obs.trace`, sync/publish events from
  the instrumented layers).  Bounded means a million-event churn storm
  costs O(max_events) host memory; ``dropped`` counts the overflow.

``snapshot_text`` and ``TelemetrySink.to_jsonl`` give a replay's
telemetry as text two runs can diff.
"""
from __future__ import annotations

import json
import re
import threading
from collections import deque

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")
#: every exposed metric name is prefixed — the repo is one job to a scraper
PREFIX = "repro_"


def prom_name(name: str) -> str:
    """Sanitize a registry metric name for the exposition format."""
    return PREFIX + _NAME_RE.sub("_", name)


def _labels_text(labels: dict, extra: dict | None = None) -> str:
    merged = dict(labels)
    if extra:
        merged.update(extra)
    if not merged:
        return ""
    inner = ",".join(f'{k}="{merged[k]}"' for k in sorted(merged))
    return "{" + inner + "}"


def _fmt(v) -> str:
    if isinstance(v, bool):
        return str(int(v))
    if isinstance(v, float):
        if v != v:  # NaN
            return "NaN"
        if v in (float("inf"), float("-inf")):
            return "+Inf" if v > 0 else "-Inf"
        return repr(v)
    return str(v)


def render_prometheus(registry) -> str:
    """The registry as Prometheus text exposition (deterministic order:
    counters, gauges, histograms, each name-sorted)."""
    from .metrics import Counter, Gauge, Histogram, bucket_upper

    counters: dict[str, list] = {}
    gauges: dict[str, list] = {}
    hists: dict[str, list] = {}
    for m in registry.metrics().values():
        group = (counters if isinstance(m, Counter) else
                 gauges if isinstance(m, Gauge) else
                 hists if isinstance(m, Histogram) else None)
        if group is not None:
            group.setdefault(m.name, []).append(m)
    lines: list[str] = []
    for kind, group in (("counter", counters), ("gauge", gauges)):
        for name in sorted(group):
            pname = prom_name(name)
            lines.append(f"# TYPE {pname} {kind}")
            for m in sorted(group[name], key=lambda m: sorted(m.labels.items())):
                lines.append(f"{pname}{_labels_text(m.labels)} {_fmt(m.value)}")
    for name in sorted(hists):
        pname = prom_name(name)
        lines.append(f"# TYPE {pname} histogram")
        for m in sorted(hists[name], key=lambda m: sorted(m.labels.items())):
            cum = 0
            for idx in sorted(m.buckets):
                cum += m.buckets[idx]
                le = _labels_text(m.labels, {"le": f"{bucket_upper(idx):g}"})
                lines.append(f"{pname}_bucket{le} {cum}")
            inf = _labels_text(m.labels, {"le": "+Inf"})
            lines.append(f"{pname}_bucket{inf} {m.count}")
            lt = _labels_text(m.labels)
            lines.append(f"{pname}_sum{lt} {_fmt(m.sum)}")
            lines.append(f"{pname}_count{lt} {m.count}")
    return "\n".join(lines) + ("\n" if lines else "")


def snapshot_text(registry) -> str:
    """``registry.snapshot()`` as canonical (sorted, indented) JSON — the
    deterministic artifact two replays of one resolved trace must agree
    on over counters/gauges."""
    return json.dumps(registry.snapshot(), indent=2, sort_keys=True) + "\n"


class TelemetrySink:
    """Bounded JSONL event log (thread-safe append, FIFO eviction)."""

    def __init__(self, max_events: int = 8192):
        self._lock = threading.Lock()
        self._events: deque[dict] = deque(maxlen=max_events)
        self.max_events = max_events
        self.emitted = 0     # total ever emitted (evictions included)

    @property
    def dropped(self) -> int:
        return self.emitted - len(self._events)

    def emit(self, kind: str, **fields) -> None:
        event = {"kind": kind, **fields}
        with self._lock:
            self._events.append(event)
            self.emitted += 1

    def events(self, kind: str | None = None) -> list[dict]:
        with self._lock:
            evs = list(self._events)
        return evs if kind is None else [e for e in evs if e["kind"] == kind]

    def to_jsonl(self) -> str:
        return "".join(json.dumps(e, sort_keys=True) + "\n"
                       for e in self.events())

    @staticmethod
    def parse_jsonl(text: str) -> list[dict]:
        """Round-trip reader for the artifact tests/CI wrote."""
        return [json.loads(line) for line in text.splitlines() if line]


class NullSink:
    """Do-nothing sink (the NullRegistry's)."""

    max_events = 0
    emitted = 0
    dropped = 0

    def emit(self, kind: str, **fields) -> None:
        pass

    def events(self, kind: str | None = None) -> list:
        return []

    def to_jsonl(self) -> str:
        return ""

    parse_jsonl = staticmethod(TelemetrySink.parse_jsonl)
