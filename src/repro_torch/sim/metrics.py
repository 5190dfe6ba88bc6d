"""Scenario metrics: what one replay measured (the port's own copy of the
reference's ``sim/metrics.py``).

:class:`ScenarioMetrics` accumulates, per replayed trace:

* **movement**: probe keys moved per membership event (the engine's
  fused epoch diff),
* **control plane**: 32-bit words sent host→device per sync (delta or
  snapshot, from the store's ``SyncStats``) and the epoch-flip latency,
* **data plane**: lookup/route time per key of each traffic event,
* **degradation**: (fraction removed, mean host lookup steps) points,
* **replication**: with followers, each event's follower lag and the
  publish round's frames, bytes and leader sends,
* **fingerprint**: a running CRC32 over every data-plane result, the same
  bytes the reference folds, so fingerprints compare across packages.

``summary()`` gives the reference's summary keys.

The accumulators are ``sim.*`` counters and histograms on a
:class:`~repro_torch.obs.metrics.MetricRegistry`: the driver's scoped
registry when one is injected (``ScenarioDriver(telemetry=...)``), else a
private one, so replay summaries and live telemetry read the same numbers.
With an injected live registry, ``summary()`` embeds its snapshot under
``"telemetry"``.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass, field

import numpy as np

from repro_torch.obs.metrics import ensure_real


@dataclass
class EventRecord:
    """One replayed trace event."""

    index: int
    op: str
    buckets: list[int] = field(default_factory=list)  # resolved victims/joiners
    moved: int = 0            # probe keys moved (membership events)
    sync_mode: str = ""       # "delta" | "snapshot" | "noop"
    sync_words: int = 0
    sync_us: float = 0.0      # epoch-flip latency (sync and device wait)
    keys: int = 0             # traffic batch size (lookup/route)
    us_per_key: float = 0.0
    violations: int = 0
    # overlapped sync: the time to dispatch the async delta apply (what the
    # hot path pays) beside sync_us, the whole dispatch-to-flip latency
    dispatch_us: float = 0.0
    # replication: epochs the slowest follower was behind when this
    # event's publish round shipped (0 = converged already), and that
    # round's frames the publisher encoded, bytes across any link (relays
    # included) and frame sends the leader paid
    follower_lag: int = 0
    wire_frames: int = 0
    wire_bytes: int = 0
    leader_sends: int = 0


class ScenarioMetrics:
    """The accumulator the driver feeds; one per replay.

    ``registry``: a live :class:`~repro_torch.obs.metrics.MetricRegistry`
    to accumulate on (the driver's telemetry plane); ``None`` gets a
    private one.  Either way the ``sim.*`` instruments on that registry
    are the accumulators ``summary()`` reads.
    """

    #: membership ops whose movement and sync fields feed the summary
    MEMBER_OPS = ("remove", "add", "fail", "restore")

    def __init__(self, registry=None) -> None:
        self.obs = ensure_real(registry)
        self._embed = registry is not None and getattr(registry, "active", False)
        self.records: list[EventRecord] = []
        self.degradation: list[tuple[float, float]] = []
        self.followers = 0     # in-process replication followers
        self.fanout_depth = 0  # relay hops leader → farthest follower
        self._crc = 0
        # per-op traffic is labelled, not blended: lookup, assign, and
        # route timings are different code paths
        self._ops: set[str] = set()

    def add_record(self, rec: EventRecord) -> None:
        self.records.append(rec)
        reg = self.obs
        reg.counter("sim.events").inc()
        if rec.violations:
            reg.counter("sim.violations").inc(rec.violations)
        if rec.op in self.MEMBER_OPS:
            reg.counter("sim.membership_events").inc(len(rec.buckets))
            if rec.moved:
                reg.counter("sim.moved_probe").inc(rec.moved)
            if rec.sync_mode == "delta":
                reg.counter("sim.delta_applies").inc()
                reg.counter("sim.delta_words").inc(rec.sync_words)
            elif rec.sync_mode == "snapshot":
                reg.counter("sim.snapshot_rebuilds").inc()
                reg.counter("sim.snapshot_words").inc(rec.sync_words)
            if rec.sync_mode:
                reg.histogram("sim.sync.us").observe(rec.sync_us)
                if rec.dispatch_us:
                    reg.histogram("sim.dispatch.us").observe(rec.dispatch_us)
            if rec.wire_frames:
                reg.counter("sim.wire_frames").inc(rec.wire_frames)
                reg.counter("sim.wire_bytes").inc(rec.wire_bytes)
                reg.counter("sim.leader_sends").inc(rec.leader_sends)
        if rec.keys and rec.us_per_key:
            self._ops.add(rec.op)
            reg.counter("sim.traffic_keys", op=rec.op).inc(rec.keys)
            reg.histogram("sim.traffic_s", op=rec.op).observe(
                rec.us_per_key * rec.keys / 1e6)

    def fingerprint_update(self, arr) -> None:
        """Fold a data-plane result into the replay fingerprint."""
        a = np.ascontiguousarray(np.asarray(arr, dtype=np.int64))
        self._crc = zlib.crc32(a.tobytes(), self._crc)

    def add_degradation_point(self, frac_removed: float, mean_steps: float) -> None:
        self.degradation.append((float(frac_removed), float(mean_steps)))

    @property
    def fingerprint(self) -> str:
        return f"{self._crc & 0xFFFFFFFF:08x}"

    def summary(self) -> dict:
        reg = self.obs

        def c(name: str, **labels) -> int:
            return reg.counter(name, **labels).value

        flips = reg.histogram("sim.sync.us")
        out = {
            "events": c("sim.events"),
            "membership_events": c("sim.membership_events"),
            "moved_probe_total": c("sim.moved_probe"),
            "delta_words_total": c("sim.delta_words"),
            "snapshot_words_total": c("sim.snapshot_words"),
            "snapshot_rebuilds": c("sim.snapshot_rebuilds"),
            "delta_applies": c("sim.delta_applies"),
            "epoch_flip_us_mean": flips.mean if flips.count else 0.0,
            "violations": c("sim.violations"),
            "fingerprint": self.fingerprint,
        }
        dispatch = reg.histogram("sim.dispatch.us")
        if dispatch.count:
            out["sync_dispatch_us_mean"] = dispatch.mean
        if self.followers:
            lags = [r.follower_lag for r in self.records
                    if r.op in self.MEMBER_OPS]
            out["followers"] = self.followers
            out["follower_lag_max"] = int(max(lags, default=0))
            out["follower_lag_mean"] = float(np.mean(lags)) if lags else 0.0
            out["fanout_depth"] = self.fanout_depth
            out["wire_frames_total"] = c("sim.wire_frames")
            out["wire_bytes_total"] = c("sim.wire_bytes")
            out["leader_sends_total"] = c("sim.leader_sends")
        for op in sorted(self._ops):
            keys = c("sim.traffic_keys", op=op)
            out[f"{op}_keys_total"] = keys
            out[f"{op}_us_per_key"] = (
                reg.histogram("sim.traffic_s", op=op).sum / keys * 1e6)
        if self.degradation:
            out["degradation"] = [[f, s] for f, s in self.degradation]
        if self._embed:
            # the whole serving stack's registry snapshot rides along
            out["telemetry"] = self.obs.snapshot()
        return out
