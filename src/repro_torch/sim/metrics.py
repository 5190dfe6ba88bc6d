"""Scenario metrics: what one replay measured (the port's own copy of the
reference's ``sim/metrics.py``, without its telemetry registry).

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
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass, field

import numpy as np


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
    """The accumulator the driver feeds; one per replay."""

    #: membership ops whose movement and sync fields feed the summary
    MEMBER_OPS = ("remove", "add", "fail", "restore")

    def __init__(self) -> None:
        self.records: list[EventRecord] = []
        self.degradation: list[tuple[float, float]] = []
        self.followers = 0     # in-process replication followers
        self.fanout_depth = 0  # relay hops leader → farthest follower
        self._crc = 0

    def add_record(self, rec: EventRecord) -> None:
        self.records.append(rec)

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
        member = [r for r in self.records if r.op in self.MEMBER_OPS]
        synced = [r for r in member if r.sync_mode]
        dispatched = [r.dispatch_us for r in synced if r.dispatch_us]
        out = {
            "events": len(self.records),
            "membership_events": sum(len(r.buckets) for r in member),
            "moved_probe_total": sum(r.moved for r in member),
            "delta_words_total": sum(r.sync_words for r in member
                                     if r.sync_mode == "delta"),
            "snapshot_words_total": sum(r.sync_words for r in member
                                        if r.sync_mode == "snapshot"),
            "snapshot_rebuilds": sum(r.sync_mode == "snapshot" for r in member),
            "delta_applies": sum(r.sync_mode == "delta" for r in member),
            "epoch_flip_us_mean": (float(np.mean([r.sync_us for r in synced]))
                                   if synced else 0.0),
            "violations": sum(r.violations for r in self.records),
            "fingerprint": self.fingerprint,
        }
        if dispatched:
            out["sync_dispatch_us_mean"] = float(np.mean(dispatched))
        if self.followers:
            lags = [r.follower_lag for r in member]
            out["followers"] = self.followers
            out["follower_lag_max"] = int(max(lags, default=0))
            out["follower_lag_mean"] = float(np.mean(lags)) if lags else 0.0
            out["fanout_depth"] = self.fanout_depth
            out["wire_frames_total"] = sum(r.wire_frames for r in member)
            out["wire_bytes_total"] = sum(r.wire_bytes for r in member)
            out["leader_sends_total"] = sum(r.leader_sends for r in member)
        traffic = [r for r in self.records if r.keys and r.us_per_key]
        for op in sorted({r.op for r in traffic}):
            recs = [r for r in traffic if r.op == op]
            keys = sum(r.keys for r in recs)
            out[f"{op}_keys_total"] = keys
            out[f"{op}_us_per_key"] = sum(r.us_per_key * r.keys for r in recs) / keys
        if self.degradation:
            out["degradation"] = [[f, s] for f, s in self.degradation]
        return out
