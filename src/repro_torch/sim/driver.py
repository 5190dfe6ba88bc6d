"""Trace replay through the port's serving stack (the port's own copy of
the reference's ``sim/driver.py``, cut to this slice).

:class:`ScenarioDriver` feeds a :class:`~repro_torch.sim.traces.Trace`
event by event through the objects that serve traffic:

* membership events mutate the host consistent-hash state (its delta log
  records the deltas),
* every sync drains ``device_delta()`` into the driver's
  :class:`~repro_torch.core.image_store.DeviceImageStore` (``delta_apply``
  kernel, double-buffered epoch flip),
* traffic runs ``store.lookup`` (the ``{algo}_lookup`` kernel, or
  ``{algo}_replica`` for k > 1), with ``sharded=True`` a
  :class:`~repro_torch.serve.plane.ShardedLookupPlane` over the store (one
  per k, on the store's device), or the scalar host state on
  ``plane="host"``; bounded assignment runs
  :func:`~repro_torch.kernels.engine.bounded_assign` (the ``{algo}_walk``
  kernel), or ``bounded_assign_ref`` on the host; session traffic runs a
  :class:`~repro_torch.serve.router.SessionRouter` sharing the driver's
  store,
* after each synced membership event the guarantee checkers
  (:mod:`repro_torch.sim.checkers`) read ``store.migration_diff`` (the
  ``{algo}_diff`` kernel, and ``{algo}_replica_diff`` for the
  replica-stability check when ``replica_k > 1``) over a fixed probe
  batch, as numpy,
* with ``followers=F`` a :class:`~repro_torch.launch.replicate.ReplicationGroup`
  of F followers on the store's device publishes after each synced
  membership event (``repl_config`` passes its topology, arity,
  ``batch_epochs`` and ``packed``); the followers replay the frames
  through ``delta_apply`` and the convergence checker holds their
  fingerprints to the store's.

Planes: ``"host"`` answers traffic from the host state; ``"device"`` from
the store on ``device`` — the CUDA kernels on ``"cuda"`` (the default),
their plain torch versions on ``"cpu"``.  These replace the reference's
``("host", "jnp", "pallas")``.  The driver never moves to the CPU on its
own.

Determinism: victims come from one seeded stream, traffic keys from a
second (both from ``trace.seed``, as in the reference), so a replay of the
resolved trace draws identical traffic and reproduces every placement;
``result.fingerprint`` equals the reference's on the same trace.

Telemetry: ``telemetry=True`` scopes a fresh
:class:`~repro_torch.obs.metrics.MetricRegistry` to the replay (a registry
object is used as it is; ``False``, the default, leaves every component
on the process default).  The registry is injected into the store, the
router, the sharded planes, the replication group and the metrics, and
installed as the process default for the length of ``run()`` so the
engine's dispatches record there too; ``summary()["telemetry"]`` is its
snapshot.  Its counters, gauges, histogram counts, span tree and sink
events equal the reference's on the same resolved trace, and telemetry
never changes a placement.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.bounded import bounded_assign_ref
from repro_torch.core.hashing import np_fmix32
from repro_torch.core.image_store import DeviceImageStore
from repro_torch.core.protocol import ALGORITHM_REGISTRY, make_hash, replica_sets
from repro_torch.kernels.engine import bounded_assign, bounded_load_len
from repro_torch.obs.metrics import MetricRegistry, set_default_registry
from repro_torch.serve.plane import ShardedLookupPlane

from .checkers import (Violation, candidate_hits, check_balance, check_cap_invariant,
                       check_follower_convergence, check_minimal_disruption,
                       check_replica_stability)
from .metrics import EventRecord, ScenarioMetrics
from .traces import Trace, TraceEvent

PLANES = ("host", "device")


def _numpy(x) -> np.ndarray:
    """A lookup result as numpy (a tensor is copied off its device)."""
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def pick_victim(h, select: str, rng: np.random.Generator,
                bucket: int | None = None) -> int:
    """Resolve ONE removal victim against the live working set.  LIFO-only
    algorithms (Jump, Power) degrade every policy to LIFO; an explicit
    ``bucket`` wins over any policy."""
    if bucket is not None:
        return bucket
    if ALGORITHM_REGISTRY[h.name].lifo_only:
        return h.size - 1
    ws = sorted(h.working_set())
    if select == "lifo":
        return ws[-1]
    if select == "first":
        return ws[0]
    if select == "random":
        return ws[int(rng.integers(len(ws)))]
    raise ValueError(f"unresolvable victim policy {select!r}")


def resolve_victims(h, ev: TraceEvent, rng: np.random.Generator,
                    num_domains: int | None = None) -> list[int]:
    """The whole burst's victims, resolved BEFORE any removal mutates the
    state.  Always leaves at least one working bucket."""
    budget = h.working - 1
    if ev.select == "domain":
        nd = num_domains or 1
        members = [b for b in sorted(h.working_set()) if b % nd == ev.domain]
        if ALGORITHM_REGISTRY[h.name].lifo_only:  # a LIFO burst of that size
            return [h.size - 1 - i for i in range(min(len(members), budget))]
        return members[:budget]
    count = min(ev.count, budget)
    if ev.bucket is not None:
        return [ev.bucket]
    if ALGORITHM_REGISTRY[h.name].lifo_only:
        return [h.size - 1 - i for i in range(count)]
    ws = np.asarray(sorted(h.working_set()))
    if ev.select == "random":
        return [int(b) for b in rng.choice(ws, size=count, replace=False)]
    if ev.select == "lifo":
        return [int(b) for b in ws[::-1][:count]]
    if ev.select == "first":
        return [int(b) for b in ws[:count]]
    raise ValueError(f"unresolvable victim policy {ev.select!r}")


@dataclass
class ScenarioResult:
    """One replay: metrics, violations, and the resolved (replayable) trace."""

    trace: Trace
    algo: str
    plane: str
    metrics: ScenarioMetrics
    violations: list[Violation] = field(default_factory=list)
    resolved: Trace | None = None
    final_working: int = 0
    final_epoch: int = 0

    @property
    def fingerprint(self) -> str:
        return self.metrics.fingerprint

    @property
    def ok(self) -> bool:
        return not self.violations

    def summary(self) -> dict:
        out = {"scenario": self.trace.name, "algo": self.algo,
               "plane": self.plane, "seed": self.trace.seed,
               "initial_nodes": self.trace.initial_nodes,
               "final_working": self.final_working,
               "final_epoch": self.final_epoch}
        out.update(self.metrics.summary())
        return out


class ScenarioDriver:
    """Replay one trace over one algorithm on one plane (see module doc)."""

    def __init__(self, trace: Trace, *, algo: str = "memento",
                 plane: str = "device", device=None, probe_keys: int = 2048,
                 replica_k: int = 1, check: bool = True, sharded: bool = False,
                 step_sample: int = 256, balance_tol: float = 6.0,
                 sync_mode: str = "block", followers: int = 0,
                 repl_config: dict | None = None, telemetry=False):
        if plane not in PLANES:
            raise ValueError(f"unknown plane {plane!r} (have {PLANES})")
        if sync_mode not in ("block", "overlap"):
            raise ValueError(f"unknown sync_mode {sync_mode!r}")
        self.trace = trace
        self.algo = algo
        self.plane = plane
        self.check = check
        self.replica_k = replica_k
        self.balance_tol = balance_tol
        # "overlap": membership syncs dispatch with sync_async() and the
        # driver commits at the checker boundary — dispatch_us is what the
        # hot path pays, sync_us the full flip latency
        self.sync_mode = sync_mode
        # telemetry: False → off (the process default, normally the
        # NullRegistry); True → a fresh scoped registry; a registry → as it is
        if telemetry:
            self.obs = (telemetry if getattr(telemetry, "active", False)
                        else MetricRegistry())
        else:
            self.obs = None
        self.h = make_hash(algo, trace.initial_nodes,
                           capacity=trace.capacity_factor * trace.initial_nodes,
                           variant="32")
        # the ONE store every consumer shares (router included); the host
        # plane still needs it for delta bookkeeping and the epoch diff
        self.store = DeviceImageStore(self.h, device=device, registry=self.obs)
        # independent streams: membership victims vs traffic keys
        self._rng_member = np.random.default_rng([trace.seed, 0])
        self._rng_traffic = np.random.default_rng([trace.seed, 1])
        self.probe = np.random.default_rng([trace.seed, 2]).integers(
            0, 2**32, size=probe_keys, dtype=np.uint32)
        self._step_sample = self.probe[:step_sample]
        self.metrics = ScenarioMetrics(registry=self.obs)
        self.violations: list[Violation] = []
        self._router = None
        self._sharded = sharded
        self._planes_sharded: dict[int, ShardedLookupPlane] = {}  # k → plane
        # membership applied since the last sync (checker comparands)
        self._pending_removed: set[int] = set()
        self._pending_added: set[int] = set()
        self._pending_hits: np.ndarray | None = None
        self._resolved_events: list[TraceEvent] = []
        self._route_prev: np.ndarray | None = None
        # in-process followers on the store's device; the first publish
        # ships the initial snapshot
        self.repl = None
        if followers:
            from repro_torch.launch.replicate import ReplicationGroup
            self.repl = ReplicationGroup(self.h, followers, device=self.store.device,
                                         registry=self.obs, **(repl_config or {}))
            self.repl.publish()
            self.metrics.followers = followers
            self.metrics.fanout_depth = self.repl.depth

    # -- consumers ----------------------------------------------------------
    @property
    def router(self):
        """Lazy SessionRouter sharing the driver's host state AND store, so
        router-driven membership events ride the same epoch deltas."""
        if self._router is None:
            from repro_torch.serve.router import SessionRouter
            self._router = SessionRouter(
                0, algo=self.h, store=self.store, device=self.store.device,
                replicas_k=self.trace.meta.get("replicas_k", 1),
                sync_mode=self.sync_mode, registry=self.obs)
        return self._router

    # -- traffic ------------------------------------------------------------
    def _draw_keys(self, ev: TraceEvent) -> np.ndarray:
        if ev.dist == "zipf":
            ranks = self._rng_traffic.zipf(ev.skew, size=ev.n_keys)
            return np_fmix32((ranks % (2**32)).astype(np.uint32))
        return self._rng_traffic.integers(0, 2**32, size=ev.n_keys,
                                          dtype=np.uint32)

    def _lookup(self, keys: np.ndarray, k: int = 1) -> np.ndarray:
        k = min(k, self.h.working)
        if self.plane == "host":
            if k == 1:
                return np.asarray([self.h.lookup(int(x)) for x in keys], dtype=np.int32)
            return replica_sets(self.h, keys, k)
        if self._sharded:
            plane = self._planes_sharded.get(k)
            if plane is None:
                plane = self._planes_sharded[k] = ShardedLookupPlane(
                    self.store, k=k, devices=[self.store.device], registry=self.obs)
            return plane.lookup(keys)
        return _numpy(self.store.lookup(keys, k=k))

    # -- the event loop ------------------------------------------------------
    def run(self) -> ScenarioResult:
        # the scoped registry is the process default for the replay, so the
        # engine's dispatches record on it too; always restored
        prev = set_default_registry(self.obs) if self.obs is not None else None
        try:
            for i, ev in enumerate(self.trace.events):
                getattr(self, f"_do_{ev.op}")(i, ev)
        finally:
            if self.obs is not None:
                set_default_registry(prev)
        return ScenarioResult(
            trace=self.trace, algo=self.algo, plane=self.plane,
            metrics=self.metrics, violations=self.violations,
            resolved=Trace(name=f"{self.trace.name}/resolved",
                           seed=self.trace.seed,
                           initial_nodes=self.trace.initial_nodes,
                           capacity_factor=self.trace.capacity_factor,
                           num_domains=self.trace.num_domains,
                           meta=dict(self.trace.meta),
                           events=self._resolved_events),
            final_working=self.h.working,
            final_epoch=self.h.epoch)

    # -- membership ----------------------------------------------------------
    def _do_remove(self, i: int, ev: TraceEvent) -> None:
        victims = resolve_victims(self.h, ev, self._rng_member,
                                  self.trace.num_domains)
        self._pre_membership(set(victims))
        for j, b in enumerate(victims):
            self.h.remove(b)
            self._resolved_events.append(TraceEvent(
                "remove", bucket=b, sync=ev.sync and j == len(victims) - 1))
        if not victims:
            # a collapsed fleet clamps the burst to nothing, but its sync
            # must survive into the resolved trace
            self._resolved_events.append(TraceEvent(
                "remove", count=ev.count, select=ev.select, bucket=ev.bucket,
                domain=ev.domain, sync=ev.sync))
        self._pending_removed.update(victims)
        self._finish_membership(i, "remove", victims, ev.sync)

    def _do_add(self, i: int, ev: TraceEvent) -> None:
        joiners = []
        for _ in range(ev.count):
            try:
                joiners.append(self.h.add())
            except ValueError:
                break  # fixed-capacity algorithm exhausted: a recorded no-op
        self._resolved_events.append(TraceEvent(
            "add", count=max(len(joiners), 1), sync=ev.sync))
        self._pending_added.update(joiners)
        # a restore of a bucket whose removal is still pending cancels it
        self._pending_removed -= set(joiners)
        self._finish_membership(i, "add", joiners, ev.sync)

    def _do_fail(self, i: int, ev: TraceEvent) -> None:
        b = pick_victim(self.h, ev.select, self._rng_member, ev.bucket)
        self._pre_membership({b})
        t0 = time.perf_counter()  # the flip happens inside fail_replica
        self.router.fail_replica(b)  # removes and syncs the shared store
        self._resolved_events.append(TraceEvent("fail", bucket=b))
        self._pending_removed.add(b)
        self._finish_membership(i, "fail", [b], sync=True, synced=True, t0=t0)

    def _do_restore(self, i: int, ev: TraceEvent) -> None:
        joiners = []
        t0 = time.perf_counter()  # the flips happen inside restore_replica
        for _ in range(ev.count):
            try:
                joiners.append(self.router.restore_replica())  # adds and syncs
            except ValueError:
                break
        self._resolved_events.append(TraceEvent(
            "restore", count=max(len(joiners), 1)))
        self._pending_added.update(joiners)
        self._pending_removed -= set(joiners)
        self._finish_membership(i, "restore", joiners, sync=True,
                                synced=True, t0=t0)

    def _do_mark_failed(self, i: int, ev: TraceEvent) -> None:
        b = pick_victim(self.h, ev.select, self._rng_member, ev.bucket)
        self.router.mark_failed(b)
        self._resolved_events.append(TraceEvent("mark_failed", bucket=b, sync=False))
        self.metrics.add_record(EventRecord(i, "mark_failed", buckets=[b]))

    def _pre_membership(self, victims: set[int]) -> None:
        """Walk the replica-stability candidates on the pre-event state."""
        if self.check and self.replica_k > 1 and not self._pending_added:
            hits = candidate_hits(self.h, self.probe, self.replica_k, victims)
            if self._pending_hits is None:
                self._pending_hits = hits
            else:
                self._pending_hits |= hits

    def _finish_membership(self, i: int, op: str, buckets: list[int],
                           sync: bool, synced: bool = False,
                           t0: float | None = None) -> None:
        """``t0`` lets router-driven events (whose sync already ran inside
        fail_replica/restore_replica) start the flip clock before that
        call, so sync_us means the same for every event kind."""
        rec = EventRecord(i, op, buckets=list(buckets))
        if sync:
            if t0 is None:
                t0 = time.perf_counter()
            if not synced:
                if self.sync_mode == "overlap":
                    self.store.sync_async()
                    rec.dispatch_us = (time.perf_counter() - t0) * 1e6
                else:
                    self.store.sync()
            # router-driven events in overlap mode leave a pending handle
            # too: land it before the checkers read the flipped image
            self.store.flush()
            self._wait_for_device()
            rec.sync_us = (time.perf_counter() - t0) * 1e6
            st = self.store.last_sync
            if st is not None:
                rec.sync_mode, rec.sync_words = st.mode, st.words
            conv: list[Violation] = []
            if self.repl is not None:
                rec.follower_lag = max(self.repl.publish(), default=0)
                last = self.repl.last_publish
                rec.wire_frames = last["frames"]
                rec.wire_bytes = last["bytes"]
                rec.leader_sends = last["leader_sends"]
                if self.check:
                    conv = check_follower_convergence(i, self.store.image(),
                                                      self.repl.followers)
                    self.violations.extend(conv)
            rec.violations = len(self._run_checkers(i, rec)) + len(conv)
            self._degradation_point()
            self._pending_removed.clear()
            self._pending_added.clear()
            self._pending_hits = None
        self.metrics.add_record(rec)

    def _wait_for_device(self) -> None:
        if self.store.device.type == "cuda":
            import torch
            torch.cuda.synchronize(self.store.device)

    # -- checkers ------------------------------------------------------------
    def _run_checkers(self, i: int, rec: EventRecord) -> list[Violation]:
        if not (self._pending_removed or self._pending_added):
            return []
        if self.store.previous_image() is None:
            return []
        d = self.store.migration_diff(self.probe)
        old, new = _numpy(d.old), _numpy(d.new)
        rec.moved = int(d.num_moved)
        self.metrics.fingerprint_update(new)
        if not self.check:
            return []
        found = check_minimal_disruption(i, old, new, self._pending_removed,
                                         self._pending_added)
        found += check_balance(i, new, sorted(self.h.working_set()),
                               tol_sigma=self.balance_tol)
        if (self.replica_k > 1 and self._pending_hits is not None
                and not self._pending_added
                and self.h.working >= self.replica_k):
            dk = self.store.migration_diff(self.probe, k=self.replica_k)
            found += check_replica_stability(i, _numpy(dk.moved), self._pending_hits)
        self.violations.extend(found)
        return found

    def _degradation_point(self) -> None:
        """(fraction removed, mean host lookup steps): the graceful-
        degradation profile.  The fraction is of the initial working
        fleet, clamped at 0 when a scale-up grew past it."""
        w0 = max(self.trace.initial_nodes, 1)
        frac = max(0.0, 1.0 - self.h.working / w0)
        steps = [sum(self.h.lookup_trace(int(x))[1:]) for x in self._step_sample]
        self.metrics.add_degradation_point(frac, float(np.mean(steps)))

    # -- traffic events --------------------------------------------------------
    def _do_lookup(self, i: int, ev: TraceEvent) -> None:
        keys = self._draw_keys(ev)
        t0 = time.perf_counter()
        out = self._lookup(keys, k=ev.k)
        us = (time.perf_counter() - t0) / max(len(keys), 1) * 1e6
        self.metrics.fingerprint_update(out)
        self._resolved_events.append(ev)
        self.metrics.add_record(EventRecord(i, "lookup", keys=len(keys),
                                            us_per_key=us))

    def _do_assign(self, i: int, ev: TraceEvent) -> None:
        keys = self._draw_keys(ev)
        cap = int(np.ceil(ev.cap_c * len(keys) / self.h.working))
        image = self.store.image()
        load0 = np.zeros(bounded_load_len(image), np.int32)
        t0 = time.perf_counter()
        if self.plane == "host":
            out, load = bounded_assign_ref(self.h, keys, load0, cap)
        else:
            out, load = bounded_assign(keys, image, load0, cap, device=self.store.device)
        us = (time.perf_counter() - t0) / max(len(keys), 1) * 1e6
        self.metrics.fingerprint_update(out)
        found = check_cap_invariant(i, out, load, cap) if self.check else []
        self.violations.extend(found)
        self._resolved_events.append(ev)
        self.metrics.add_record(EventRecord(i, "assign", keys=len(keys),
                                            us_per_key=us, violations=len(found)))

    def _do_route(self, i: int, ev: TraceEvent) -> None:
        ids = np.arange(ev.n_keys, dtype=np.uint64)  # fixed session fleet
        t0 = time.perf_counter()
        if self.plane == "host":
            out = np.asarray([self.router.route(int(s)) for s in ids], dtype=np.int32)
        else:
            out = _numpy(self.router.route_batch(ids))
            self.router.stats.routed += len(ids)  # the bulk path skips this
        us = (time.perf_counter() - t0) / max(len(ids), 1) * 1e6
        self.metrics.fingerprint_update(out)
        rec = EventRecord(i, "route", keys=len(ids), us_per_key=us)
        # session affinity: sessions that changed replica since the last round
        if self._route_prev is not None and len(self._route_prev) == len(out):
            rec.moved = int((out != self._route_prev).sum())
        self._route_prev = out
        self._resolved_events.append(ev)
        self.metrics.add_record(rec)


def replay(trace: Trace, *, algo: str = "memento", plane: str = "device",
           **kw) -> ScenarioResult:
    """One-call replay: build a :class:`ScenarioDriver` and run it."""
    return ScenarioDriver(trace, algo=algo, plane=plane, **kw).run()
