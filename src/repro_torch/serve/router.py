"""Session → replica router: consistent hashing with KV-cache affinity.

Requests carry a session id; the router consistent-hashes sessions onto
model replicas, so a session lands on the replica that holds its cache,
a failed replica remaps only its own sessions, and a restored one takes
back only the sessions that were its.  Bulk routing runs on the device
through a :class:`~repro_torch.core.image_store.DeviceImageStore`:
``fail_replica``/``restore_replica`` push O(changed-words) epoch deltas,
and ``route_batch`` is one lookup launch (``{algo}_lookup``, or
``{algo}_packed_lookup`` with ``compact_images``), or, with
``replicas_k > 1`` and a replica marked failed, one replica launch
whose k-replica sets the failover rule picks from.

Session ids are hashed to uint32 keys on the host, as in the reference.
``route_stream`` streams batches through a
:class:`~repro_torch.serve.plane.ShardedLookupPlane` over the router's
store: key chunks fanned over a device list, one batch in flight.

Telemetry (:mod:`repro_torch.obs`): ``registry=`` (else the process
default at each call) receives the reference's ``router.*`` instruments,
and :class:`RouterStats` is a view over the ``router.*`` counters, on a
private registry when telemetry is off.
"""
from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.hashing import key_to_u32, np_key_to_u32
from repro_torch.core.image_store import DeviceImageStore
from repro_torch.core.protocol import make_hash
from repro_torch.device import resolve_device, resolve_devices
from repro_torch.obs.metrics import default_registry as _default_obs
from repro_torch.obs.metrics import ensure_real
from repro_torch.serve.plane import ShardedLookupPlane


class RouterStats:
    """Live view over the router's ``router.*`` telemetry counters.

    ``stats.routed`` reads a counter and ``stats.routed += n`` adds to it,
    so the numbers reach the registry's exporters.  With telemetry off the
    view rides a private registry (:func:`~repro_torch.obs.metrics.ensure_real`),
    so the API never goes dark.  A write is a delta on a monotonic
    counter: setting a smaller value does nothing."""

    FIELDS = ("routed", "moved_on_failure", "affinity_hits", "failovers")

    def __init__(self, registry=None):
        object.__setattr__(self, "_counters",
                           {f: ensure_real(registry).counter(f"router.{f}")
                            for f in self.FIELDS})

    def __getattr__(self, name):
        counters = object.__getattribute__(self, "_counters")
        if name in counters:
            return counters[name].value
        raise AttributeError(name)

    def __setattr__(self, name, value) -> None:
        counters = self._counters
        if name in counters:
            delta = int(value) - counters[name].value
            if delta > 0:
                counters[name].inc(delta)
            return
        object.__setattr__(self, name, value)

    def as_dict(self) -> dict:
        return {f: getattr(self, f) for f in self.FIELDS}

    def __repr__(self) -> str:
        inner = ", ".join(f"{f}={getattr(self, f)}" for f in self.FIELDS)
        return f"RouterStats({inner})"


class SessionRouter:
    """Session → replica router.  With ``replicas_k > 1`` every session has
    a k-replica set (salted ``lookup_k``; replica 0 is the plain
    placement) and a replica marked failed (:meth:`mark_failed`) is failed
    over to the next one before its membership delta lands.

    ``device`` defaults to ``"cuda"``; with no GPU the constructor raises
    unless the caller passes ``device="cpu"``.  ``sync_mode="overlap"``
    dispatches membership deltas with ``sync_async()`` and lands the flip
    at the next batch boundary.  ``compact_images=True`` keeps the packed
    layout on the device (``DeviceImageStore(compact=True)``: for Memento
    a bitmap and a Θ(r) slot table instead of the Θ(n) ``repl`` array).
    ``registry`` is the telemetry registry of the router, of the store it
    builds and of its planes (``None``: the process default).
    """

    def __init__(self, num_replicas: int, *, algo="memento",
                 capacity: int | None = None, device=None,
                 max_sessions: int = 1_000_000, replicas_k: int = 1,
                 store: DeviceImageStore | None = None,
                 compact_images: bool = False,
                 sync_mode: str = "block", registry=None):
        self.device = resolve_device(device)
        if isinstance(algo, str):
            # variant="32": host lookups bit-identical to the device
            self.ch = make_hash(algo, num_replicas, capacity=capacity, variant="32")
        else:
            self.ch = algo
        if replicas_k < 1:
            raise ValueError("replicas_k must be ≥ 1")
        if sync_mode not in ("block", "overlap"):
            raise ValueError(f"unknown sync_mode {sync_mode!r}")
        self.replicas_k = replicas_k
        self.sync_mode = sync_mode
        self.compact_images = compact_images
        self._registry = registry  # None → follow the process default
        # on the injected registry when it records, else on the process
        # default, else on the view's own private registry
        self.stats = RouterStats(registry or _default_obs())
        self.max_sessions = max_sessions
        # session id → last replica, LRU-bounded
        self._last: OrderedDict = OrderedDict()
        # an injected store must wrap the same host state
        if store is not None and store._ch is not self.ch:
            raise ValueError("injected store wraps a different host state")
        self._store: DeviceImageStore | None = store
        # replicas marked failed whose removal has not landed on the device
        self._failed: set[int] = set()
        # overlap mode: replica → host epoch whose landing clears the mark
        self._unmark_at: dict[int, int] = {}
        # streaming planes by (device list, k)
        self._planes: dict[tuple, ShardedLookupPlane] = {}

    @property
    def memento(self):
        """Back-compat alias from the Memento-only router: the host state."""
        # obs-exempt: pure accessor
        return self.ch

    def _obs(self):
        """The live telemetry registry (injected, else process default)."""
        return self._registry or _default_obs()

    # -- single-request path --------------------------------------------------
    def replica_set(self, session_id) -> list[int]:
        """The session's k distinct candidate replicas, k clamped to the
        surviving fleet."""
        self._obs().counter("router.replica_set_calls").inc()
        k = min(self.replicas_k, self.ch.working)
        return self.ch.lookup_k(key_to_u32(session_id), k)

    def route(self, session_id) -> int:
        reg = self._obs()
        t0 = time.perf_counter_ns() if reg.active else 0
        self._poll_store()
        if self.replicas_k > 1 and self._failed:
            reps = self.replica_set(session_id)
            # fail over while the primary is marked failed; all marked →
            # keep the primary
            r = next((c for c in reps if c not in self._failed), reps[0])
            if r != reps[0]:
                self.stats.failovers += 1
        else:
            r = self.ch.lookup(key_to_u32(session_id))
        self.stats.routed += 1
        if self._last.get(session_id) == r:
            self.stats.affinity_hits += 1
        self._last[session_id] = r
        self._last.move_to_end(session_id)
        if len(self._last) > self.max_sessions:
            self._last.popitem(last=False)  # evict the coldest session
        if reg.active:
            reg.histogram("router.route.us").observe(
                (time.perf_counter_ns() - t0) / 1e3)
        return r

    # -- bulk path (device) ---------------------------------------------------
    def image_store(self) -> DeviceImageStore:
        if self._store is None:
            self._store = DeviceImageStore(self.ch, device=self.device,
                                           compact=self.compact_images,
                                           registry=self._registry)
        return self._store

    def device_image(self):  # obs-exempt: pure accessor
        """The device image the batch paths serve (the store's front epoch)."""
        return self.image_store().image()

    def _failover_pick(self, sets: np.ndarray) -> np.ndarray:
        """The failover rule of every batch path: per row of k candidate
        replicas, the first not marked failed (all marked → keep the
        primary); counts the failovers.  Accepts 1-D input (k clamped to
        1 by a collapsed fleet)."""
        sets = np.asarray(sets)
        if sets.ndim == 1:
            sets = sets.reshape(-1, 1)
        ok = ~np.isin(sets, sorted(self._failed))
        ok[:, 0] |= ~ok.any(axis=1)  # all failed → keep the primary
        col = ok.argmax(axis=1)
        self.stats.failovers += int((col > 0).sum())
        return sets[np.arange(len(sets)), col]

    def route_batch(self, session_ids: np.ndarray) -> np.ndarray:
        """Session ids → int32 replicas, one device lookup; with
        ``replicas_k > 1`` and a replica marked failed, the k-replica sets
        in one launch and the same failover rule as :meth:`route`."""
        reg = self._obs()
        t0 = time.perf_counter_ns() if reg.active else 0
        self._poll_store()
        keys = np_key_to_u32(np.asarray(session_ids))
        if self.replicas_k > 1 and self._failed:
            out = self._failover_pick(self.replica_set_batch(session_ids))
        else:
            out = self.image_store().lookup(keys).cpu().numpy()
        if reg.active:
            reg.counter("router.batch_keys").inc(len(keys))
            reg.histogram("router.route_batch.us").observe(
                (time.perf_counter_ns() - t0) / 1e3)
        return out

    def replica_set_batch(self, session_ids: np.ndarray) -> np.ndarray:
        """k-replica sets of a session batch in one device launch: int32
        [len(ids), k], column 0 the plain placement; k clamped to the
        surviving fleet."""
        reg = self._obs()
        t0 = time.perf_counter_ns() if reg.active else 0
        keys = np_key_to_u32(np.asarray(session_ids))
        k = min(self.replicas_k, self.ch.working)
        out = self.image_store().lookup(keys, k=k).cpu().numpy()
        if reg.active:
            reg.histogram("router.replica_set.us", k=k).observe(
                (time.perf_counter_ns() - t0) / 1e3)
        return out.reshape(-1, k)

    # -- streaming path (sharded plane) ---------------------------------------
    def _plane(self, devices, k: int) -> ShardedLookupPlane:
        """The router's plane for ``devices`` and ``k``, built once.  The
        default device list is every GPU for a router on a GPU, else the
        router's own device."""
        if devices is None and self.device.type != "cuda":
            devices = [self.device]
        devices = resolve_devices(devices)
        key = (tuple(devices), k)
        plane = self._planes.get(key)
        if plane is None:
            plane = self._planes[key] = ShardedLookupPlane(
                self.image_store(), devices=devices, k=k, sync_mode=self.sync_mode,
                registry=self._registry)
        return plane

    def sharded_plane(self, *, devices=None) -> ShardedLookupPlane:
        """The router's :class:`~repro_torch.serve.plane.ShardedLookupPlane`
        over its image store (one per device list): membership deltas reach
        every device through the store's epoch sync."""
        # obs-exempt: builds the plane, which takes the router's registry
        return self._plane(devices, 1)

    def route_stream(self, session_id_batches, *, devices=None):
        """Stream batches of session ids → numpy int32 replica batches
        through the sharded plane.  Membership events applied between
        batches (``fail_replica``/``restore_replica``) are picked up at the
        next batch boundary, and, as in :meth:`route_batch`, replicas
        marked failed are failed over before their removal lands.  With
        ``replicas_k == 1`` batches stream through the plane's pipelined
        path; with ``replicas_k > 1`` each batch is served on its own, so
        the failover rule is applied as in the scalar path."""
        reg = self._obs()
        plane = self.sharded_plane(devices=devices)
        if self.replicas_k == 1:
            def to_keys():
                for ids in session_id_batches:
                    ids = np.asarray(ids)
                    self.stats.routed += len(ids)
                    reg.counter("router.stream_batches").inc()
                    yield np_key_to_u32(ids)

            yield from plane.route_stream(to_keys())
            return
        kplane = self._replica_plane(devices)  # built once a stream, not a batch
        for ids in session_id_batches:
            ids = np.asarray(ids)
            self._poll_store()  # overlap: land a ready flip, retire marks
            self.stats.routed += len(ids)
            reg.counter("router.stream_batches").inc()
            keys = np_key_to_u32(ids)
            if not self._failed:
                yield plane.lookup(keys)
            else:
                yield self._failover_pick(kplane.lookup(keys))

    def _replica_plane(self, devices=None) -> ShardedLookupPlane:
        """The sharded k-replica plane of the failover stream path, k
        clamped to the surviving fleet."""
        return self._plane(devices, min(self.replicas_k, self.ch.working))

    # -- membership ----------------------------------------------------------
    def _push_delta(self) -> None:
        """Mirror a membership event to the device as an epoch delta:
        flipped now (``"block"``) or at the next poll point (``"overlap"``)."""
        if self._store is not None:
            if self.sync_mode == "overlap":
                self._store.sync_async()
            else:
                self._store.sync()

    def _poll_store(self) -> None:
        """Overlap-mode poll point: land a finished async epoch (never
        blocks) and retire failover marks whose removal has landed."""
        if self.sync_mode == "overlap" and self._store is not None:
            self._store.poll()
        if self._unmark_at and self._store is not None:
            ep = self._store.epoch
            for r, until in list(self._unmark_at.items()):
                if ep >= until:
                    del self._unmark_at[r]
                    self._failed.discard(r)

    def mark_failed(self, replica: int) -> None:
        """Health-checker hook: route around ``replica`` now, before any
        membership delta is emitted or applied."""
        self._failed.add(replica)
        self._obs().counter("router.failover_marks").inc()

    def fail_replica(self, replica: int) -> dict:
        reg = self._obs()
        before = dict(self._last)
        self.mark_failed(replica)  # failover active while the delta lands
        removed = False
        try:
            with reg.span("router.fail_replica", replica=replica):
                self.ch.remove(replica)
                removed = True
                self._push_delta()
            reg.counter("router.membership_events", op="fail").inc()
        finally:
            if (removed and self.sync_mode == "overlap"
                    and self._store is not None
                    and self._store.epoch < self.ch.epoch):
                # the device still serves the pre-removal epoch: keep
                # failing over until the flip lands
                self._unmark_at[replica] = self.ch.epoch
            else:
                self._failed.discard(replica)
        moved = {s for s, r in before.items() if r == replica}
        self.stats.moved_on_failure += len(moved)
        info = {"replica": replica, "sessions_moved": len(moved)}
        if self._store is not None:
            # overlap: report the in-flight handle's target-epoch stats
            pend = self._store.pending
            st = pend.stats if pend is not None else self._store.last_sync
            if st is not None:
                info["control_plane"] = {"mode": st.mode, "words": st.words,
                                         "epoch": st.epoch}
        return info

    def restore_replica(self) -> int:
        reg = self._obs()
        with reg.span("router.restore_replica"):
            b = self.ch.add()
            self._push_delta()
        reg.counter("router.membership_events", op="restore").inc()
        return b

    @property
    def replicas(self) -> set[int]:  # obs-exempt: pure accessor
        return self.ch.working_set()


@dataclass
class Request:
    session_id: int
    tokens: list[int] = field(default_factory=list)


class BatchScheduler:
    """Groups admitted requests per replica into decode batches of at most
    ``max_batch``; requests over a replica's budget come back as overflow,
    are kept in ``self.pending`` and are drained first on the next
    ``assign``."""

    def __init__(self, router: SessionRouter, max_batch: int):
        self.router = router
        self.max_batch = max_batch
        self.pending: list[Request] = []

    def assign(self, requests: list[Request]) -> tuple[dict[int, list[Request]], list[Request]]:
        """Route ``pending + requests``; returns ``(batches, overflow)``."""
        work = self.pending + list(requests)
        ids = np.asarray([r.session_id for r in work], dtype=np.uint64)
        replicas = (self.router.route_batch(ids) if len(ids) else
                    np.zeros((0,), np.int32))
        out: dict[int, list[Request]] = {}
        overflow: list[Request] = []
        for req, rep in zip(work, replicas):
            lst = out.setdefault(int(rep), [])
            if len(lst) < self.max_batch:
                lst.append(req)
            else:
                overflow.append(req)  # back-pressure, not truncation
        self.pending = overflow
        return out, list(overflow)
