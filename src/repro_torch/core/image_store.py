"""DeviceImageStore: epoch-versioned, double-buffered device images.

A store wraps one host consistent-hash state and keeps its
:class:`~repro_torch.core.protocol.DeviceImage` resident on the device:

  * **stable shapes**: tables are allocated 128-padded with headroom
    (``headroom×`` the size for growable algorithms; the fixed-capacity
    AnchorHash and DxHash never outgrow ``a``), so churn never reshapes a
    device buffer; ``n`` and the other scalars travel with each delta.
    The tableless Jump and Power images are their ``n`` alone;
  * **delta application**: ``sync()`` drains the host's
    ``device_delta(epoch)`` and applies it as an O(changed-words) scatter
    (the ``delta_apply`` kernel) instead of re-sending an O(n) snapshot;
  * **double-buffered epochs**: applying never writes the serving
    tensors.  The epoch-N image keeps answering lookups while N+1 is
    materialized, then the store flips under its lock.  ``image()`` is the
    front, ``previous_image()`` the retained epoch that ``migration_diff``
    compares against.

A snapshot is rebuilt only when the host's bounded delta log no longer
covers the store's epoch, or when growth outruns the padded capacity.

``compact=True`` keeps the packed layout (:mod:`repro_torch.core.packing`)
on the device instead: for Memento a bitmap plus a Θ(r) slot table, for
AnchorHash narrowed A/K.  A numpy mirror of the packed arrays stays on the
host; each delta edits it (:func:`packed_delta_updates`) and ships the
touched words, and a delta the packed buffers cannot absorb (bitmap
outgrown, slots full, a value too wide) rebuilds a snapshot.

``sync()`` prepares and flips in one call; ``sync_async()`` dispatches the
scatter and returns a :class:`SyncHandle` without flipping.  The flip
lands on ``handle.commit()``, the store's ``poll()`` (only once a CUDA
event recorded after the scatter has completed) or ``flush()``.

Telemetry (:mod:`repro_torch.obs`): ``registry=`` (else the process
default, resolved at each call) receives the reference's ``store.*``
instruments: the ``store.sync > store.sync.dispatch, store.sync.flip``
span tree and ``store.sync.us{mode}``, ``store.sync.dispatch`` of
``sync_async``, ``store.sync.commit > store.sync.materialize,
store.sync.flip`` of a handle's commit, the ``store.pending`` gauge, the
sync counters (``syncs``, ``sync_events``, ``delta_applies``,
``delta_words``, ``snapshot_rebuilds``, ``snapshot_words``) with a
``sync`` sink event a sync, ``store.lookups``/``lookup_keys``/
``lookup.us`` and the ``store.diff`` span.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.delta_apply import apply_updates, scatter_update
from repro_torch.kernels.engine import engine_diff, engine_lookup
from repro_torch.obs.metrics import default_registry as _default_obs
from .packing import host_arrays, pack_image, packed_delta_updates
from .protocol import (ALGORITHM_REGISTRY, DeviceImage, ImageDelta,
                       required_lengths, round_up)


def delta_fits(caps: dict[str, int], delta: ImageDelta, *,
               compact: bool = False) -> bool:
    """Do buffers of the given per-array lengths absorb ``delta``?  Every
    array a lookup at ``delta.n`` may read must be long enough (with
    ``compact``, Memento's bitmap: 32 buckets a ``state`` word), and a
    bounded-load ``load`` overlay, which is bucket-indexed, must cover
    ``delta.n`` words."""
    if compact and delta.algo == "memento":
        needed = {"state": -(-delta.n // 32)}
    else:
        needed = dict(required_lengths(delta.algo, delta.n))
    if "load" in caps:
        needed["load"] = delta.n
    return all(caps.get(name, 0) >= need for name, need in needed.items())


@dataclass
class SyncStats:
    """What one ``sync()`` did."""

    mode: str            # "noop" | "delta" | "snapshot"
    events: int          # membership events covered
    words: int           # 32-bit words sent host→device
    epoch: int           # store epoch after the sync


@dataclass
class SyncTotals:
    syncs: int = 0
    delta_applies: int = 0
    snapshot_rebuilds: int = 0
    events: int = 0
    words: int = 0


class SyncHandle:
    """One in-flight ``sync_async()``: epoch N+1 materializing while the
    store keeps serving N.  ``commit()`` blocks on the device and flips;
    ``poll()`` flips only if the device work is done.  Idempotent."""

    def __init__(self, store: "DeviceImageStore", stats: SyncStats,
                 new_front: DeviceImage | None,
                 event: torch.cuda.Event | None = None,
                 new_mirror: dict | None = None):
        self._store = store
        self._stats = stats
        self._new = new_front           # None → noop: nothing to flip
        self._new_mirror = new_mirror   # the packed host mirror of new_front
        self._event = event             # None → the work ran on the host
        self._done = new_front is None
        if self._done:
            store._account(stats)

    @property
    def done(self) -> bool:  # obs-exempt: pure accessor
        return self._done

    @property
    def stats(self) -> SyncStats:  # obs-exempt: pure accessor
        """Target-epoch stats (valid before and after the flip)."""
        return self._stats

    def ready(self) -> bool:
        """Non-blocking: has the device finished the dispatched work?"""
        # obs-exempt: readiness probe only, no device dispatch
        return self._done or self._event is None or self._event.query()

    def poll(self) -> bool:
        """Flip iff the device work is done; never blocks.  Returns whether
        the handle is done."""
        # obs-exempt: delegates to commit(), which records the flip
        if not self._done and self.ready():
            self.commit()
        return self._done

    def commit(self) -> SyncStats:
        """Wait for epoch N+1 on the device, then flip under the lock."""
        with self._store._lock:
            if self._done:
                return self._stats
            reg = self._store._obs()
            with reg.span("store.sync.commit", epoch=self._stats.epoch):
                with reg.span("store.sync.materialize"):
                    if self._event is not None:
                        self._event.synchronize()
                with reg.span("store.sync.flip", epoch=self._stats.epoch):
                    self._store._flip(self._new, self._new_mirror, self._stats)
            self._done = True
            if self._store._pending is self:
                self._store._pending = None
            reg.gauge("store.pending").set(0)
        return self._stats


class DeviceImageStore:
    """Double-buffered device image of a consistent-hash state, updated by
    deltas; packed with ``compact=True``.  ``device`` defaults to
    ``"cuda"``; with no GPU the constructor raises unless the caller
    passes ``device="cpu"``.  ``registry`` is the telemetry registry to
    record on (``None``: the process default at each call)."""

    def __init__(self, ch, *, device=None, headroom: int = 2,
                 compact: bool = False, registry=None):
        self.device = resolve_device(device)
        self._ch = ch
        self._registry = registry  # None → follow the process default
        self.headroom = max(1, headroom)
        self.compact = compact
        self.totals = SyncTotals()
        self.last_sync: SyncStats | None = None
        self._prev: DeviceImage | None = None
        self._lock = threading.RLock()
        self._pending: SyncHandle | None = None
        self._front, self._mirror = self._snapshot()

    def _obs(self):
        """The live telemetry registry: the injected one, else whatever the
        process default is now (so ``enable()`` reaches existing stores)."""
        return self._registry or _default_obs()

    # -- buffers ---------------------------------------------------------------
    def _snapshot(self) -> tuple[DeviceImage, dict | None]:
        """Build (do not install) a full snapshot image on the device, with
        ``headroom×`` the current size for a growable algorithm so growth
        can ride deltas, and with ``compact`` its packed layout (slot
        headroom 2: a load factor ≤ 0.25 after the rebuild, so deltas
        insert in place) and the host mirror of the packed arrays."""
        if ALGORITHM_REGISTRY[self._ch.image_algo].fixed_capacity:
            cap = None  # the overall capacity a is fixed
        else:
            cap = round_up(max(self.headroom * self._ch.size, 128))
        img = self._ch.device_image(capacity=cap)
        mirror = None
        if self.compact:
            img = pack_image(img, slot_headroom=2)
            mirror = host_arrays(img)
        front = DeviceImage(
            algo=img.algo, n=img.n,
            arrays={k: v.to(self.device) for k, v in img.arrays.items()},
            scalars=dict(img.scalars), epoch=img.epoch, packed=img.packed)
        return front, mirror

    @property
    def epoch(self) -> int:  # obs-exempt: pure accessor
        return self._front.epoch

    @property
    def capacity(self) -> dict[str, int]:  # obs-exempt: pure accessor
        return {k: int(v.shape[0]) for k, v in self._front.arrays.items()}

    def image(self) -> DeviceImage:  # obs-exempt: pure accessor
        """The serving (front) image.  Never edited: syncs replace it."""
        return self._front

    def previous_image(self) -> DeviceImage | None:  # obs-exempt: pure accessor
        """The retained pre-sync epoch (migration-diff comparand), if any."""
        return self._prev

    # -- epoch advancement -----------------------------------------------------
    def sync(self) -> SyncStats:
        """Advance the device image to the host's current epoch: an
        O(changed-words) delta when the host log covers our epoch and the
        capacity suffices, else a full snapshot.  The old front is kept as
        ``previous_image()``.  A pending async epoch is committed first."""
        reg = self._obs()
        t0 = time.perf_counter_ns() if reg.active else 0
        with reg.span("store.sync", mode="block"):
            self.flush()
            with reg.span("store.sync.dispatch"):
                new, mirror, stats, _event = self._prepare()
            with self._lock:
                if new is not None:
                    with reg.span("store.sync.flip", epoch=stats.epoch):
                        self._flip(new, mirror, stats)
                else:
                    self._account(stats)
        if reg.active:
            reg.histogram("store.sync.us", mode=stats.mode).observe(
                (time.perf_counter_ns() - t0) / 1e3)
        return stats

    def sync_async(self) -> SyncHandle:
        """Dispatch epoch N+1 without flipping and without waiting for the
        device.  The front keeps serving epoch N until the handle commits
        (``handle.commit()``, ``poll()``, ``flush()``, or the next sync)."""
        reg = self._obs()
        with reg.span("store.sync.dispatch", mode="overlap"):
            self.flush()
            new, mirror, stats, event = self._prepare()
        handle = SyncHandle(self, stats, new, event, mirror)
        if not handle.done:
            self._pending = handle
            reg.gauge("store.pending").set(1)
        return handle

    def poll(self) -> bool:
        """Commit the pending async epoch iff its device work is done
        (never blocks).  True when no flip remains outstanding."""
        # obs-exempt: delegates to SyncHandle.commit (instrumented)
        h = self._pending
        return h.poll() if h is not None else True

    def flush(self) -> SyncStats | None:
        """Commit the pending async epoch, blocking if needed."""
        # obs-exempt: delegates to SyncHandle.commit (instrumented)
        h = self._pending
        return h.commit() if h is not None else None

    @property
    def pending(self) -> SyncHandle | None:  # obs-exempt: pure accessor
        """The in-flight ``sync_async`` handle, if any."""
        return self._pending

    def _prepare(self):
        """Drain the host delta and dispatch (not install) the next-epoch
        image.  Returns ``(new_front | None, new_mirror, stats, event |
        None)``.  A packed delta edits the host mirror in place: the
        mirror runs ahead of the front until the flip."""
        delta = self._ch.device_delta(self._front.epoch)
        if delta is not None and delta.events == 0:
            return None, None, SyncStats("noop", 0, 0, self.epoch), None
        applied = None
        if delta is not None and delta_fits(self.capacity, delta, compact=self.compact):
            applied = (self._apply_packed(delta) if self.compact
                       else (self._apply(delta), delta.num_words()))
        if applied is not None:
            new, words = applied
            return (new, self._mirror, SyncStats("delta", delta.events, words, new.epoch),
                    self._record_event())
        events = self._ch.epoch - self._front.epoch
        new, mirror = self._snapshot()
        words = sum(int(v.numel()) for v in new.arrays.values()) + 1
        return (new, mirror, SyncStats("snapshot", events, words, new.epoch),
                self._record_event())

    def _apply(self, delta: ImageDelta) -> DeviceImage:
        return DeviceImage(algo=delta.algo, n=delta.n,
                           arrays=apply_updates(self._front.arrays, delta.updates),
                           scalars=dict(delta.scalars), epoch=delta.epoch)

    def _apply_packed(self, delta: ImageDelta) -> tuple[DeviceImage, int] | None:
        """The delta as scatters on the packed layout, or ``None`` (→ a
        snapshot) when the packed buffers cannot absorb it."""
        updates = packed_delta_updates(self._mirror, delta)
        if updates is None:
            return None
        arrays = dict(self._front.arrays)
        words = 0
        for name, (idx, vals) in updates.items():
            if len(idx):
                arrays[name] = scatter_update(arrays[name], idx, vals)
                words += 2 * len(idx)
        return DeviceImage(algo=delta.algo, n=delta.n, arrays=arrays,
                           scalars=dict(delta.scalars), epoch=delta.epoch,
                           packed=True), words

    def _record_event(self) -> torch.cuda.Event | None:
        if self.device.type != "cuda":
            return None
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return event

    def _flip(self, new: DeviceImage, mirror: dict | None, stats: SyncStats) -> None:
        """Install epoch N+1 and its host mirror (caller holds ``_lock``)."""
        self._prev = self._front
        self._front = new
        self._mirror = mirror
        self._account(stats)

    def _account(self, stats: SyncStats) -> None:
        if stats.mode == "delta":
            self.totals.delta_applies += 1
        elif stats.mode == "snapshot":
            self.totals.snapshot_rebuilds += 1
        self.totals.syncs += 1
        self.totals.events += stats.events
        self.totals.words += stats.words
        self.last_sync = stats
        reg = self._obs()
        if reg.active:  # the totals mirrored on the registry
            reg.counter("store.syncs").inc()
            reg.counter("store.sync_events").inc(stats.events)
            if stats.mode == "delta":
                reg.counter("store.delta_applies").inc()
                reg.counter("store.delta_words").inc(stats.words)
            elif stats.mode == "snapshot":
                reg.counter("store.snapshot_rebuilds").inc()
                reg.counter("store.snapshot_words").inc(stats.words)
            reg.sink.emit("sync", mode=stats.mode, events=stats.events,
                          words=stats.words, epoch=stats.epoch)

    # -- data plane ------------------------------------------------------------
    def lookup(self, keys, *, k: int = 1, load=None,
               cap: int | None = None) -> torch.Tensor:
        """Bulk lookup against the front image: int32 buckets [K] (k = 1)
        or replica sets [K, k] on the store's device, one launch on CUDA
        (the layout's ``lookup`` kernel, or its ``replica`` kernel for
        k > 1 or a bounded lookup under ``load``/``cap``)."""
        reg = self._obs()
        t0 = time.perf_counter_ns() if reg.active else 0
        out = engine_lookup(keys, self._front, k=k, load=load, cap=cap,
                            device=self.device)
        if reg.active:
            reg.counter("store.lookups").inc()
            reg.counter("store.lookup_keys").inc(int(out.shape[0]))
            reg.histogram("store.lookup.us").observe(
                (time.perf_counter_ns() - t0) / 1e3)
        return out

    def migration_diff(self, keys, *, k: int = 1):
        """Moved-key mask between the retained epoch and the front epoch
        (one ``diff`` launch of the layout on CUDA; ``replica_diff`` for
        k > 1, where a key moved if any slot of its replica set did).
        Across a snapshot both epochs are of the store's one layout."""
        if self._prev is None:
            raise ValueError("no previous epoch retained (sync() first)")
        with self._obs().span("store.diff", epoch=self._front.epoch):
            return engine_diff(keys, self._prev, self._front, k=k, device=self.device)
