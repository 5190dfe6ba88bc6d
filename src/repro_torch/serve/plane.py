"""ShardedLookupPlane: key batches fanned over a list of devices (the
port's counterpart of the reference's mesh-sharded ``serve/plane.py``).

Each entry of ``devices`` takes one contiguous chunk of a key batch and
runs :func:`~repro_torch.kernels.engine.engine_lookup` on it against its
device's copy of the :class:`~repro_torch.core.protocol.DeviceImage`: the
image layout's ``{algo}_lookup``, ``{algo}_replica`` or packed kernel, on
a CUDA stream of the entry's own.  A list may repeat a device (two
entries on one card run on two streams); CPU entries run the plain
versions.  The image rides a
:class:`~repro_torch.core.image_store.DeviceImageStore` where the caller
has one, so churn reaches the devices as the store's epoch deltas and the
plane re-pins only the arrays the flip replaced (``_ensure``); a device
equal to the store's uses the store's tensors themselves.  Plain images
and host states work too (a host state is snapshotted when its epoch
changes).

Throughput mechanics, on CUDA entries:

  * keys are padded to ``len(devices) × 128`` lanes and staged into a
    pinned host buffer; each chunk's host→device copy is non-blocking, on
    a copy stream of its device, and its lookup waits for it by a stream
    dependency, not by the host;
  * each chunk's result returns by a non-blocking copy into a pinned host
    buffer; the host waits only when it reads the batch's result;
  * :meth:`route_stream` keeps one batch in flight: the host stages batch
    i+1 and its copy runs while the card computes batch i.  Two staging
    slots alternate; a slot is rewritten only once its copies have
    completed, and the device key tensors are recorded on the streams
    that read them, so the caching allocator never reuses them early.

A sharded lookup equals the single-device ``engine_lookup`` bit for bit
for any device list: the per-key work is elementwise.

Telemetry (:mod:`repro_torch.obs`): ``registry=`` (else the process
default at each call) receives the reference's ``plane.repins`` counter
and, a batch, ``plane.batches``, ``plane.keys``, the ``plane.shard_keys``
histogram (a device entry's chunk) and ``plane.dispatch.us`` (the host
time to stage and queue the batch).  The chunks' lookups are not engine
dispatches of their own: as the reference's sharded program, the plane
counts no ``engine.*``.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.protocol import DeviceImage
from repro_torch.device import resolve_devices
from repro_torch.kernels.engine import _engine_lookup
from repro_torch.obs.metrics import default_registry as _default_obs

#: keys per device entry are a multiple of this
LANES = 128


def _is_store(source) -> bool:
    return hasattr(source, "image") and hasattr(source, "sync")


class _Slot:
    """One staging slot: pinned key and result buffers (plain host
    tensors when no entry is on a GPU), the event of its key copies and
    the events of its results."""

    def __init__(self, cap: int, k: int, pinned: bool):
        self.cap = cap
        self.keys = torch.empty(cap, dtype=torch.int32, pin_memory=pinned)
        shape = (cap,) if k == 1 else (cap, k)
        self.out = torch.empty(shape, dtype=torch.int32, pin_memory=pinned)
        self.copied: list = []   # events after the key copies (CUDA)
        self.done: list = []     # events after the result copies (CUDA)

    def wait_copied(self) -> None:
        for ev in self.copied:
            ev.synchronize()
        self.copied = []


class ShardedLookupPlane:
    """Fan engine lookups over a device list with a copy of the image on
    each device.

    ``source`` is a :class:`~repro_torch.core.image_store.DeviceImageStore`
    (preferred: its epoch deltas keep the copies fresh), a
    :class:`~repro_torch.core.protocol.DeviceImage`, or a host state.
    ``devices`` defaults to every visible GPU; with no GPU the constructor
    raises unless the caller passes a list such as ``["cpu"]``.
    ``sync_mode="overlap"`` lands a store's pending async epoch
    (``store.poll()``) at every batch boundary.  ``registry`` is the
    telemetry registry (``None``: the process default)."""

    def __init__(self, source, *, devices=None, k: int = 1, sync_mode: str = "block",
                 registry=None):
        if k < 1:
            raise ValueError("k must be ≥ 1")
        if sync_mode not in ("block", "overlap"):
            raise ValueError(f"unknown sync_mode {sync_mode!r}")
        self.devices = resolve_devices(devices)
        self.k = k
        self.sync_mode = sync_mode
        self._source = source
        self._registry = registry  # None → follow the process default
        self._image = None       # the image the device copies mirror
        self._dev: dict | None = None  # device → DeviceImage on it
        self._rep_cache: dict = {}     # (device, name) → (source tensor, copy)
        self.repins = 0          # epoch flips picked up
        self.copies = 0          # arrays copied to a device other than their own
        #: a list to record (start, end) timing events of each CUDA chunk's
        #: lookup into, or ``None``
        self.trace: list | None = None
        gpus = [d for d in dict.fromkeys(self.devices) if d.type == "cuda"]
        self._streams = [torch.cuda.Stream(device=d) if d.type == "cuda" else None
                         for d in self.devices]
        self._copy_streams = {d: torch.cuda.Stream(device=d) for d in gpus}
        self._pinned = bool(gpus)
        self._slots: list[_Slot | None] = [None, None]
        self._turn = 0

    def _obs(self):
        """The live telemetry registry (injected, else process default)."""
        return self._registry or _default_obs()

    # -- geometry -----------------------------------------------------------------
    @property
    def num_shards(self) -> int:  # obs-exempt: device-list geometry
        return len(self.devices)

    @property
    def lanes(self) -> int:  # obs-exempt: device-list geometry
        """Key-count granularity: every entry gets 128-aligned chunks."""
        return self.num_shards * LANES

    # -- image replication ----------------------------------------------------------
    def _poll_source(self) -> None:
        """``sync_mode="overlap"``: land the store's pending async epoch iff
        its device work is done (never blocks)."""
        if self.sync_mode == "overlap" and _is_store(self._source):
            self._source.poll()

    def _current_image(self):
        if _is_store(self._source):
            return self._source.image()
        if hasattr(self._source, "device_image"):
            src = self._source
            if self._image is not None and src.epoch == self._image.epoch:
                return self._image
            return src.device_image()
        return self._source  # a plain DeviceImage

    def _ensure(self) -> None:
        """Re-pin the per-device images iff the epoch flipped.  Arrays the
        store's out-of-place delta apply did not replace are the same
        tensors across epochs, so their device copies are reused: a flip
        costs O(changed arrays)."""
        img = self._current_image()
        if self._dev is not None and img is self._image:
            return
        self.repins += 1
        self._obs().counter("plane.repins").inc()
        per_device = {}
        for dev in dict.fromkeys(self.devices):
            arrays = {}
            for name, src in img.arrays.items():
                cached = self._rep_cache.get((dev, name))
                if cached is None or cached[0] is not src:
                    if src.device == dev:
                        copy = src
                    else:
                        copy = src.to(dev, copy=True)
                        self.copies += 1
                    self._rep_cache[(dev, name)] = cached = (src, copy)
                arrays[name] = cached[1]
            per_device[dev] = DeviceImage(algo=img.algo, n=img.n, arrays=arrays,
                                          scalars=dict(img.scalars), epoch=img.epoch,
                                          packed=img.packed)
        self._image = img
        self._dev = per_device

    # -- one batch ------------------------------------------------------------------
    def _slot(self, padded: int) -> _Slot:
        """The next staging slot, free to rewrite: its key copies have
        completed, and its last result was read before this call."""
        i = self._turn
        self._turn ^= 1
        slot = self._slots[i]
        if slot is not None:
            slot.wait_copied()
        if slot is None or slot.cap < padded:
            slot = self._slots[i] = _Slot(padded, self.k, self._pinned)
        return slot

    def _dispatch(self, keys) -> tuple[_Slot, int, int]:
        """Stage a key batch and queue every chunk's lookup; on CUDA
        entries nothing here waits for the device.  Returns the slot, the
        batch's keys and its padded length."""
        keys = np.asarray(keys, dtype=np.uint32).reshape(-1)
        n = len(keys)
        padded = max(self.lanes, -(-n // self.lanes) * self.lanes)
        chunk = padded // self.num_shards
        slot = self._slot(padded)
        host = slot.keys.numpy()
        host[:n] = keys.view(np.int32)
        host[n:padded] = 0
        parts = [(i, dev, slice(i * chunk, (i + 1) * chunk))
                 for i, dev in enumerate(self.devices)]
        # host → device copies first, each device's on its copy stream
        staged = {}
        for dev, copy_stream in self._copy_streams.items():
            with torch.cuda.stream(copy_stream):
                for i, d, rows in parts:
                    if d == dev:
                        staged[i] = slot.keys[rows].to(dev, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(copy_stream)
            slot.copied.append(ev)
        slot.done = []
        for i, dev, rows in parts:
            img = self._dev[dev]
            where = None if img.arrays else dev  # a tableless image runs on dev
            if dev.type != "cuda":
                slot.out[rows] = _engine_lookup(slot.keys[rows], img, k=self.k, device=where)
                continue
            stream, kt = self._streams[i], staged[i]
            stream.wait_stream(self._copy_streams[dev])   # its keys
            stream.wait_stream(torch.cuda.current_stream(dev))  # the image's writes
            kt.record_stream(stream)
            with torch.cuda.stream(stream):
                if self.trace is not None:
                    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    start.record(stream)
                out = _engine_lookup(kt, img, k=self.k, device=where)
                if self.trace is not None:
                    end.record(stream)
                    self.trace.append((start, end))
                slot.out[rows].copy_(out, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(stream)
            slot.done.append(ev)
        # later work on each device's current stream (a sync's delta apply,
        # a reuse of the image's freed blocks) waits for these lookups
        for i, dev, _rows in parts:
            if dev.type == "cuda":
                torch.cuda.current_stream(dev).wait_stream(self._streams[i])
        return slot, n, padded

    def _record_batch(self, reg, n: int, padded: int, t0_ns: int) -> None:
        """A batch's telemetry: batch and key counters, a device entry's
        chunk, and the host time to stage and queue it."""
        reg.counter("plane.batches").inc()
        reg.counter("plane.keys").inc(n)
        reg.histogram("plane.shard_keys").observe(padded // self.num_shards)
        reg.histogram("plane.dispatch.us").observe(
            (time.perf_counter_ns() - t0_ns) / 1e3)

    def _finish(self, pending: tuple[_Slot, int, int]) -> np.ndarray:
        slot, n, _padded = pending
        for ev in slot.done:
            ev.synchronize()
        return np.array(slot.out.numpy()[:n])

    # -- public data plane ------------------------------------------------------------
    def lookup(self, keys) -> np.ndarray:
        """Sharded batched lookup: keys [K] → numpy int32 [K] (k = 1) or
        [K, k]."""
        reg = self._obs()
        t0 = time.perf_counter_ns() if reg.active else 0
        self._poll_source()
        self._ensure()
        staged = self._dispatch(keys)
        out = self._finish(staged)
        if reg.active:
            self._record_batch(reg, staged[1], staged[2], t0)
        return out

    def route_stream(self, batches):
        """Stream key batches through the plane, one batch in flight.

        Yields one numpy result per input batch, in order.  Batch i+1 is
        pulled, staged and dispatched before batch i's result is read, so
        membership events that the caller applies between batches reach
        the batch after them, at its boundary."""
        reg = self._obs()
        pending = None
        for batch in batches:
            t0 = time.perf_counter_ns() if reg.active else 0
            self._poll_source()  # overlap: land a ready async epoch
            self._ensure()       # pick up an epoch flip between batches
            staged = self._dispatch(batch)
            if reg.active:  # dispatch time: the batch's device work overlaps
                self._record_batch(reg, staged[1], staged[2], t0)
            if pending is not None:
                yield self._finish(pending)
            pending = staged
        if pending is not None:
            yield self._finish(pending)
