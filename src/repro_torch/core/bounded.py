"""Bounded-load overlay of the port (its own copy of the reference's
``core/bounded.py``).

"Consistent hashing with bounded loads" (Mirrokni, Thorup &
Zadimoghaddam, 2016) over any consistent hash of the registry: a bucket
accepts at most ``cap = ceil(c · keys / working)`` assignments, and a key
whose bucket is full walks a deterministic rehash chain (``chain ←
hash2(chain, probe)``) to the next bucket below the cap.

The per-bucket load is a flat int32 **load-word array** that rides in the
:class:`~repro_torch.core.protocol.DeviceImage` beside the algorithm's
tables, so a :class:`~repro_torch.core.image_store.DeviceImageStore`
keeps it on the device and every load change reaches it as an
O(changed-words) epoch delta.  The chain walk runs on the device too
(:func:`repro_torch.kernels.engine.bounded_assign`, the ``{algo}_walk``
kernel), equal to the host walk here on ``variant="32"`` states; races
inside a batch are settled in key-index order by
:func:`accept_in_index_order`, which the numpy reference and the device
driver share.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .hashing import MASK32, MASK64, hash2_32, hash2_64
from .memento import MementoHash
from .protocol import DeltaEmitter, DeviceImage, make_hash, round_up


def accept_in_index_order(b, pending, load, cap) -> np.ndarray:
    """Indices of the pending keys accepted this round: per bucket, the
    lowest-index proposers up to the bucket's room ``cap − load[b]``.
    The one acceptance rule of the numpy reference
    (:func:`bounded_assign_ref`) and the device driver
    (:func:`repro_torch.kernels.engine.bounded_assign`)."""
    idx = np.nonzero(pending)[0]
    pb = np.asarray(b)[idx]
    order = np.argsort(pb, kind="stable")
    sorted_b = pb[order]
    starts = (np.r_[True, sorted_b[1:] != sorted_b[:-1]] if len(sorted_b)
              else np.zeros(0, bool))
    seg_start = np.maximum.accumulate(
        np.where(starts, np.arange(len(sorted_b)), 0))
    rank = np.empty(len(idx), np.int64)
    rank[order] = np.arange(len(sorted_b)) - seg_start
    return idx[rank < (cap - np.asarray(load)[pb])]


def walk_probe_bound(load_len: int) -> int:
    """The chain walk's termination guard, shared by the host reference
    and the device walk (derived from the load array's length, so every
    plane uses the same bound): a lane still at the cap after this many
    probes means the cap is infeasible (cap·buckets < keys)."""
    return 64 * load_len + 64


def bounded_assign_ref(ch, keys, load, cap: int):
    """Numpy reference of batch bounded assignment (host control plane).

    Round by round: every pending key walks its chain (host scalar
    lookups) to the first bucket with ``load[b] < cap``; races are settled
    by :func:`accept_in_index_order`; a rejected key finds its bucket
    full next round and walks on.  Returns ``(assignments int32 [m],
    new_load)``; the device driver equals it on ``variant="32"`` states.
    """
    h2 = hash2_32 if getattr(ch, "variant", "64") == "32" else hash2_64
    mask = MASK32 if getattr(ch, "variant", "64") == "32" else MASK64
    keys = np.asarray(keys, dtype=np.uint64)
    m = len(keys)
    chain = [int(k) & mask for k in keys]
    probe = [0] * m
    out = np.full(m, -1, np.int32)
    pending = np.ones(m, bool)
    load = np.asarray(load, dtype=np.int32).copy()
    b = np.zeros(m, np.int32)
    max_probe = walk_probe_bound(len(load))
    while pending.any():
        for i in np.nonzero(pending)[0]:
            bi = ch.lookup(chain[i])
            while load[bi] >= cap:
                if probe[i] >= max_probe:
                    raise RuntimeError(
                        "no bucket below capacity (infeasible cap: "
                        f"cap={cap} cannot hold the pending keys)")
                probe[i] += 1
                chain[i] = h2(chain[i], probe[i])
                bi = ch.lookup(chain[i])
            b[i] = bi
        acc = accept_in_index_order(b, pending, load, cap)
        out[acc] = b[acc]
        np.add.at(load, b[acc], 1)
        pending[acc] = False
    return out, load


class BoundedLoad(DeltaEmitter):
    """Bounded-load overlay over any consistent hash of the registry.

    Speaks the consistent-hash protocol itself (``lookup``/``lookup_k``
    delegate to the inner state; ``device_image()`` is the inner image
    plus the ``load`` word array), so a store keeps the load words on the
    device and every assignment, release or re-spill reaches it as an
    O(changed-words) epoch delta.
    """

    def __init__(self, ch, c: float = 1.25, *,
                 initial_node_count: int | None = None,
                 capacity: int | None = None, variant: str = "64"):
        if c <= 1.0:
            raise ValueError("load factor c must exceed 1")
        if isinstance(ch, str):
            ch = make_hash(ch, initial_node_count, capacity=capacity,
                           variant=variant)
        self.ch = ch
        self.c = c
        self.assignment: dict[int, int] = {}
        self._load = np.zeros(round_up(max(ch.size, 1)), np.int32)
        self._init_delta_log()

    # -- protocol plumbing -------------------------------------------------
    @property
    def name(self) -> str:
        return f"{self.ch.name}-bounded"

    @property
    def image_algo(self) -> str:
        return self.ch.name  # the device dispatches on the inner layout

    @property
    def variant(self) -> str:
        return getattr(self.ch, "variant", "64")

    @property
    def size(self) -> int:
        return self.ch.size

    @property
    def working(self) -> int:
        return self.ch.working

    def working_set(self) -> set[int]:
        return self.ch.working_set()

    def memory_bytes(self) -> int:
        """Inner state plus one load word per working bucket."""
        return self.ch.memory_bytes() + 4 * self.ch.working

    def lookup(self, key: int) -> int:
        return self.ch.lookup(key)

    def lookup_k(self, key: int, k: int) -> list[int]:
        return self.ch.lookup_k(key, k)

    @property
    def load(self) -> np.ndarray:
        """Per-bucket load words, int32, bucket-indexed: the array the
        device image carries."""
        return self._load

    def _image_n(self) -> int:
        return self.ch._image_n()

    def _image_scalars(self) -> dict[str, int]:
        return self.ch._image_scalars()

    def device_image(self, capacity: int | None = None) -> DeviceImage:
        """The inner image plus the ``load`` array (padded to the
        bucket-id space), stamped with the overlay's own epoch, which
        also counts load-word events."""
        img = self.ch.device_image(capacity=capacity)
        pad = max(round_up(max(img.n, capacity or 0, 1)), self._load.shape[0])
        load = np.zeros(pad, np.int32)
        load[: self._load.shape[0]] = self._load
        return DeviceImage(algo=img.algo, n=img.n,
                           arrays={**img.arrays, "load": torch.from_numpy(load)},
                           scalars=img.scalars, epoch=self._epoch)

    # -- capacity ----------------------------------------------------------
    def capacity(self, incoming: int = 1) -> int:
        """The cap for ``incoming`` more keys:
        ``max(1, ceil(c · (assigned + incoming) / working))``."""
        total = len(self.assignment) + incoming
        return max(1, math.ceil(self.c * total / self.ch.working))

    def _grow_load(self, need: int) -> None:
        if need <= self._load.shape[0]:
            return
        grown = np.zeros(round_up(max(need, 2 * self._load.shape[0])), np.int32)
        grown[: self._load.shape[0]] = self._load
        self._load = grown

    def _inner_event_updates(self) -> dict[str, dict[int, int]]:
        """The inner algorithm's last membership event, re-emitted under
        the overlay's epochs."""
        if not getattr(self.ch, "_delta_log", None):
            return {}
        _epoch, updates, _n, _scalars = self.ch._delta_log[-1]
        return {name: dict(edits) for name, edits in updates.items()}

    # -- key management ----------------------------------------------------
    def _walk(self, key: int, cap: int) -> int:
        """Host chain walk: the first bucket of the rehash chain below
        ``cap`` (the scalar original of the device walk)."""
        h2 = hash2_32 if self.variant == "32" else hash2_64
        b = self.ch.lookup(key)
        probe, chain = 0, key
        while self._load[b] >= cap:
            probe += 1
            chain = h2(chain, probe)
            b = self.ch.lookup(chain)
            if probe > 64 * self.ch.working:  # cannot happen if c > 1
                raise RuntimeError("no bucket below capacity")
        return b

    def assign(self, key: int) -> int:
        mask = MASK32 if self.variant == "32" else MASK64
        key &= mask
        b = self._walk(key, self.capacity())
        self.assignment[key] = b
        self._load[b] += 1
        self._record({"load": {b: int(self._load[b])}}, self._image_n(),
                     self._image_scalars())
        return b

    def assign_batch(self, keys) -> np.ndarray:
        """Batch assignment at ``cap = ceil(c·(assigned+len(keys))/working)``
        by the numpy reference; one epoch delta carries every changed load
        word.  (On the device, ``kernels.engine.bounded_assign`` against
        the synced image gives the same assignments.)"""
        keys = np.asarray(keys, dtype=np.uint64)
        cap = self.capacity(incoming=len(keys))
        out, new_load = bounded_assign_ref(self.ch, keys, self._load, cap)
        mask = MASK32 if self.variant == "32" else MASK64
        changed = np.nonzero(new_load != self._load)[0]
        self._load = new_load
        for key, b in zip(keys, out):
            self.assignment[int(key) & mask] = int(b)
        self._record({"load": {int(i): int(new_load[i]) for i in changed}},
                     self._image_n(), self._image_scalars())
        return out

    def release(self, key: int) -> None:
        mask = MASK32 if self.variant == "32" else MASK64
        b = self.assignment.pop(key & mask)
        self._load[b] -= 1
        self._record({"load": {b: int(self._load[b])}}, self._image_n(),
                     self._image_scalars())

    # -- membership --------------------------------------------------------
    def remove(self, bucket: int) -> dict[int, int]:
        """Remove a bucket and re-assign only the keys it held (plus their
        bounded spill); returns the moves.  The membership edit and every
        touched load word land in one epoch delta."""
        self.ch.remove(bucket)
        updates = self._inner_event_updates()
        victims = [k for k, b in self.assignment.items() if b == bucket]
        touched: set[int] = set()
        for k in victims:
            del self.assignment[k]
        self._load[bucket] = 0
        touched.add(bucket)
        moves = {}
        for k in victims:
            b = self._walk(k, self.capacity())
            self.assignment[k] = b
            self._load[b] += 1
            touched.add(b)
            moves[k] = b
        updates.setdefault("load", {}).update(
            {int(b): int(self._load[b]) for b in touched})
        self._record(updates, self._image_n(), self._image_scalars())
        return moves

    def add(self) -> int:
        b = self.ch.add()
        self._grow_load(self.ch.size)
        updates = self._inner_event_updates()
        self._record(updates, self._image_n(), self._image_scalars())
        return b

    # -- metrics -----------------------------------------------------------
    def peak_to_mean(self) -> float:
        if not self.assignment:
            return 0.0
        mean = len(self.assignment) / self.ch.working
        return float(self._load.max()) / mean


class BoundedLoadMemento(BoundedLoad):
    """The Memento-only overlay: :class:`BoundedLoad` over a
    :class:`MementoHash` (``m``, ``assign``, ``release``, ``remove`` →
    moves, ``capacity``, ``peak_to_mean``)."""

    def __init__(self, initial_node_count: int, c: float = 1.25,
                 variant: str = "64"):
        super().__init__(MementoHash(initial_node_count, variant=variant), c)

    @property
    def m(self) -> MementoHash:
        return self.ch
