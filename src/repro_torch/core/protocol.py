"""The consistent-hash protocol of the port: device images, epoch deltas,
and the algorithm registry (the port's own copy of the reference's).

Host control plane: ``lookup / remove / add / working / size /
working_set / memory_bytes``.  ``device_image()`` flattens the host state
into a :class:`DeviceImage`, flat 128-padded int32 tensors plus the
dynamic scalars a lookup needs.  Every ``remove()``/``add()`` bumps the
algorithm's ``epoch`` and appends an O(changed-words) record to a bounded
delta log; ``device_delta(since)`` composes the records after ``since``
into one :class:`ImageDelta`, which ``DeviceImageStore`` applies to
double-buffered device tensors.

Every algorithm of the reference's registry is ported: MementoHash,
AnchorHash, DxHash, JumpHash and PowerHash.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass, field

import numpy as np
import torch


def round_up(x: int, m: int = 128) -> int:
    """Round ``x`` up to a multiple of ``m``."""
    return ((x + m - 1) // m) * m


#: Salted re-lookup bound for ``lookup_k``; shared with the device planes
#: so they stay bit-identical to the host.
REPLICA_SALT_CAP = 4096


class ReplicatedLookup:
    """Mixin: k distinct working buckets by salted re-lookup.

    Replica 0 is the plain ``lookup(key)``; replica j is the first
    candidate ``lookup(hash2(key, salt))``, salt = 1, 2, …, not already
    chosen.  The salt counter is shared across slots, so the walk is one
    deterministic sequence.
    """

    def _salt_hash2(self, key: int, salt: int) -> int:
        from .hashing import hash2_32, hash2_64

        if getattr(self, "variant", "64") == "32":
            return hash2_32(key, salt)
        return hash2_64(key, salt)

    def lookup_k_filtered(self, key: int, k: int, reject,
                          trace: list | None = None,
                          check_first: bool = False) -> list[int]:
        """The salted walk: ``reject(cand, chosen)`` skips a candidate;
        slot 0, the plain lookup, is accepted unless ``check_first`` (the
        bounded replica walk applies its load-cap rule to slot 0 too).
        ``trace``, if given, collects every salted lookup's result in walk
        order."""
        if k < 1:
            raise ValueError("k must be ≥ 1")
        first = self.lookup(key)
        if trace is not None:
            trace.append(first)
        out = [] if check_first and reject(first, []) else [first]
        salt = 1
        while len(out) < k:
            if salt > REPLICA_SALT_CAP:
                raise RuntimeError("replica salt budget exhausted")
            cand = self.lookup(self._salt_hash2(key, salt))
            if trace is not None:
                trace.append(cand)
            if not reject(cand, out):
                out.append(cand)
            salt += 1
        return out

    @staticmethod
    def _reject_duplicate(cand: int, chosen: list[int]) -> bool:
        return cand in chosen

    def lookup_k(self, key: int, k: int) -> list[int]:
        """k distinct working buckets for ``key``; ``lookup_k(key, 1)[0] ==
        lookup(key)``.  Requires ``k ≤ working``."""
        if k > self.working:
            raise ValueError(f"k={k} exceeds working buckets ({self.working})")
        return self.lookup_k_filtered(key, k, self._reject_duplicate)

    def lookup_k_trace(self, key: int, k: int) -> tuple[list[int], list[int]]:
        """``lookup_k`` returning ``(replicas, candidates)``: every salted
        lookup's result in walk order, rejected ones included (the
        replica-stability checker's instrument)."""
        if k > self.working:
            raise ValueError(f"k={k} exceeds working buckets ({self.working})")
        cands: list[int] = []
        out = self.lookup_k_filtered(key, k, self._reject_duplicate, trace=cands)
        return out, cands


def replica_sets(h, keys, k: int) -> np.ndarray:
    """Numpy oracle: ``lookup_k`` over a key batch → int32 [len(keys), k],
    the host walk the device's replica lookups are held against."""
    keys = np.asarray(keys)
    out = np.empty((len(keys), k), dtype=np.int32)
    for i, key in enumerate(keys):
        out[i] = h.lookup_k(int(key), k)
    return out


@dataclass
class DeviceImage:
    """Flat image of a consistent-hash state, held as torch tensors.

    * ``algo``    — a name in :data:`ALGORITHMS`,
    * ``n``       — the dynamic size scalar (b-array size for Memento and
      Jump-family, overall capacity ``a`` for Anchor/Dx),
    * ``arrays``  — named flat int32 tensors (uint32 words bit-cast to
      int32), lengths 128-padded, all on one device; empty for the
      tableless Jump and Power,
    * ``scalars`` — extra dynamic int scalars,
    * ``epoch``   — the membership epoch this image snapshots,
    * ``packed``  — True when ``arrays`` hold the packed layout of
      :mod:`repro_torch.core.packing` (a bitmap of working buckets plus
      narrowed words) instead of the dense one.  The engine dispatches on
      this flag, so both layouts share every lookup entry point.
    """

    algo: str
    n: int
    arrays: dict[str, torch.Tensor] = field(default_factory=dict)
    scalars: dict[str, int] = field(default_factory=dict)
    epoch: int = 0
    packed: bool = False


@dataclass
class ImageDelta:
    """O(changed-words) edit advancing a :class:`DeviceImage` from
    ``base_epoch`` to ``epoch``: per array name, ``(indices int32[k],
    values int32[k])`` numpy scatter pairs (last write wins across the
    composed events), plus the new ``n`` and dynamic scalars."""

    algo: str
    base_epoch: int
    epoch: int
    n: int
    updates: dict[str, tuple[np.ndarray, np.ndarray]] = field(default_factory=dict)
    scalars: dict[str, int] = field(default_factory=dict)

    @property
    def events(self) -> int:
        return self.epoch - self.base_epoch

    def num_words(self) -> int:
        """Host→device scatter payload in 32-bit words (indices + values)."""
        return sum(2 * len(idx) for idx, _ in self.updates.values())


@dataclass(frozen=True)
class AlgoInfo:
    """One algorithm's registry entry: its host factory
    ``(initial_nodes, capacity, variant) → instance``, its dynamic scalars
    (``n`` first), its table names, ``required(n)`` (the table lengths a
    lookup at size ``n`` may read), whether removals are LIFO only (the
    rule the sim's victim policies degrade to), and whether the overall
    capacity ``a`` is fixed at construction (growable algorithms get
    snapshot headroom instead)."""

    name: str
    factory: object
    scalars: tuple[str, ...]
    tables: tuple[str, ...]
    required: object
    lifo_only: bool = False
    fixed_capacity: bool = False
    packed_tables: tuple[str, ...] | None = None


def _memento_factory(n0: int, capacity, variant: str):
    from .memento import MementoHash

    return MementoHash(n0, variant=variant)


def _anchor_factory(n0: int, capacity, variant: str):
    from .anchor import AnchorHash

    return AnchorHash(capacity or 10 * n0, n0, variant=variant)


def _dx_factory(n0: int, capacity, variant: str):
    from .dx import DxHash

    return DxHash(capacity or 10 * n0, n0, variant=variant)


def _jump_factory(n0: int, capacity, variant: str):
    from .jump import JumpHash

    return JumpHash(n0, variant=variant)


def _power_factory(n0: int, capacity, variant: str):
    from .power import PowerHash

    return PowerHash(n0, variant=variant)


#: Registry order is the reference's (its wire ids).  One name per line: no
#: source line may list three algorithm names.
ALGORITHM_REGISTRY: dict[str, AlgoInfo] = {
    info.name: info for info in (
        AlgoInfo("memento", _memento_factory, ("n",), ("repl",),
                 lambda n: {"repl": n},
                 packed_tables=("state", "slot_b", "slot_c")),
        AlgoInfo("anchor", _anchor_factory, ("n",), ("A", "K"),
                 lambda n: {"A": n, "K": n}, fixed_capacity=True),
        AlgoInfo("dx", _dx_factory, ("n", "max_probes", "fallback"),
                 ("words",), lambda n: {"words": -(-n // 32)},
                 fixed_capacity=True),
        AlgoInfo("jump", _jump_factory, ("n",), (), lambda n: {},
                 lifo_only=True),
        AlgoInfo("power", _power_factory, ("n",), (), lambda n: {},
                 lifo_only=True),
    )
}

#: every algorithm name, in registry (wire-id) order
ALGORITHMS: tuple[str, ...] = tuple(ALGORITHM_REGISTRY)

IMAGE_LAYOUT: dict[str, tuple[tuple[str, ...], tuple[str, ...]]] = {
    name: (info.scalars, info.tables)
    for name, info in ALGORITHM_REGISTRY.items()
}


def _registry_entry(algo: str) -> AlgoInfo:
    info = ALGORITHM_REGISTRY.get(algo)
    if info is None:
        raise ValueError(f"unknown algorithm {algo!r}")
    return info


def image_scalar_vec(image: DeviceImage) -> list[int]:
    """The image's dynamic scalars in layout order (``n`` first)."""
    names = _registry_entry(image.algo).scalars
    return [int(image.n)] + [int(image.scalars[s]) for s in names[1:]]


def required_lengths(algo: str, n: int) -> dict[str, int]:
    """Minimum array lengths a lookup at size ``n`` may gather from."""
    return _registry_entry(algo).required(n)


def _host_array(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def image_fingerprint(image: DeviceImage) -> str:
    """CRC32 hex digest of every word a lookup can observe: ``n``,
    ``epoch``, the scalars, and each array trimmed to its
    :func:`required_lengths` prefix (a bounded-load ``load`` overlay to
    ``n`` words).  Capacity padding is excluded, so two images that
    reached one epoch through different snapshot/delta histories
    fingerprint equal iff their lookups agree.  A packed image hashes its
    whole arrays, each in its own dtype.  Equal to the reference package's
    fingerprint of the same image."""
    crc = zlib.crc32(np.asarray([image.n, image.epoch], np.int64).tobytes())
    trim = {} if image.packed else required_lengths(image.algo, image.n)
    if "load" in image.arrays:
        trim = dict(trim, load=image.n)
    for name in sorted(image.arrays):
        arr = np.ascontiguousarray(_host_array(image.arrays[name]))
        if name in trim:
            arr = arr[: trim[name]]
        crc = zlib.crc32(name.encode(), crc)
        crc = zlib.crc32(arr.tobytes(), crc)
    for name in sorted(image.scalars):
        crc = zlib.crc32(f"{name}={int(image.scalars[name])}".encode(), crc)
    return f"{crc & 0xFFFFFFFF:08x}"


class DeltaEmitter:
    """Mixin: epoch counter + bounded per-event delta log.

    Implementations call ``_init_delta_log()`` once and then
    ``_record(updates, n, scalars)`` after every committed membership
    event, where ``updates`` maps array name → {flat index: new value}.
    ``device_delta(since)`` composes the log suffix into one
    :class:`ImageDelta`, or returns ``None`` when ``since`` predates the
    log window (the caller must rebuild from a fresh ``device_image()``).
    """

    _DELTA_LOG_CAP = 8192

    @property
    def image_algo(self) -> str:
        return self.name

    def _init_delta_log(self) -> None:
        self._epoch = 0
        self._delta_log: list = []

    @property
    def epoch(self) -> int:
        return self._epoch

    def _record(self, updates: dict[str, dict[int, int]], n: int,
                scalars: dict[str, int] | None = None) -> None:
        self._epoch += 1
        self._delta_log.append((self._epoch, updates, n, scalars or {}))
        if len(self._delta_log) > self._DELTA_LOG_CAP:
            # drop the oldest half: amortized O(1) per event, and readers
            # that far behind need a snapshot rebuild anyway
            del self._delta_log[: len(self._delta_log) // 2]

    def device_delta(self, since_epoch: int):
        """Compose every event in ``(since_epoch, epoch]`` into one delta
        (``None`` when ``since_epoch`` has fallen out of the bounded log)."""
        if since_epoch > self._epoch:
            raise ValueError(f"since_epoch {since_epoch} is in the future "
                             f"(current epoch {self._epoch})")
        if since_epoch < self._epoch - len(self._delta_log):
            return None
        merged: dict[str, dict[int, int]] = {}
        start = len(self._delta_log) - (self._epoch - since_epoch)
        for _epoch, updates, _ev_n, _ev_scalars in self._delta_log[start:]:
            for name, edits in updates.items():
                merged.setdefault(name, {}).update(edits)
        updates = {
            name: (np.fromiter(edits.keys(), dtype=np.int32, count=len(edits)),
                   np.fromiter(edits.values(), dtype=np.int64,
                               count=len(edits)).astype(np.int32))
            for name, edits in merged.items()
        }
        return ImageDelta(algo=self.image_algo, base_epoch=since_epoch,
                          epoch=self._epoch, n=self._image_n(),
                          updates=updates, scalars=dict(self._image_scalars()))

    def device_delta_range(self, since_epoch: int, until_epoch: int):
        """Compose the events in ``(since_epoch, until_epoch]`` into one
        delta: :meth:`device_delta` to an intermediate target epoch, so a
        replication publisher can chunk a long pending range into several
        frames (``repro_torch.launch.replicate``).  ``n`` and the scalars
        come from the log entry at ``until_epoch``; an empty range gives
        the ``until`` state.  ``None`` when ``since_epoch`` predates the
        bounded log, or ``until_epoch`` sits at its edge (no entry)."""
        if until_epoch > self._epoch:
            raise ValueError(f"until_epoch {until_epoch} is in the future "
                             f"(current epoch {self._epoch})")
        if since_epoch > until_epoch:
            raise ValueError(f"empty range ({since_epoch}, {until_epoch}]")
        if since_epoch < self._epoch - len(self._delta_log):
            return None
        start = len(self._delta_log) - (self._epoch - since_epoch)
        stop = len(self._delta_log) - (self._epoch - until_epoch)
        if stop == start:
            if until_epoch == self._epoch:
                n, scalars = self._image_n(), dict(self._image_scalars())
            elif stop <= 0:
                return None
            else:
                _e, _u, n, scalars = self._delta_log[stop - 1]
            return ImageDelta(algo=self.image_algo, base_epoch=since_epoch,
                              epoch=until_epoch, n=n, scalars=dict(scalars))
        merged: dict[str, dict[int, int]] = {}
        for _epoch, updates, _ev_n, _ev_scalars in self._delta_log[start:stop]:
            for name, edits in updates.items():
                merged.setdefault(name, {}).update(edits)
        _e, _u, n, scalars = self._delta_log[stop - 1]
        updates = {
            name: (np.fromiter(edits.keys(), dtype=np.int32, count=len(edits)),
                   np.fromiter(edits.values(), dtype=np.int64,
                               count=len(edits)).astype(np.int32))
            for name, edits in merged.items()
        }
        return ImageDelta(algo=self.image_algo, base_epoch=since_epoch,
                          epoch=until_epoch, n=n, updates=updates,
                          scalars=dict(scalars))

    def _image_n(self) -> int:
        raise NotImplementedError

    def _image_scalars(self) -> dict[str, int]:
        return {}


def make_hash(algo: str, initial_node_count: int, *, capacity: int | None = None,
              variant: str = "64"):
    """Algorithm name → host implementation.  ``variant="32"`` selects the
    arithmetic the device kernels match bit-for-bit."""
    return _registry_entry(algo).factory(initial_node_count, capacity, variant)
