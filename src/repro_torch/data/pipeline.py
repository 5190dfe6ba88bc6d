"""Elastic data pipeline: consistent-hash shard → host placement and a
deterministic synthetic corpus (the port's copy of the reference's
``data/pipeline.py``).

File shards are consistent-hashed onto data-loading hosts, so every host
derives its shard list locally, a host failure moves only the failed
host's shards (minimal disruption, Prop. VI.3), hosts re-join in reverse
order with monotone movement (Prop. VI.5), and with Memento the fleet's
capacity is unbounded.

Movement plans of a ``variant="32"`` state run on the device: the store's
two retained epochs are diffed by one ``{algo}_diff`` launch over every
shard id (:meth:`DeviceImageStore.migration_diff`), and membership events
reach the device as epoch deltas (the ``delta_apply`` kernel).  Other
states plan on the host.

The corpus is hash-generated, (shard id, position) → token, so any host
can materialize any shard and restarts compare token streams exactly.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.hashing import np_hash2_32
from repro_torch.core.image_store import DeviceImageStore
from repro_torch.core.protocol import make_hash
from repro_torch.device import resolve_device


class ShardPlacement:
    """shard id → host bucket, driven by any port consistent hash
    (Memento by default).  ``device`` holds the image store that plans
    movement; it defaults to ``"cuda"``, and with no GPU the constructor
    raises unless the caller passes ``device="cpu"``.  ``algo`` is an
    algorithm name or a port host state."""

    def __init__(self, num_shards: int, num_hosts: int, variant: str = "32",
                 algo="memento", capacity: int | None = None, device=None):
        self.num_shards = num_shards
        self.device = resolve_device(device)
        if isinstance(algo, str):
            self.ch = make_hash(algo, num_hosts, capacity=capacity, variant=variant)
        else:
            self.ch = algo
        self._store: DeviceImageStore | None = None

    @property
    def memento(self):
        """Back-compat alias from the Memento-only placement."""
        return self.ch

    def host_of(self, shard: int) -> int:
        return self.ch.lookup(shard)

    def assignment(self) -> dict[int, list[int]]:
        out: dict[int, list[int]] = {b: [] for b in self.ch.working_set()}
        for s in range(self.num_shards):
            out[self.host_of(s)].append(s)
        return out

    def shards_for_host(self, host: int) -> list[int]:
        return [s for s in range(self.num_shards) if self.host_of(s) == host]

    # -- device movement plans ------------------------------------------------
    def _device_ready(self) -> bool:
        return (getattr(self.ch, "variant", None) == "32"
                and hasattr(self.ch, "device_delta"))

    def image_store(self) -> DeviceImageStore:
        if self._store is None:
            self._store = DeviceImageStore(self.ch, device=self.device)
        return self._store

    def _diff_epochs(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Sync the device image over the last event and diff the two
        epochs: one diff launch, read back to the host once."""
        store = self.image_store()
        store.sync()
        keys = np.arange(self.num_shards, dtype=np.uint32)
        d = store.migration_diff(keys)
        return d.old.cpu().numpy(), d.new.cpu().numpy(), d.moved.cpu().numpy()

    def fail_host(self, host: int) -> dict:
        """Remove a host; returns the movement plan (only its shards move)."""
        if not self._device_ready():
            return self._fail_host_hostplane(host)
        self.image_store().sync()  # the device at this epoch before the event
        self.ch.remove(host)
        old, new, moved_mask = self._diff_epochs()
        moved = {int(s): int(new[s]) for s in np.nonzero(moved_mask)[0]}
        stayed = int(((old != host) & ~moved_mask).sum())
        return {"moved": moved, "stayed": stayed,
                "minimal": stayed == self.num_shards - len(moved)
                and all(int(old[s]) == host for s in moved)}

    def add_host(self) -> dict:
        if not self._device_ready():
            return self._add_host_hostplane()
        self.image_store().sync()
        host = self.ch.add()
        _old, new, moved_mask = self._diff_epochs()
        moved = {int(s): host for s in np.nonzero(moved_mask)[0]
                 if int(new[s]) == host}
        monotone = bool(np.all(~moved_mask | (new == host)))
        return {"host": host, "moved": moved, "monotone": monotone}

    # -- host planning (variant="64" states) -----------------------------------
    def _fail_host_hostplane(self, host: int) -> dict:
        before = {s: self.host_of(s) for s in range(self.num_shards)}
        self.ch.remove(host)
        moved = {s: self.host_of(s) for s in range(self.num_shards)
                 if before[s] == host}
        stayed = sum(1 for s in range(self.num_shards)
                     if before[s] != host and self.host_of(s) == before[s])
        return {"moved": moved, "stayed": stayed,
                "minimal": stayed == self.num_shards - len(moved)}

    def _add_host_hostplane(self) -> dict:
        before = {s: self.host_of(s) for s in range(self.num_shards)}
        host = self.ch.add()
        moved = {s: host for s in range(self.num_shards)
                 if self.host_of(s) == host and before[s] != host}
        monotone = all(self.host_of(s) in (before[s], host)
                       for s in range(self.num_shards))
        return {"host": host, "moved": moved, "monotone": monotone}


def synthetic_shard_tokens(shard: int, length: int, vocab_size: int,
                           offset: int = 0) -> np.ndarray:
    """Deterministic pseudo-corpus: token[i] = h(shard, offset+i) mod vocab."""
    idx = (np.arange(length, dtype=np.uint64) + np.uint64(offset)).astype(np.uint32)
    h = np_hash2_32(idx, np.uint32(shard & 0xFFFFFFFF))
    return (h % np.uint32(vocab_size)).astype(np.int32)


class DataPipeline:
    """Per-host, resumable iterator over the host's shards.

    Yields ``{"tokens": (B, S), "labels": (B, S)}`` int32 batches (labels =
    next token).  State is ``{"cursor": int}``; ``load_state`` resumes
    exactly.
    """

    def __init__(self, placement: ShardPlacement, host: int, *,
                 batch: int, seq_len: int, vocab_size: int,
                 shard_tokens: int = 1 << 16):
        self.placement = placement
        self.host = host
        self.batch = batch
        self.seq_len = seq_len
        self.vocab_size = vocab_size
        self.shard_tokens = shard_tokens
        self.cursor = 0

    def state(self) -> dict:
        return {"cursor": self.cursor}

    def load_state(self, st: dict) -> None:
        self.cursor = int(st["cursor"])

    def _sequence(self, i: int) -> np.ndarray:
        shards = self.placement.shards_for_host(self.host)
        if not shards:
            raise RuntimeError(f"host {self.host} owns no shards")
        per_shard = self.shard_tokens // (self.seq_len + 1)
        shard = shards[(i // per_shard) % len(shards)]
        off = (i % per_shard) * (self.seq_len + 1)
        return synthetic_shard_tokens(shard, self.seq_len + 1,
                                      self.vocab_size, offset=off)

    def next_batch(self) -> dict[str, np.ndarray]:
        seqs = [self._sequence(self.cursor + j) for j in range(self.batch)]
        self.cursor += self.batch
        arr = np.stack(seqs)
        return {"tokens": arr[:, :-1], "labels": arr[:, 1:]}

    def __iter__(self):
        while True:
            yield self.next_batch()
