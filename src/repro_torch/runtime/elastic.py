"""Elastic cluster controller and straggler mitigation (the port's copy of
the reference's ``runtime/elastic.py``).

One consistent hash per resource class (data shards, checkpoint buckets)
keeps every placement consistent through node churn; both follow the one
``algo=`` choice.  ``fail(host)`` is a Θ(1) state update plus a minimal
re-placement, ``join()`` restores the most recent failure first (the
paper's LIFO discipline keeps R small).  Movement plans come from the
device: one ``{algo}_diff`` launch per event, and
:meth:`ElasticCluster.replica_movement` one ``{algo}_replica_diff`` launch
over whole k-replica sets.

:class:`StragglerMonitor` drops the contributions of hosts whose step
latency exceeds μ + k·σ and rescales the gradient by participating/total.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.memento import MementoHash
from repro_torch.core.protocol import make_hash
from repro_torch.data.pipeline import ShardPlacement


@dataclass
class ClusterEvent:
    kind: str      # "fail" | "join"
    host: int
    moved: int     # resources relocated by the event


def domain_distinct_replicas(ch, key: int, k: int, domain_of) -> list[int]:
    """k working buckets for ``key`` with pairwise-distinct failure domains:
    the ``lookup_k`` salted walk (``lookup_k_filtered``) that also rejects a
    candidate whose domain is already represented, so a whole-domain outage
    takes out at most one replica.  Requires ``k`` ≤ the number of distinct
    domains among working buckets."""
    domains_avail = {domain_of(b) for b in ch.working_set()}
    if k > len(domains_avail):
        raise ValueError(f"k={k} exceeds the {len(domains_avail)} distinct "
                         "failure domains among working buckets")

    def reject(cand, chosen):
        return cand in chosen or domain_of(cand) in {domain_of(b) for b in chosen}

    return ch.lookup_k_filtered(key, k, reject)


class ElasticCluster:
    """Shard and checkpoint-bucket placement through host failures and
    joins.  ``device`` holds the placement's image store (default
    ``"cuda"``; with no GPU the constructor raises unless the caller passes
    ``device="cpu"``)."""

    def __init__(self, num_hosts: int, *, num_shards: int = 256,
                 ckpt_buckets: int | None = None, algo: str = "memento",
                 capacity: int | None = None, replica_k: int = 1,
                 num_domains: int | None = None, domain_of=None, device=None):
        self.placement = ShardPlacement(num_shards, num_hosts, algo=algo,
                                        capacity=capacity, device=device)
        nb = ckpt_buckets or max(num_hosts // 2, 2)
        self.ckpt_ch = make_hash(algo, nb, capacity=capacity and max(capacity, nb))
        self.events: list[ClusterEvent] = []
        # replica-aware placement: shards live on replica_k hosts whose
        # failure domains are pairwise distinct.  Default domain map:
        # host % num_domains; with neither given, every host is its own
        # domain (plain distinctness).
        self.replica_k = replica_k
        if domain_of is not None:
            self.domain_of = domain_of
        elif num_domains is not None:
            self.domain_of = lambda host: host % num_domains
        else:
            self.domain_of = lambda host: host

    @property
    def ckpt_memento(self):
        """Back-compat alias from the Memento-only controller."""
        return self.ckpt_ch

    @property
    def hosts(self) -> set[int]:
        return self.placement.ch.working_set()

    def fail(self, host: int) -> dict:
        plan = self.placement.fail_host(host)
        assert plan["minimal"], "non-minimal data movement on failure!"
        self.events.append(ClusterEvent("fail", host, len(plan["moved"])))
        return plan

    def join(self) -> dict:
        plan = self.placement.add_host()
        assert plan["monotone"], "non-monotone movement on join!"
        self.events.append(ClusterEvent("join", plan["host"], len(plan["moved"])))
        return plan

    def movement_total(self) -> int:
        return sum(e.moved for e in self.events)

    # -- replica-aware placement ------------------------------------------------
    def replica_movement(self, k: int | None = None) -> dict[int, dict]:
        """Replica-set churn of the last membership event: one replica diff
        launch over every shard between the store's retained and front
        epochs, read back to the host once.  Returns shard → {"old", "new"}
        replica lists for exactly the shards whose set changed.

        Covers the plain dedup replica sets (``lookup_k``); the
        domain-distinct placement (:meth:`replica_hosts`) coincides with it
        under the default identity domain map."""
        store = self.placement.image_store()
        if store.previous_image() is None:
            return {}
        keys = np.arange(self.placement.num_shards, dtype=np.uint32)
        d = store.migration_diff(keys, k=k or self.replica_k)
        old = d.old.cpu().numpy().reshape(len(keys), -1)
        new = d.new.cpu().numpy().reshape(len(keys), -1)
        return {int(s): {"old": old[s].tolist(), "new": new[s].tolist()}
                for s in np.nonzero(d.moved.cpu().numpy())[0]}

    def replica_hosts(self, shard: int, k: int | None = None) -> list[int]:
        """The shard's replica set: k hosts on pairwise-distinct failure
        domains (the first is the classic single-host placement)."""
        return domain_distinct_replicas(self.placement.ch, shard,
                                        k or self.replica_k, self.domain_of)

    def replica_placement(self, k: int | None = None) -> dict[int, list[int]]:
        """shard → replica hosts for every shard (distinct domains each)."""
        return {s: self.replica_hosts(s, k)
                for s in range(self.placement.num_shards)}

    def state(self) -> dict:
        """Protocol-generic controller state (plus Memento's ⟨n, R, l⟩)."""
        m = self.placement.ch
        st = {"algo": m.name, "size": m.size, "working": m.working,
              "epoch": getattr(m, "epoch", 0),
              "ckpt": {"algo": self.ckpt_ch.name, "size": self.ckpt_ch.size,
                       "working": self.ckpt_ch.working}}
        if isinstance(m, MementoHash):  # ⟨n, R, l⟩ (paper state)
            st.update({"n": m.n, "l": m.l, "R": dict(m.R)})
        return st


class StragglerMonitor:
    def __init__(self, *, k_sigma: float = 3.0, window: int = 50,
                 min_participation: float = 0.5):
        self.k = k_sigma
        self.window = window
        self.min_participation = min_participation
        self._lat: list[float] = []

    def deadline(self) -> float:
        if len(self._lat) < 8:
            return float("inf")
        arr = np.asarray(self._lat[-self.window:])
        return float(arr.mean() + self.k * arr.std())

    def observe(self, latency: float) -> None:
        self._lat.append(latency)

    def filter_step(self, host_latencies: dict[int, float]) -> dict:
        """Which hosts make the deadline; gradient rescale factor."""
        dl = self.deadline()
        for v in host_latencies.values():
            self.observe(v)
        ok = {h for h, v in host_latencies.items() if v <= dl}
        total = len(host_latencies)
        if len(ok) < self.min_participation * total:
            ok = set(host_latencies)  # too many stragglers: wait for all
        scale = total / max(len(ok), 1)
        return {"participants": ok, "skipped": set(host_latencies) - ok,
                "grad_scale": scale, "deadline": dl}
