"""Declarative cluster-lifecycle traces (the port's own copy of the
reference's ``sim/traces.py``; traces serialize to the same JSON).

A :class:`Trace` is a seeded, algorithm-agnostic script of
:class:`TraceEvent` records — the paper's evaluation scenarios (§VIII:
stable, one-shot removal, incremental removals) plus beyond-paper
lifecycles (flapping nodes, churn storms, correlated failure-domain
outages, staged scale-up/scale-down, Zipf-skewed traffic, session-affinity
serving with failovers) — that the replay driver
(:mod:`repro_torch.sim.driver`) feeds through the real production stack.

The grammar is deliberately small:

  ===========  ==========================================================
  op           meaning
  ===========  ==========================================================
  remove       ``count`` membership removals (victims picked by
               ``select``), then — if ``sync`` — ONE epoch sync, so a
               burst lands as one composed delta
  add          ``count`` additions (Memento restores LIFO), then sync
  lookup       a traffic batch of ``n_keys`` keys (``dist`` uniform or
               Zipf-``skew``), ``k`` replicas per key through the engine
  assign       bounded-load assignment of ``n_keys`` keys under
               ``cap_c`` (cap = ⌈cap_c · keys/working⌉)
  route        a session batch of ``n_keys`` ids through SessionRouter
  mark_failed  health-checker mark (failover BEFORE the delta lands)
  fail         SessionRouter.fail_replica (remove + delta + unmark)
  restore      SessionRouter.restore_replica / host add
  ===========  ==========================================================

Victim ``select`` policies: ``random`` (trace-rng uniform over working
buckets), ``lifo`` (highest id — the only legal choice for the LIFO-only
algorithms Jump and Power, which degrade every policy to it), ``first``
(lowest working id,
deterministic without consuming rng), ``domain`` (every working bucket of
failure domain ``domain``), or an explicit ``bucket``.

Traces serialize losslessly to JSON (:meth:`Trace.to_json` /
:meth:`Trace.from_json`): a captured churn trace replays bit-for-bit —
same victims, same traffic, same placements — on any plane, as long as
traffic runs at synced epochs (all built-ins do; with ``sync=False``
membership pending, the device planes deliberately serve the last synced
epoch while the host plane is live — see :mod:`repro_torch.sim.driver`).
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field


@dataclass
class TraceEvent:
    """One declarative lifecycle event (see the module grammar table)."""

    op: str
    count: int = 1
    select: str = "random"
    bucket: int | None = None
    domain: int | None = None
    n_keys: int = 0
    dist: str = "uniform"
    skew: float = 1.2
    k: int = 1
    cap_c: float | None = None
    sync: bool = True

    _OPS = ("remove", "add", "lookup", "assign", "route", "mark_failed",
            "fail", "restore")
    _SELECTS = ("random", "lifo", "first", "domain")

    def __post_init__(self):
        if self.op not in self._OPS:
            raise ValueError(f"unknown trace op {self.op!r}")
        if self.select not in self._SELECTS:
            raise ValueError(f"unknown victim policy {self.select!r}")
        if self.count < 1:
            raise ValueError("count must be ≥ 1")
        if self.select == "domain" and self.domain is None:
            raise ValueError("select='domain' needs a domain")
        if self.select == "domain" and self.op in ("fail", "mark_failed"):
            raise ValueError(f"{self.op} names ONE victim; select='domain' "
                             "is a remove-burst policy")
        if self.bucket is not None and self.count != 1:
            raise ValueError("an explicit bucket names exactly one victim "
                             "(count must be 1)")
        if self.op in ("lookup", "assign", "route") and self.n_keys < 1:
            raise ValueError(f"{self.op} needs n_keys ≥ 1")
        if self.op == "assign" and (self.cap_c is None or self.cap_c <= 1.0):
            raise ValueError("assign needs cap_c > 1")
        if self.dist not in ("uniform", "zipf"):
            raise ValueError(f"unknown key distribution {self.dist!r}")
        if self.dist == "zipf" and self.skew <= 1.0:
            raise ValueError("zipf skew must exceed 1")
        if self.k < 1:
            raise ValueError("k must be ≥ 1")


@dataclass
class Trace:
    """A named, seeded scenario script; replayable and JSON-round-trippable."""

    name: str
    seed: int
    initial_nodes: int
    events: list[TraceEvent] = field(default_factory=list)
    capacity_factor: int = 4   # a/w for the fixed-capacity baselines
    num_domains: int | None = None  # domain map: bucket % num_domains
    meta: dict = field(default_factory=dict)

    @property
    def membership_events(self) -> int:
        return sum(e.count for e in self.events
                   if e.op in ("remove", "add", "fail", "restore"))

    # -- serialization (replayable churn traces) ----------------------------
    def to_dict(self) -> dict:
        return {"name": self.name, "seed": self.seed,
                "initial_nodes": self.initial_nodes,
                "capacity_factor": self.capacity_factor,
                "num_domains": self.num_domains, "meta": self.meta,
                "events": [asdict(e) for e in self.events]}

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @classmethod
    def from_dict(cls, d: dict) -> "Trace":
        return cls(name=d["name"], seed=d["seed"],
                   initial_nodes=d["initial_nodes"],
                   capacity_factor=d.get("capacity_factor", 4),
                   num_domains=d.get("num_domains"),
                   meta=d.get("meta", {}),
                   events=[TraceEvent(**e) for e in d["events"]])

    @classmethod
    def from_json(cls, s: str) -> "Trace":
        return cls.from_dict(json.loads(s))


# ---------------------------------------------------------------------------
# The paper's §VIII scenarios
# ---------------------------------------------------------------------------

def stable_trace(seed: int = 0, *, w: int = 64, batches: int = 6,
                 n_keys: int = 2048, k: int = 1) -> Trace:
    """Paper stable clusters (Figs. 17/18): traffic only, no churn."""
    ev = [TraceEvent("lookup", n_keys=n_keys, k=k) for _ in range(batches)]
    return Trace("stable", seed, w, ev)


def oneshot_trace(seed: int = 0, *, w: int = 64, frac: float = 0.9,
                  n_keys: int = 2048) -> Trace:
    """Paper one-shot removal (Figs. 19–22): ``frac`` of the fleet dies at
    once — one burst, ONE composed epoch delta — then serving resumes."""
    removals = max(1, int(frac * w))
    ev = [TraceEvent("lookup", n_keys=n_keys),
          TraceEvent("remove", count=removals),
          TraceEvent("lookup", n_keys=n_keys),
          TraceEvent("lookup", n_keys=n_keys)]
    return Trace("oneshot", seed, w, ev, meta={"frac": frac})


def incremental_trace(seed: int = 0, *, w: int = 64,
                      fractions: tuple = (0.1, 0.2, 0.35, 0.5, 0.65,
                                          0.8, 0.9),
                      n_keys: int = 2048) -> Trace:
    """Paper incremental removals (Figs. 23–26): the fleet shrinks through
    the checkpoint fractions with traffic at each — the trace whose
    degradation profile shows the ~70 % knee."""
    ev: list[TraceEvent] = [TraceEvent("lookup", n_keys=n_keys)]
    removed = 0
    for frac in fractions:
        step = int(frac * w) - removed
        if step < 1:
            continue
        removed += step
        ev.append(TraceEvent("remove", count=step))
        ev.append(TraceEvent("lookup", n_keys=n_keys))
    return Trace("incremental", seed, w, ev,
                 meta={"fractions": list(fractions)})


# ---------------------------------------------------------------------------
# Beyond-paper lifecycles
# ---------------------------------------------------------------------------

def flapping_trace(seed: int = 0, *, w: int = 48, cycles: int = 5,
                   flappers: int = 3, n_keys: int = 1536) -> Trace:
    """Flapping nodes: the same buckets repeatedly fail and rejoin (LIFO
    restore brings back exactly the flapped buckets), traffic between
    flaps.  Exercises delta composition and epoch-flip stability under
    oscillating membership."""
    ev: list[TraceEvent] = []
    for _ in range(cycles):
        ev.append(TraceEvent("remove", count=flappers))
        ev.append(TraceEvent("lookup", n_keys=n_keys))
        ev.append(TraceEvent("add", count=flappers))
        ev.append(TraceEvent("lookup", n_keys=n_keys))
    return Trace("flapping", seed, w, ev, meta={"cycles": cycles,
                                                "flappers": flappers})


def churn_storm_trace(seed: int = 0, *, w: int = 96, storms: int = 4,
                      burst: int = 12, n_keys: int = 1536) -> Trace:
    """Churn storms: bursts of removals land as ONE composed delta each,
    partial recoveries between storms, traffic throughout."""
    ev: list[TraceEvent] = [TraceEvent("lookup", n_keys=n_keys)]
    for _ in range(storms):
        ev.append(TraceEvent("remove", count=burst))
        ev.append(TraceEvent("lookup", n_keys=n_keys))
        ev.append(TraceEvent("add", count=max(1, burst // 2)))
        ev.append(TraceEvent("lookup", n_keys=n_keys))
    return Trace("churn_storm", seed, w, ev, meta={"storms": storms,
                                                   "burst": burst})


def churn_storm_xl_trace(seed: int = 0, *, w: int = 100_000, storms: int = 3,
                         burst: int = 2_000, n_keys: int = 4096,
                         select: str = "lifo") -> Trace:
    """Churn storms at fleet scale (10⁵–10⁶ nodes): the trace behind the
    async-overlap and follower-replication measurements.

    Same storm grammar as :func:`churn_storm_trace` but the fleet is
    100k–1M buckets and each storm removes thousands of nodes as ONE
    composed delta, so the delta-apply scatter is big enough that hiding
    it behind lookup traffic (``sync_mode="overlap"``) is measurable, and
    the replicated frame stream carries real storm-sized payloads.
    ``select`` defaults to ``lifo`` — victim resolution stays O(burst)
    instead of O(w) rng draws, which matters at 10⁶ nodes — and the
    LIFO-only algorithms (Jump, Power) degrade to it anyway, so
    cross-algorithm cells stay comparable."""
    if not 10_000 <= w <= 1_000_000:
        raise ValueError("churn_storm_xl is the 1e4–1e6-node storm; use "
                         "churn_storm below 1e4")
    ev: list[TraceEvent] = [TraceEvent("lookup", n_keys=n_keys)]
    for _ in range(storms):
        ev.append(TraceEvent("remove", count=burst, select=select))
        ev.append(TraceEvent("lookup", n_keys=n_keys))
        ev.append(TraceEvent("add", count=max(1, burst // 2)))
        ev.append(TraceEvent("lookup", n_keys=n_keys))
    return Trace("churn_storm_xl", seed, w, ev,
                 meta={"storms": storms, "burst": burst, "select": select})


def domain_outage_trace(seed: int = 0, *, w: int = 64, num_domains: int = 8,
                        outages: int = 2, n_keys: int = 2048) -> Trace:
    """Correlated failure-domain outages: a whole rack/power-feed domain
    (bucket % num_domains) dies at once, then is restored."""
    ev: list[TraceEvent] = [TraceEvent("lookup", n_keys=n_keys)]
    for d in range(outages):
        domain = d % num_domains
        ev.append(TraceEvent("remove", select="domain", domain=domain))
        ev.append(TraceEvent("lookup", n_keys=n_keys, k=1))
        ev.append(TraceEvent("add", count=max(1, w // num_domains)))
        ev.append(TraceEvent("lookup", n_keys=n_keys))
    return Trace("domain_outage", seed, w, ev, num_domains=num_domains,
                 meta={"outages": outages})


def staged_scaling_trace(seed: int = 0, *, w: int = 32, stages: int = 3,
                         step: int = 16, n_keys: int = 1536) -> Trace:
    """Staged scale-up then scale-down: capacity ramps in ``stages`` steps
    of ``step`` nodes and back (LIFO removals — every algorithm supports
    the scale-down leg, Jump included)."""
    ev: list[TraceEvent] = [TraceEvent("lookup", n_keys=n_keys)]
    for _ in range(stages):
        ev.append(TraceEvent("add", count=step))
        ev.append(TraceEvent("lookup", n_keys=n_keys))
    for _ in range(stages):
        ev.append(TraceEvent("remove", count=step, select="lifo"))
        ev.append(TraceEvent("lookup", n_keys=n_keys))
    return Trace("staged_scaling", seed, w, ev,
                 meta={"stages": stages, "step": step})


def zipf_trace(seed: int = 0, *, w: int = 64, batches: int = 6,
               skew: float = 1.2, n_keys: int = 4096) -> Trace:
    """Zipf-skewed key traffic (hot keys dominate) across a mid-trace
    failure — balance of a consistent hash is over the KEY SPACE, so a
    skewed workload must still satisfy the placement guarantees while the
    per-bucket traffic is legitimately unequal."""
    ev: list[TraceEvent] = []
    for i in range(batches):
        ev.append(TraceEvent("lookup", n_keys=n_keys, dist="zipf", skew=skew))
        if i == batches // 2:
            ev.append(TraceEvent("remove", count=max(1, w // 8)))
    return Trace("zipf_traffic", seed, w, ev, meta={"skew": skew})


def session_affinity_trace(seed: int = 0, *, replicas: int = 8,
                           rounds: int = 6, sessions: int = 512,
                           fail_round: int = 2, restore_round: int = 4,
                           k: int = 2) -> Trace:
    """Session-affinity serving with failovers: a fixed session population
    routes every round through the ``SessionRouter``; mid-run a replica is
    marked failed (failover BEFORE the delta lands), then removed, then
    capacity is restored."""
    ev: list[TraceEvent] = []
    for rnd in range(rounds):
        if rnd == fail_round:
            ev.append(TraceEvent("mark_failed", select="first", sync=False))
            ev.append(TraceEvent("route", n_keys=sessions))  # failover path
            ev.append(TraceEvent("fail", select="first"))
        if rnd == restore_round:
            ev.append(TraceEvent("restore"))
        ev.append(TraceEvent("route", n_keys=sessions))
    return Trace("session_affinity", seed, replicas, ev,
                 meta={"sessions": sessions, "rounds": rounds,
                       "fail_round": fail_round, "replicas_k": k})


def serving_failure_trace(seed: int = 0, *, replicas: int = 4,
                          rounds: int = 6, fail_at: int = 3) -> Trace:
    """The churn script of the reference's ``examples/serve_cluster.py``:
    decode rounds with ONE mid-run replica failure (lowest id)."""
    ev: list[TraceEvent] = []
    for rnd in range(rounds):
        if rnd == fail_at:
            ev.append(TraceEvent("fail", select="first"))
        ev.append(TraceEvent("route", n_keys=1))  # one decode round
    return Trace("serving_failure", seed, replicas, ev,
                 meta={"rounds": rounds, "fail_at": fail_at})


#: name → generator registry; ``make_trace`` is the string-keyed entry the
#: benchmark and CLI use.  The first three are the paper's §VIII scenarios.
SCENARIOS = {
    "stable": stable_trace,
    "oneshot": oneshot_trace,
    "incremental": incremental_trace,
    "flapping": flapping_trace,
    "churn_storm": churn_storm_trace,
    "churn_storm_xl": churn_storm_xl_trace,
    "domain_outage": domain_outage_trace,
    "staged_scaling": staged_scaling_trace,
    "zipf_traffic": zipf_trace,
    "session_affinity": session_affinity_trace,
    "serving_failure": serving_failure_trace,
}


def make_trace(name: str, seed: int = 0, **kw) -> Trace:
    """Build a built-in scenario trace by name (see :data:`SCENARIOS`)."""
    if name not in SCENARIOS:
        raise ValueError(f"unknown scenario {name!r} "
                         f"(have: {', '.join(sorted(SCENARIOS))})")
    return SCENARIOS[name](seed, **kw)
