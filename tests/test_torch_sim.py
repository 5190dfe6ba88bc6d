"""The port's scenario engine against the reference's: every built-in
scenario (but the fleet-scale ``churn_storm_xl``) × every algorithm
replays to the reference's fingerprint on the port's device plane (the
plain torch versions, on the CPU) and host plane, with every checker
silent, and so do ``replica_k = 2`` replays and bounded assignment; the
resolved trace replays bit for bit; traces, checkers and metrics match
the reference's copies; the features once cut replay as the reference's."""
from __future__ import annotations

import json

import numpy as np
import pytest

from repro.core import ALGORITHMS
from repro.core import make_hash as ref_make_hash
from repro.sim import checkers as ref_checkers
from repro.sim import make_trace as ref_make_trace
from repro.sim import replay as ref_replay
from repro.sim import resolve_victims as ref_resolve_victims
from repro.sim.traces import Trace as RefTrace
from repro.sim.metrics import ScenarioMetrics as RefMetrics
from repro_torch.core.protocol import make_hash
from repro_torch.sim import (SCENARIOS, ScenarioDriver, Trace, TraceEvent, checkers,
                             make_trace, replay, resolve_victims)
from repro_torch.sim.metrics import ScenarioMetrics

REPLAYED = sorted(set(SCENARIOS) - {"churn_storm_xl"})
#: summary keys that hold host-clock times or name the plane
UNTIMED = ("plane", "us_per_key", "us_mean")


def _untimed(summary: dict) -> dict:
    return {k: v for k, v in summary.items() if not any(t in k for t in UNTIMED)}


@pytest.mark.parametrize("scenario", REPLAYED)
@pytest.mark.parametrize("algo", ALGORITHMS)
def test_replay_matches_reference(scenario, algo):
    want = ref_replay(ref_make_trace(scenario, 0), algo=algo, plane="jnp")
    dev = replay(make_trace(scenario, 0), algo=algo, plane="device", device="cpu")
    host = replay(make_trace(scenario, 0), algo=algo, plane="host", device="cpu")
    assert want.ok and dev.ok and host.ok, (dev.violations, host.violations)
    assert dev.fingerprint == want.fingerprint == host.fingerprint
    assert _untimed(dev.summary()) == _untimed(want.summary()) == _untimed(host.summary())
    assert dev.resolved.to_dict() == want.resolved.to_dict()
    again = replay(Trace.from_json(dev.resolved.to_json()), algo=algo, plane="device",
                   device="cpu")
    assert again.fingerprint == dev.fingerprint and again.ok


def _assign_trace(seed: int = 5) -> Trace:
    """Bounded assignment and k-replica lookups across removals and a join."""
    ev = [TraceEvent("lookup", n_keys=300, k=3),
          TraceEvent("assign", n_keys=400, cap_c=1.25),
          TraceEvent("remove", count=6),
          TraceEvent("lookup", n_keys=300, k=2),
          TraceEvent("assign", n_keys=250, cap_c=1.1),
          TraceEvent("add", count=2),
          TraceEvent("assign", n_keys=300, cap_c=1.5)]
    return Trace("assign", seed, 48, ev)


@pytest.mark.parametrize("scenario", ["stable", "oneshot", "incremental", "assign"])
@pytest.mark.parametrize("algo", ALGORITHMS)
def test_replica_and_assign_replays_match_reference(algo, scenario):
    """``replica_k = 2`` (the replica-stability checker on) over the
    paper's scenarios and a bounded-assignment trace: the port's device
    and host planes replay to the reference's fingerprint, silently."""
    trace = (_assign_trace() if scenario == "assign"
             else make_trace(scenario, 0, w=48, n_keys=600))
    want = ref_replay(RefTrace.from_json(trace.to_json()), algo=algo, plane="jnp",
                      replica_k=2, probe_keys=600)
    dev = replay(trace, algo=algo, plane="device", device="cpu", replica_k=2, probe_keys=600)
    host = replay(trace, algo=algo, plane="host", device="cpu", replica_k=2, probe_keys=600)
    assert want.ok and dev.ok and host.ok, (dev.violations, host.violations)
    assert dev.fingerprint == want.fingerprint == host.fingerprint
    assert _untimed(dev.summary()) == _untimed(want.summary()) == _untimed(host.summary())
    assert dev.resolved.to_dict() == want.resolved.to_dict()


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_traces_match_reference(scenario):
    got = make_trace(scenario, 3)
    assert got.to_dict() == ref_make_trace(scenario, 3).to_dict()
    assert Trace.from_json(got.to_json()).to_dict() == json.loads(got.to_json())
    assert got.membership_events == ref_make_trace(scenario, 3).membership_events


def test_trace_grammar_is_checked():
    for bad in (dict(op="explode"), dict(op="remove", select="any"),
                dict(op="remove", count=0), dict(op="remove", select="domain"),
                dict(op="lookup"), dict(op="assign", n_keys=4),
                dict(op="lookup", n_keys=4, dist="zipf", skew=0.5),
                dict(op="remove", bucket=3, count=2)):
        with pytest.raises(ValueError):
            TraceEvent(**bad)
    with pytest.raises(ValueError):
        make_trace("nope")


@pytest.mark.parametrize("algo", ALGORITHMS)
def test_victims_match_reference(algo):
    ref = ref_make_hash(algo, 64, capacity=256, variant="32")
    port = make_hash(algo, 64, capacity=256, variant="32")
    events = [TraceEvent("remove", count=5), TraceEvent("remove", select="lifo", count=3),
              TraceEvent("remove", select="first", count=2),
              TraceEvent("remove", select="domain", domain=1),
              TraceEvent("remove", bucket=7)]
    r_rng, p_rng = np.random.default_rng(4), np.random.default_rng(4)
    for ev in events:
        got = resolve_victims(port, ev, p_rng, num_domains=8)
        assert got == ref_resolve_victims(ref, ev, r_rng, num_domains=8)


def test_checkers_match_reference():
    rng = np.random.default_rng(11)
    old = rng.integers(0, 40, size=3000)
    new = np.where(np.isin(old, [3, 9]), rng.integers(0, 40, size=3000), old)
    new[:5] = 9  # keys landing on a removed bucket
    new[10:20] = (old[10:20] + 1) % 40  # keys moving without cause
    for removed, added in (({3, 9}, set()), (set(), {9}), ({3}, {9}), (set(), set())):
        got = checkers.check_minimal_disruption(2, old, new, removed, added)
        want = ref_checkers.check_minimal_disruption(2, old, new, removed, added)
        assert [(v.checker, v.detail) for v in got] == [(v.checker, v.detail) for v in want]
    working = [b for b in range(40) if b not in (3, 9)]
    for placements in (new, np.full(3000, 5)):
        g = checkers.balance_profile(placements, working)
        w = ref_checkers.balance_profile(placements, working)
        np.testing.assert_array_equal(g["counts"], w["counts"])
        assert (g["mean"], g["cv_normalized"]) == (w["mean"], w["cv_normalized"])
        assert [v.detail for v in checkers.check_balance(1, placements, working)] == \
            [v.detail for v in ref_checkers.check_balance(1, placements, working)]
    moved = rng.random(3000) < 0.1
    hits = rng.random(3000) < 0.5
    assert [v.detail for v in checkers.check_replica_stability(0, moved, hits)] == \
        [v.detail for v in ref_checkers.check_replica_stability(0, moved, hits)]
    load = rng.integers(0, 9, size=40)
    assert [v.detail for v in checkers.check_cap_invariant(0, old, load, 6)] == \
        [v.detail for v in ref_checkers.check_cap_invariant(0, old, load, 6)]
    for prof in ([(0.1, 1.0), (0.5, 1.2), (0.7, 1.5), (0.9, 4.0)], [(0.1, 2.0), (0.5, 1.0)],
                 [(0.1, 1.0), (0.5, 2.0), (0.9, 3.0)]):
        assert checkers.degradation_knee(prof) == ref_checkers.degradation_knee(prof)


@pytest.mark.parametrize("algo", ALGORITHMS)
def test_candidate_hits_match_reference(algo):
    ref = ref_make_hash(algo, 50, capacity=200, variant="32")
    port = make_hash(algo, 50, capacity=200, variant="32")
    probe = np.random.default_rng(2).integers(0, 2**32, size=300, dtype=np.uint32)
    victims = {ref.size - 1, 4}
    np.testing.assert_array_equal(checkers.candidate_hits(port, probe, 3, victims),
                                  ref_checkers.candidate_hits(ref, probe, 3, victims))


def test_metrics_fingerprint_and_summary_match_reference():
    from repro.sim.metrics import EventRecord as RefRecord
    from repro_torch.sim.metrics import EventRecord
    got, want = ScenarioMetrics(), RefMetrics()
    rng = np.random.default_rng(3)
    for i in range(6):
        arr = rng.integers(-1, 2**31, size=100).astype(np.int32)
        got.fingerprint_update(arr)
        want.fingerprint_update(arr)
        rec = dict(index=i, op=("remove", "lookup", "add")[i % 3], buckets=[i, i + 1],
                   moved=i, sync_mode=("delta", "", "snapshot")[i % 3], sync_words=10 * i,
                   sync_us=2.5 * i, keys=(0, 64, 0)[i % 3], us_per_key=(0, 0.5, 0)[i % 3])
        got.add_record(EventRecord(**rec))
        want.add_record(RefRecord(**rec))
        got.add_degradation_point(0.1 * i, 1.0 + i)
        want.add_degradation_point(0.1 * i, 1.0 + i)
    assert got.fingerprint == want.fingerprint
    assert got.summary() == pytest.approx(want.summary())


def test_overlapped_syncs_replay_to_the_same_fingerprint():
    trace = make_trace("churn_storm", 1)
    block = replay(trace, algo="anchor", device="cpu")
    overlap = replay(trace, algo="anchor", device="cpu", sync_mode="overlap")
    assert overlap.fingerprint == block.fingerprint and overlap.ok
    assert overlap.summary()["sync_dispatch_us_mean"] > 0


def test_cut_features_raise():
    """No feature of the reference's driver is cut any more: telemetry,
    followers, the sharded plane, k-replica lookups, ``replica_k > 1``,
    ``assign`` events and ``session_affinity`` replay as the reference
    replays them."""
    trace = make_trace("stable", 0, w=16, batches=1, n_keys=8)
    want = ref_replay(RefTrace.from_json(trace.to_json()), plane="jnp", telemetry=True)
    got = replay(trace, device="cpu", telemetry=True)
    assert got.fingerprint == want.fingerprint
    assert got.summary()["telemetry"]["counters"] == want.summary()["telemetry"]["counters"]
    storm = dict(seed=1, w=64, storms=2, burst=8, n_keys=256)
    want = ref_replay(ref_make_trace("churn_storm", **storm), plane="jnp", followers=2)
    got = replay(make_trace("churn_storm", **storm), device="cpu", followers=2)
    assert got.ok and want.ok and got.fingerprint == want.fingerprint
    assert _untimed(got.summary()) == _untimed(want.summary())
    assert got.summary()["followers"] == 2 and got.summary()["follower_lag_max"] >= 1
    assign = Trace("assign", 0, 16, [TraceEvent("assign", n_keys=8, cap_c=1.5)])
    for trace, kw in ((make_trace("stable", 0, w=16, batches=1, n_keys=8), dict(replica_k=2)),
                      (make_trace("stable", 0, w=16, batches=1, n_keys=8, k=2), {}),
                      (assign, {}), (make_trace("session_affinity", 0), {})):
        want = ref_replay(RefTrace.from_json(trace.to_json()), plane="jnp", **kw)
        got = replay(trace, device="cpu", **kw)
        assert got.ok and want.ok and got.fingerprint == want.fingerprint
        # sharded: held against the reference's single-device replay
        got = replay(trace, device="cpu", sharded=True, **kw)
        assert got.ok and got.fingerprint == want.fingerprint
    trace = make_trace("stable", 0, w=16, batches=1, n_keys=8)
    with pytest.raises(ValueError):
        ScenarioDriver(trace, plane="jnp", device="cpu")
    with pytest.raises(ValueError):
        ScenarioDriver(trace, sync_mode="lazy", device="cpu")
