"""The port's sharded streaming plane (on the CPU, device lists of CPU
entries) against the reference's single-device lookups: the plane over
every algorithm, dense and packed, at k = 1 and 2 and 1 to 3 entries;
``route_stream`` across epoch flips; the re-pin rule; the router's
streaming path (plain, failover, fleet collapse, packed, overlap); and the
scenario driver's ``sharded=True`` replays, exactly.  The reference's own
sharded plane is never the comparand."""
from __future__ import annotations

import numpy as np
import pytest

from repro.core import ALGORITHMS
from repro.core import DeviceImageStore as RefStore
from repro.serve.router import SessionRouter as RefRouter
from repro.sim import make_trace as ref_make_trace
from repro.sim import replay as ref_replay
from repro.sim.traces import Trace as RefTrace
from repro_torch.core.image_store import DeviceImageStore
from repro_torch.core.protocol import ALGORITHM_REGISTRY
from repro_torch.kernels.engine import PACKED_KERNELS
from repro_torch.serve.plane import LANES, ShardedLookupPlane
from repro_torch.serve.router import SessionRouter
from repro_torch.sim import ScenarioDriver, Trace, TraceEvent, make_trace

from conformance import state
from test_torch_algorithms import _from_state

KEYS = np.random.default_rng(12).integers(0, 2**32, size=4321, dtype=np.uint32)
LAYOUTS = ([(a, "dense") for a in ALGORITHMS]
           + [(a, "packed") for a in ALGORITHMS if a in PACKED_KERNELS])


def _stores(algo: str, packed: bool, removals: int = 30):
    ref_h = state(algo, 96, removals, seed=11)
    port_h = _from_state(algo, ref_h)
    return (DeviceImageStore(port_h, device="cpu", compact=packed), port_h,
            RefStore(ref_h, compact=packed), ref_h)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("entries", [1, 2, 3])
@pytest.mark.parametrize("algo,layout", LAYOUTS)
def test_plane_matches_reference_store(algo, layout, entries, k):
    store, _, ref, _ = _stores(algo, layout == "packed")
    assert store.image().packed == (layout == "packed")
    plane = ShardedLookupPlane(store, devices=["cpu"] * entries, k=k)
    got = plane.lookup(KEYS)
    want = np.asarray(ref.lookup(KEYS, plane="jnp", k=k))
    assert got.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert plane.lanes == entries * LANES and plane.copies == 0


@pytest.mark.parametrize("algo", ALGORITHMS)
def test_plane_over_an_image_and_a_host_state(algo):
    store, port_h, ref, ref_h = _stores(algo, False)
    want = np.asarray(ref.lookup(KEYS[:700], plane="jnp"))
    for source in (store.image(), port_h):
        plane = ShardedLookupPlane(source, devices=["cpu", "cpu"])
        np.testing.assert_array_equal(plane.lookup(KEYS[:700]), want)
    plane = ShardedLookupPlane(port_h, devices=["cpu"])
    plane.lookup(KEYS[:10])
    victim = port_h.size - 1 if ALGORITHM_REGISTRY[algo].lifo_only else min(port_h.working_set())
    port_h.remove(victim)
    ref_h.remove(victim)
    got = plane.lookup(KEYS[:700])  # the host state is snapshotted again
    np.testing.assert_array_equal(got, [ref_h.lookup(int(x)) for x in KEYS[:700]])
    assert plane.repins == 2


@pytest.mark.parametrize("algo", ALGORITHMS)
def test_route_stream_tracks_epoch_flips(algo):
    store, port_h, _, ref_h = _stores(algo, False, removals=10)
    plane = ShardedLookupPlane(store, devices=["cpu"] * 2)
    keys = KEYS[:1000]
    want = []

    def batches():
        for i in range(4):
            if i in (1, 3):
                if ALGORITHM_REGISTRY[algo].lifo_only:
                    victim = port_h.size - 1
                else:
                    victim = sorted(port_h.working_set())[i]
                port_h.remove(victim)
                ref_h.remove(victim)
                store.sync()  # flips between batches; the plane must re-pin
            want.append([ref_h.lookup(int(x)) for x in keys])
            yield keys

    got = list(plane.route_stream(batches()))
    assert len(got) == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (got[0] != got[1]).any() and plane.repins == 3
    assert plane._image is store.image()


def test_flip_repins_only_the_changed_arrays():
    """Entry 0 ("cpu:0") is not the store's device and holds copies; entry 1
    is, and reads the store's own tensors.  A delta replaces only the
    arrays it touched, and only those are copied again."""
    store, port_h, _, _ = _stores("anchor", False, removals=5)
    plane = ShardedLookupPlane(store, devices=["cpu:0", "cpu"])
    plane.lookup(KEYS[:300])
    names = sorted(store.image().arrays)
    assert plane.copies == len(names) == 2
    own = plane._dev[plane.devices[1]]
    assert all(own.arrays[n] is store.image().arrays[n] for n in names)
    plane.lookup(KEYS[:300])
    assert plane.copies == 2 and plane.repins == 1  # no flip, no copy
    before = dict(store.image().arrays)
    port_h.remove(min(port_h.working_set()))
    store.sync()
    changed = [n for n in names if store.image().arrays[n] is not before[n]]
    assert 0 < len(changed) <= len(names)
    plane.lookup(KEYS[:300])
    assert plane.repins == 2 and plane.copies == 2 + len(changed)
    np.testing.assert_array_equal(plane.lookup(KEYS), store.lookup(KEYS).numpy())


def test_plane_rejects_bad_arguments():
    store = _stores("memento", False)[0]
    with pytest.raises(ValueError):
        ShardedLookupPlane(store, devices=["cpu"], k=0)
    with pytest.raises(ValueError):
        ShardedLookupPlane(store, devices=["cpu"], sync_mode="lazy")
    with pytest.raises(ValueError):
        ShardedLookupPlane(store, devices=[])
    empty = ShardedLookupPlane(store, devices=["cpu"] * 2).lookup(np.zeros(0, np.uint32))
    assert empty.shape == (0,) and empty.dtype == np.int32


# ---------------------------------------------------------------------------
# SessionRouter.route_stream
# ---------------------------------------------------------------------------

IDS = [np.random.default_rng(60 + i).integers(0, 2**63, size=700, dtype=np.uint64)
       for i in range(6)]


def _stream(port, ref, events, devices=("cpu", "cpu")):
    """Stream ``IDS`` through the port router; before batch i, apply
    ``events[i]`` (a method name) to both routers and take the reference's
    ``route_batch`` of the batch as the expected result."""
    want = []
    port.image_store()
    ref.image_store()

    def batches():
        for i, ids in enumerate(IDS):
            for ev in events.get(i, ()):
                assert getattr(port, ev[0])(*ev[1:]) == getattr(ref, ev[0])(*ev[1:])
            want.append(np.asarray(ref.route_batch(ids)))
            yield ids

    got = list(port.route_stream(batches(), devices=list(devices)))
    assert len(got) == len(want) == len(IDS)
    for g, w in zip(got, want):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    return got


@pytest.mark.parametrize("sync_mode", ["block", "overlap"])
def test_router_route_stream_matches_reference(sync_mode):
    port = SessionRouter(40, device="cpu", sync_mode=sync_mode)
    ref = RefRouter(40)  # served at the epoch each batch lands on
    events = {2: [("fail_replica", 7)], 3: [("fail_replica", 30), ("fail_replica", 3)],
              5: [("restore_replica",)]}
    got = _stream(port, ref, events)
    assert (got[1] != got[2]).any()
    assert port.stats.routed == sum(len(i) for i in IDS)
    assert port.route_stream is not None and port.sharded_plane() is port.sharded_plane()


def test_router_route_stream_fails_over_marked_replicas():
    port, ref = SessionRouter(8, device="cpu", replicas_k=2), RefRouter(8, replicas_k=2)
    primary = ref.route_batch(IDS[0])
    victim = int(np.bincount(primary).argmax())
    events = {1: [("mark_failed", victim)], 3: [("fail_replica", victim)],
              4: [("mark_failed", 2)]}
    got = _stream(port, ref, events)
    assert victim not in set(got[1].tolist()) and port.stats.failovers > 0
    assert port.stats.failovers == ref.stats.failovers


def test_router_route_stream_survives_fleet_collapse():
    port, ref = SessionRouter(3, device="cpu", replicas_k=2), RefRouter(3, replicas_k=2)
    events = {0: [("fail_replica", 2), ("fail_replica", 1), ("mark_failed", 0)]}
    got = _stream(port, ref, events, devices=("cpu",))
    assert all((g == 0).all() for g in got)


@pytest.mark.parametrize("algo", [a for a in ALGORITHMS if a in PACKED_KERNELS])
def test_router_route_stream_with_compact_images(algo):
    port = SessionRouter(60, algo=algo, capacity=240, device="cpu", compact_images=True)
    ref = RefRouter(60, algo=algo, capacity=240, compact_images=True)
    assert port.image_store().image().packed
    _stream(port, ref, {1: [("fail_replica", 9)], 4: [("restore_replica",)]},
            devices=("cpu",) * 3)


def test_router_default_plane_follows_the_router_device():
    port = SessionRouter(16, device="cpu")
    assert port.sharded_plane().devices == [port.device]
    explicit = port.sharded_plane(devices=["cpu"] * 2)
    assert explicit is not port.sharded_plane() and len(explicit.devices) == 2
    assert port.sharded_plane(devices=["cpu", "cpu"]) is explicit


# ---------------------------------------------------------------------------
# ScenarioDriver(sharded=True)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scenario", ["stable", "oneshot", "incremental"])
@pytest.mark.parametrize("algo", ALGORITHMS)
def test_sharded_replay_matches_reference(scenario, algo):
    trace = make_trace(scenario, 0, w=48, n_keys=600)
    want = ref_replay(ref_make_trace(scenario, 0, w=48, n_keys=600), algo=algo, plane="jnp")
    driver = ScenarioDriver(trace, algo=algo, device="cpu", sharded=True)
    got = driver.run()
    assert want.ok and got.ok and got.fingerprint == want.fingerprint
    assert set(driver._planes_sharded) == {1}


@pytest.mark.parametrize("algo", ALGORITHMS)
def test_sharded_replay_fans_out_both_k(algo):
    ev = [TraceEvent("lookup", n_keys=300, k=1), TraceEvent("lookup", n_keys=300, k=2),
          TraceEvent("remove", count=5), TraceEvent("lookup", n_keys=300, k=2),
          TraceEvent("add", count=2), TraceEvent("lookup", n_keys=300, k=1)]
    trace = Trace("fanout", 3, 40, ev)
    want = ref_replay(RefTrace.from_json(trace.to_json()), algo=algo, plane="jnp")
    driver = ScenarioDriver(trace, algo=algo, device="cpu", sharded=True)
    got = driver.run()
    assert got.ok and got.fingerprint == want.fingerprint
    planes = driver._planes_sharded
    assert set(planes) == {1, 2}
    assert all(p.devices == [driver.store.device] and p.repins >= 1 for p in planes.values())
