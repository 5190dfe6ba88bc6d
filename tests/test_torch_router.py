"""The port's SessionRouter and BatchScheduler (on the CPU) against the
reference router on one sequence of batches, failures, restores and
failover marks, in both sync modes."""
from __future__ import annotations

import numpy as np
import pytest

from repro.serve.router import BatchScheduler as RefScheduler
from repro.serve.router import Request as RefRequest
from repro.serve.router import SessionRouter as RefRouter
from repro_torch.serve.router import BatchScheduler, Request, SessionRouter

IDS = np.random.default_rng(51).integers(0, 2**63, size=1500, dtype=np.uint64)


def _routers(n: int, **kw):
    return SessionRouter(n, device="cpu", **kw), RefRouter(n, **kw)


def _same_batch(port, ref, ids=IDS):
    got = port.route_batch(ids)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(ref.route_batch(ids)))


@pytest.mark.parametrize("sync_mode", ["block", "overlap"])
def test_route_batch_and_route_across_membership_events(sync_mode):
    port, ref = _routers(200, sync_mode=sync_mode)
    _same_batch(port, ref)
    for victim in (3, 150, 199, 77, 10):
        port.mark_failed(victim)
        ref.mark_failed(victim)
        _same_batch(port, ref)
        got, want = port.fail_replica(victim), ref.fail_replica(victim)
        assert got == want
        assert port._failed == ref._failed
        _same_batch(port, ref)
        assert [port.route(int(s)) for s in IDS[:60]] == [ref.route(int(s)) for s in IDS[:60]]
    for _ in range(3):
        assert port.restore_replica() == ref.restore_replica()
        _same_batch(port, ref)
    port.image_store().flush()
    ref.image_store().flush()
    _same_batch(port, ref)
    assert port.stats.as_dict() == ref.stats.as_dict()
    assert port.replicas == ref.replicas
    assert port.image_store().totals.__dict__ == ref.image_store().totals.__dict__


def test_route_fails_over_on_marked_replicas():
    port, ref = _routers(50, replicas_k=3)
    for victim in (4, 9, 31):
        port.mark_failed(victim)
        ref.mark_failed(victim)
    assert [port.route(int(s)) for s in IDS[:300]] == [ref.route(int(s)) for s in IDS[:300]]
    assert port.stats.failovers == ref.stats.failovers > 0
    assert [port.replica_set(int(s)) for s in IDS[:50]] == \
        [ref.replica_set(int(s)) for s in IDS[:50]]
    _same_batch(port, ref)  # the k-replica batch failover
    assert port.stats.failovers == ref.stats.failovers


@pytest.mark.parametrize("algo", ["memento", "dx"])
@pytest.mark.parametrize("sync_mode", ["block", "overlap"])
def test_k_replica_batch_failover_matches_reference(algo, sync_mode):
    """``route_batch`` with ``replicas_k = 3`` and marked replicas equals
    the reference's, before and after the marked replica's removal lands;
    only the marked replicas' sessions fail over, to their next replica."""
    port, ref = _routers(40, algo=algo, capacity=160, replicas_k=3, sync_mode=sync_mode)
    base = port.route_batch(IDS)
    sets = port.replica_set_batch(IDS)
    np.testing.assert_array_equal(sets, np.asarray(ref.replica_set_batch(IDS)))
    np.testing.assert_array_equal(sets[:, 0], base)
    victims = [int(np.bincount(base).argmax()), int(base[7])]
    for v in victims:
        port.mark_failed(v)
        ref.mark_failed(v)
    after = port.route_batch(IDS)
    np.testing.assert_array_equal(after, np.asarray(ref.route_batch(IDS)))
    assert not set(victims) & set(after.tolist())
    moved = after != base
    assert moved.sum() == np.isin(base, victims).sum()
    assert port.stats.failovers == ref.stats.failovers > 0
    for v in victims:
        assert port.fail_replica(v) == ref.fail_replica(v)
        _same_batch(port, ref)
    assert port.restore_replica() == ref.restore_replica()
    port.mark_failed(sorted(port.replicas)[0])
    ref.mark_failed(sorted(ref.replicas)[0])
    _same_batch(port, ref)
    assert port.stats.as_dict() == ref.stats.as_dict()


def test_all_marked_keeps_the_primary():
    port, ref = _routers(4, replicas_k=2)
    for rep in list(port.replicas):
        port.mark_failed(rep)
        ref.mark_failed(rep)
    got = port.route_batch(IDS[:200])
    np.testing.assert_array_equal(got, port.replica_set_batch(IDS[:200])[:, 0])
    _same_batch(port, ref, IDS[:200])
    assert port.route(7) == port.replica_set(7)[0] == ref.route(7)
    assert port.stats.failovers == 0


def _as_ids(assigned):
    batches, overflow = assigned
    return ({r: [q.session_id for q in qs] for r, qs in batches.items()},
            [q.session_id for q in overflow])


def test_batch_scheduler_assign_matches_reference():
    port, ref = _routers(30)
    ps, rs = BatchScheduler(port, max_batch=8), RefScheduler(ref, max_batch=8)
    for rnd in range(4):
        ids = IDS[rnd * 200:(rnd + 1) * 200].tolist()
        got = _as_ids(ps.assign([Request(i) for i in ids]))
        assert got == _as_ids(rs.assign([RefRequest(i) for i in ids]))
        assert got[1]  # over budget: the overflow is carried, not dropped
        port.fail_replica(rnd + 2)
        ref.fail_replica(rnd + 2)
    assert _as_ids(ps.assign([])) == _as_ids(rs.assign([]))


def test_injected_store_and_unported_paths():
    from repro_torch.core.image_store import DeviceImageStore
    from repro_torch.core.protocol import make_hash

    ch = make_hash("memento", 20, variant="32")
    store = DeviceImageStore(ch, device="cpu")
    router = SessionRouter(20, algo=ch, store=store, device="cpu")
    assert router.image_store() is store
    with pytest.raises(ValueError):
        SessionRouter(20, store=store, device="cpu")  # a different host state
    with pytest.raises(ValueError):
        SessionRouter(20, sync_mode="lazy", device="cpu")
    plane = router.sharded_plane()  # ported: a plane over the injected store
    assert plane._source is store and plane.devices == [store.device]
    (streamed,) = list(router.route_stream([IDS]))
    np.testing.assert_array_equal(streamed, router.route_batch(IDS))
