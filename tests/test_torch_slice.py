"""The slice end to end: the paper's §VIII scenarios (stable, one-shot 90 %
removal, incremental removals) through the port's SessionRouter on the
CPU and the reference router on its Pallas plane (interpret mode), at
n = 2000, exactly."""
from __future__ import annotations

import numpy as np
import pytest

from repro.core.hashing import np_key_to_u32
from repro.serve.router import SessionRouter as RefRouter
from repro_torch.serve.router import SessionRouter

N = 2000


def _ids(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 2**63, size=2048, dtype=np.uint64)


@pytest.fixture
def routers():
    port = SessionRouter(N, device="cpu")
    ref = RefRouter(N, use_device_plane=True)
    for r in (port, ref):
        r.image_store()
    return port, ref


def _same(port, ref, seed: int) -> np.ndarray:
    ids = _ids(seed)
    got = port.route_batch(ids)
    np.testing.assert_array_equal(got, np.asarray(ref.route_batch(ids)))
    working = port.ch.working_set()
    assert all(int(b) in working for b in np.unique(got))
    return got


def test_stable(routers):
    port, ref = routers
    for seed in range(3):
        _same(port, ref, seed)


def test_oneshot_removal_of_90_percent(routers):
    port, ref = routers
    before = _same(port, ref, 0)
    victims = np.random.default_rng(7).permutation(N)[: int(0.9 * N)]
    for b in victims.tolist():
        port.ch.remove(b)
        ref.ch.remove(b)
    got, want = port.image_store().sync(), ref.image_store().sync()
    assert (got.mode, got.events, got.words) == (want.mode, want.events, want.words)
    after = _same(port, ref, 0)
    k = np_key_to_u32(_ids(0))
    diff = port.image_store().migration_diff(k)
    ref_diff = ref.image_store().migration_diff(k, plane="pallas")
    np.testing.assert_array_equal(diff.moved.numpy(), ref_diff.moved)
    np.testing.assert_array_equal(diff.moved.numpy(), before != after)


def test_incremental_removals(routers):
    port, ref = routers
    rng = np.random.default_rng(9)
    for event in range(30):
        victim = int(rng.choice(sorted(port.ch.working_set())))
        assert port.fail_replica(victim) == ref.fail_replica(victim)
        assert port.image_store().last_sync.mode == "delta"
        _same(port, ref, event)
    assert port.image_store().totals.__dict__ == ref.image_store().totals.__dict__
