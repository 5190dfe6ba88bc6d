"""The port's DeviceImageStore against the reference store on one event
sequence: after every event the two front images agree word for word
and the two stores report the same SyncStats, for every algorithm."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from conformance import ALGORITHMS, churn_mixed
from repro.core import DeviceImageStore as RefStore
from repro.core import image_fingerprint as ref_fingerprint
from repro.core import make_hash as ref_make_hash
from repro.core.image_store import delta_fits as ref_delta_fits
from repro_torch.core import protocol as pp
from repro_torch.core.image_store import DeviceImageStore, delta_fits
from repro_torch.core.memento import MementoHash
from repro_torch.core.protocol import make_hash

KEYS = np.random.default_rng(41).integers(0, 2**32, size=512, dtype=np.uint32)


class _Stores:
    """Both host states and both stores, fed one ``churn_mixed`` sequence;
    every event is synced on both sides and compared."""

    def __init__(self, n0: int, *, mode: str = "sync", log_cap: int | None = None,
                 plane: str = "jnp", algo: str = "memento"):
        self.port_h = make_hash(algo, n0, capacity=4 * n0, variant="32")
        self.ref_h = ref_make_hash(algo, n0, capacity=4 * n0, variant="32")
        if log_cap is not None:
            self.port_h._DELTA_LOG_CAP = self.ref_h._DELTA_LOG_CAP = log_cap
        self.port = DeviceImageStore(self.port_h, device="cpu")
        self.ref = RefStore(self.ref_h, plane=plane)
        self.name = algo
        self.mode = mode
        self.stats: list[tuple] = []
        self.every = 1  # sync after every event

    @property
    def working(self):
        return self.ref_h.working

    @property
    def size(self):
        return self.ref_h.size

    def working_set(self):
        return self.ref_h.working_set()

    def remove(self, b):
        self.port_h.remove(b)
        self.ref_h.remove(b)
        self._event()

    def add(self):
        assert self.port_h.add() == self.ref_h.add()
        self._event()

    def _event(self):
        if self.port_h.epoch % self.every:
            return
        if self.mode == "sync":
            got, want = self.port.sync(), self.ref.sync()
        else:
            hp, hr = self.port.sync_async(), self.ref.sync_async()
            assert self.port.epoch == self.ref.epoch  # not flipped yet
            assert hp.ready()
            got, want = hp.stats, hr.stats
            if self.port_h.epoch % 3 == 0:
                assert self.port.poll() and self.ref.poll()
            # otherwise check() lands the pending flip with flush()
        assert (got.mode, got.events, got.words, got.epoch) == \
            (want.mode, want.events, want.words, want.epoch)
        self.stats.append((got.mode, got.words))
        self.check()

    def check(self):
        self.port.flush()
        self.ref.flush()
        p, r = self.port.image(), self.ref.image()
        assert (p.n, p.epoch, p.scalars) == (r.n, r.epoch, r.scalars)
        assert sorted(p.arrays) == sorted(r.arrays)
        for name, arr in r.arrays.items():
            np.testing.assert_array_equal(p.arrays[name].numpy(),
                                          np.asarray(arr).view(np.int32))
        assert pp.image_fingerprint(p) == ref_fingerprint(r)
        assert self.port.capacity == self.ref.capacity
        t = self.ref.totals
        assert self.port.totals.__dict__ == {
            "syncs": t.syncs, "delta_applies": t.delta_applies,
            "snapshot_rebuilds": t.snapshot_rebuilds, "events": t.events,
            "words": t.words}


@pytest.mark.parametrize("plane", ["jnp", "pallas"])
def test_front_image_equals_reference_after_every_event(plane):
    s = _Stores(64, plane=plane)
    churn_mixed(s, 60, seed=1, p_remove=0.6)
    modes = {m for m, _ in s.stats}
    assert modes == {"delta"}
    np.testing.assert_array_equal(s.port.lookup(KEYS).numpy(),
                                  s.ref.lookup(KEYS, plane="jnp"))


def test_snapshot_on_growth_matches_reference():
    s = _Stores(40)  # capacity 128: growth past it forces a snapshot
    churn_mixed(s, 160, seed=2, p_remove=0.2)
    assert "snapshot" in {m for m, _ in s.stats}
    assert s.port.capacity["repl"] > 128


def test_snapshot_on_log_overflow_matches_reference():
    s = _Stores(200, log_cap=8)
    s.every = 20  # the store falls 20 events behind an 8-event log
    churn_mixed(s, 100, seed=3, p_remove=0.7)
    assert {m for m, _ in s.stats} == {"snapshot"}


def test_async_sync_poll_flush_match_reference():
    s = _Stores(64, mode="async")
    churn_mixed(s, 50, seed=4, p_remove=0.6)
    assert s.port.pending is None and s.port.epoch == s.port_h.epoch


def test_noop_sync_and_pending_handle():
    s = _Stores(16)
    assert s.port.sync().mode == s.ref.sync().mode == "noop"
    s.port_h.remove(3)
    h = s.port.sync_async()
    assert not h.done and s.port.pending is h and s.port.epoch == 0
    assert s.port.flush().epoch == 1 and h.done and s.port.pending is None
    assert h.commit().epoch == 1  # idempotent
    assert s.port.previous_image().epoch == 0


def test_migration_diff_matches_reference():
    s = _Stores(120)
    churn_mixed(s, 10, seed=5, p_remove=0.8)
    got = s.port.migration_diff(KEYS)
    want = s.ref.migration_diff(KEYS, plane="pallas")
    np.testing.assert_array_equal(got.old.numpy(), want.old)
    np.testing.assert_array_equal(got.new.numpy(), want.new)
    np.testing.assert_array_equal(got.moved.numpy(), want.moved)
    with pytest.raises(ValueError):
        DeviceImageStore(MementoHash(8, variant="32"), device="cpu").migration_diff(KEYS)


def test_double_buffering_keeps_the_old_epoch():
    h = MementoHash(64, variant="32")
    store = DeviceImageStore(h, device="cpu")
    old = store.image()
    old_words = old.arrays["repl"].clone()
    h.remove(5)
    store.sync()
    assert store.previous_image() is old
    assert torch.equal(old.arrays["repl"], old_words)
    assert store.image().arrays["repl"][5] == 63


def test_delta_fits_matches_reference():
    h = ref_make_hash("memento", 100, variant="32")
    p = MementoHash(100, variant="32")
    for m in (h, p):
        for _ in range(30):
            m.add()
    for caps in ({"repl": 128}, {"repl": 130}, {"repl": 256}, {}):
        assert delta_fits(caps, p.device_delta(0)) == ref_delta_fits(caps, h.device_delta(0))
    for caps in ({"state": 4}, {"state": 5}, {"state": 128}, {}):  # the bitmap rule
        assert delta_fits(caps, p.device_delta(0), compact=True) == \
            ref_delta_fits(caps, h.device_delta(0), compact=True)
    store, ref_store = DeviceImageStore(p, device="cpu", compact=True), RefStore(h, compact=True)
    assert store.image().packed and store.capacity == ref_store.capacity
    assert pp.image_fingerprint(store.image()) == ref_fingerprint(ref_store.image())


@pytest.mark.parametrize("mode", ["sync", "async"])
@pytest.mark.parametrize("algo", ALGORITHMS)
def test_every_algorithm_tracks_the_reference_store(algo, mode):
    """Each churn event synced on both stores: same SyncStats, same front
    image word for word, same capacity (no headroom for the fixed-capacity
    AnchorHash and DxHash; none at all for the tableless Jump and Power)."""
    s = _Stores(40, algo=algo, mode=mode)
    churn_mixed(s, 70, seed=6, p_remove=0.6)
    assert {m for m, _ in s.stats} == {"delta"}
    cap = s.port.capacity
    if algo in ("anchor", "dx"):
        assert cap == {k: int(np.asarray(v).shape[0])
                       for k, v in s.ref_h.device_image().arrays.items()}
    np.testing.assert_array_equal(s.port.lookup(KEYS).numpy(),
                                  s.ref.lookup(KEYS, plane="jnp"))
    got = s.port.migration_diff(KEYS)
    want = s.ref.migration_diff(KEYS)
    np.testing.assert_array_equal(got.old.numpy(), want.old)
    np.testing.assert_array_equal(got.new.numpy(), want.new)


@pytest.mark.parametrize("algo", ALGORITHMS)
def test_every_algorithm_snapshots_like_the_reference(algo):
    """A store that falls behind the delta log rebuilds from a snapshot on
    both sides, with the same words sent."""
    s = _Stores(60, algo=algo, log_cap=8)
    s.every = 20
    churn_mixed(s, 80, seed=7, p_remove=0.6)
    assert {m for m, _ in s.stats} == {"snapshot"}


def test_tableless_delta_carries_only_n():
    s = _Stores(30, algo="jump")
    s.remove(29)
    st = s.port.last_sync
    assert (st.mode, st.words) == ("delta", 0)
    assert s.port.image().arrays == {} and s.port.image().n == 29
    assert s.port.capacity == {}
