"""The port's own copies of the reference's host modules (hashing, jump,
protocol, memento) and the state converters, against the reference."""
from __future__ import annotations

import numpy as np
import pytest

import repro.core.hashing as rh
import repro.core.jump as rj
from conformance import churn_mixed, state
from repro.core import ALGORITHMS as REF_ALGORITHMS
from repro.core import image_fingerprint as ref_fingerprint
from repro.core import make_hash as ref_make_hash
from repro.core import random_state as ref_random_state
from repro.core.protocol import REPLICA_SALT_CAP, round_up
from repro_torch.convert import image_from_arrays, memento_from_state
from repro_torch.core import hashing as ph
from repro_torch.core import jump as pj
from repro_torch.core import protocol as pp
from repro_torch.core.memento import MementoHash, random_state

SCALARS = [0, 1, 2**31, 2**32 - 1, 2**32, 2**63 + 5, 2**64 - 1, 123456789]
KEYS64 = np.random.default_rng(4).integers(0, 2**63, size=2000, dtype=np.uint64)


@pytest.mark.parametrize("name", ["MASK32", "MASK64", "GOLDEN32", "_C1_32", "_C2_32",
                                  "LCG_MULT"])
def test_constants(name):
    assert getattr(ph, name) == getattr(rh, name)


@pytest.mark.parametrize("fn", ["fmix32", "fmix64", "key_to_u32"])
def test_scalar_hashes(fn):
    for x in SCALARS:
        assert getattr(ph, fn)(x) == getattr(rh, fn)(x)
    assert ph.key_to_u32("session-7") == rh.key_to_u32("session-7")


@pytest.mark.parametrize("fn", ["hash2_32", "hash2_64"])
def test_scalar_hash2(fn):
    for x in SCALARS:
        for seed in (0, 1, 999_999):
            assert getattr(ph, fn)(x, seed) == getattr(rh, fn)(x, seed)


def test_numpy_hashes():
    k32 = rh.np_key_to_u32(KEYS64)
    np.testing.assert_array_equal(ph.np_key_to_u32(KEYS64), k32)
    np.testing.assert_array_equal(ph.np_fmix32(k32), rh.np_fmix32(k32))
    np.testing.assert_array_equal(ph.np_hash2_32(k32, 77), rh.np_hash2_32(k32, 77))


@pytest.mark.parametrize("n", [1, 2, 129, 10**6])
def test_jump(n):
    k32 = rh.np_key_to_u32(KEYS64)
    np.testing.assert_array_equal(pj.np_jump32(k32, n), rj.np_jump32(k32, n))
    np.testing.assert_array_equal(pj._step_u24(k32, 3), rj._step_u24(k32, 3))
    for key in KEYS64[:50].tolist():
        assert pj.jump64(key, n) == rj.jump64(key, n)
        assert pj.jump32(key, n) == rj.jump32(key, n)
    with pytest.raises(ValueError):
        pj.np_jump32(k32, 0)


def _pair(n0: int, variant: str):
    return MementoHash(n0, variant=variant), ref_make_hash("memento", n0, variant=variant)


class _Both:
    """Drives one event sequence of ``churn_mixed`` into the port's and the
    reference's host state, checking them equal after every event."""

    def __init__(self, port, ref):
        self.port, self.ref = port, ref
        self.name = ref.name

    @property
    def working(self):
        return self.ref.working

    @property
    def size(self):
        return self.ref.size

    def working_set(self):
        return self.ref.working_set()

    def remove(self, b):
        self.port.remove(b)
        self.ref.remove(b)
        self.check()

    def add(self):
        assert self.port.add() == self.ref.add()
        self.check()

    def check(self):
        p, r = self.port, self.ref
        assert (p.n, p.l, p.R, p.epoch) == (r.n, r.l, r.R, r.epoch)
        assert (p.working, p.memory_bytes()) == (r.working, r.memory_bytes())
        for key in KEYS64[:12].tolist():
            assert p.lookup(key) == r.lookup(key)


@pytest.mark.parametrize("variant", ["32", "64"])
def test_memento_host_matches_reference(variant):
    both = _Both(*_pair(60, variant))
    churn_mixed(both, 120, seed=5, p_remove=0.6)
    p, r = both.port, both.ref
    assert p.working_set() == r.working_set()
    for key in KEYS64[:50].tolist():
        assert p.lookup_k(key, 3) == r.lookup_k(key, 3)
    for since in (0, r.epoch - 7, r.epoch):
        dp, dr = p.device_delta(since), r.device_delta(since)
        assert (dp.base_epoch, dp.epoch, dp.n, dp.scalars) == \
            (dr.base_epoch, dr.epoch, dr.n, dr.scalars)
        assert dp.updates.keys() == dr.updates.keys()
        for name in dr.updates:
            for a, b in zip(dp.updates[name], dr.updates[name]):
                np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(p.device_image(capacity=300).arrays["repl"].numpy(),
                                  r.device_image(capacity=300).arrays["repl"])


def test_memento_errors_match_reference():
    p, r = _pair(3, "32")
    for h in (p, r):
        with pytest.raises(ValueError):
            h.remove(3)
        h.remove(0)
        h.remove(1)
        with pytest.raises(ValueError):
            h.remove(2)  # the last working bucket
    with pytest.raises(ValueError):
        MementoHash(0)
    with pytest.raises(ValueError):
        MementoHash(4, variant="16")


def test_random_state_matches_reference():
    p = random_state(np.random.default_rng(8), 300, 120, variant="32")
    r = ref_random_state(np.random.default_rng(8), 300, 120, variant="32")
    assert (p.n, p.l, p.R) == (r.n, r.l, r.R)


def test_delta_log_window_matches_reference():
    p, r = _pair(10, "32")
    for h in (p, r):
        h._DELTA_LOG_CAP = 8
        for _ in range(30):
            h.add()
    assert p.device_delta(0) is None and r.device_delta(0) is None
    assert p.device_delta(p.epoch - 3).n == r.device_delta(r.epoch - 3).n
    with pytest.raises(ValueError):
        p.device_delta(p.epoch + 1)


def test_protocol_helpers():
    assert pp.REPLICA_SALT_CAP == REPLICA_SALT_CAP
    assert pp.ALGORITHMS == REF_ALGORITHMS
    assert [pp.round_up(x) for x in (0, 1, 128, 129)] == [round_up(x) for x in (0, 1, 128, 129)]
    assert pp.required_lengths("memento", 77) == {"repl": 77}
    with pytest.raises(ValueError):
        pp.make_hash("rendezvous", 8)
    for algo in sorted(set(pp.ALGORITHMS) - set(pp.ALGORITHM_REGISTRY)):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            pp.make_hash(algo, 8)


@pytest.mark.parametrize("removals", [0, 30, 55])
def test_converted_state_and_image_match_reference(removals):
    h = state("memento", 60, removals, seed=2)
    img = h.device_image(capacity=256)
    port_img = image_from_arrays(img.algo, img.n, img.arrays, img.scalars, img.epoch)
    assert pp.image_fingerprint(port_img) == ref_fingerprint(img)
    assert pp.image_scalar_vec(port_img) == [img.n]
    m = memento_from_state(h.n, h.l, h.R, epoch=h.epoch)
    assert pp.image_fingerprint(m.device_image()) == ref_fingerprint(h.device_image())
    for key in KEYS64[:100].tolist():
        assert m.lookup(key) == h.lookup(key)
