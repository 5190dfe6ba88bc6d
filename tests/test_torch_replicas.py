"""The port's k-replica, bounded and chain-walk paths (plain torch versions
of the ``{algo}_replica``, ``{algo}_replica_diff`` and ``{algo}_walk``
kernels, as their wrappers run them on CPU tensors) against the reference
engine on both of its planes (jnp, and Pallas in interpret mode) and
against the host oracles, exactly; and the bounded-load overlay through
the port's store against the reference's."""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from conformance import ALGORITHMS, churn, lifo_only, state
from repro.core import BoundedLoad as RefBoundedLoad
from repro.core import DeviceImageStore as RefStore
from repro.core import make_hash as ref_make_hash
from repro.core import replica_sets as ref_replica_sets
from repro.core.bounded import accept_in_index_order as ref_accept
from repro.core.bounded import bounded_assign_ref as ref_assign_ref
from repro.core.bounded import walk_probe_bound as ref_walk_probe_bound
from repro.core.protocol import image_fingerprint as ref_fingerprint
from repro.kernels import engine as ref
from repro_torch.convert import bounded_from_state, image_from_arrays, memento_from_state
from repro_torch.core import (BoundedLoad, BoundedLoadMemento, DeviceImageStore,
                              accept_in_index_order, bounded_assign_ref, image_fingerprint,
                              make_hash, replica_sets, walk_probe_bound)
from repro_torch.kernels import engine as port

KEYS = np.concatenate([
    np.asarray([0, 1, 2**31, 2**32 - 1], np.uint32),
    np.random.default_rng(31).integers(0, 2**32, size=296, dtype=np.uint32)])
PLANES = ["jnp", "pallas"]
#: conformance states: (initial nodes, removals)
STATES = {"fresh": (16, 0), "churned": (200, 130)}


def _port_image(img):
    return image_from_arrays(img.algo, img.n, img.arrays, img.scalars, img.epoch)


def _pair(algo: str, name: str, seed: int = 3):
    """The reference's conformance state and the port's state after the
    same removals."""
    n0, removals = STATES[name]
    ref_h = state(algo, n0, removals, seed=seed)
    port_h = make_hash(algo, n0, capacity=4 * n0, variant="32")
    churn(port_h, min(removals, n0 - 1) if lifo_only(algo) else removals, seed=seed)
    assert port_h.working_set() == ref_h.working_set()
    return ref_h, port_h


def _bounded_load(ref_h, image, n_keys: int = 256, c: float = 1.25):
    """A load from a bounded assignment of ``n_keys`` keys, and its cap."""
    cap = max(1, math.ceil(c * n_keys / ref_h.working))
    load0 = np.zeros(ref.bounded_load_len(image), np.int32)
    keys = np.random.default_rng(7).integers(0, 2**32, size=n_keys, dtype=np.uint32)
    return ref_assign_ref(ref_h, keys, load0, cap)[1], cap


@pytest.mark.parametrize("plane", PLANES)
@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("name", sorted(STATES))
@pytest.mark.parametrize("algo", ALGORITHMS)
def test_replica_lookup_matches_reference_and_host(algo, name, k, plane):
    ref_h, port_h = _pair(algo, name)
    img = ref_h.device_image()
    got = port.replica_lookup(KEYS, _port_image(img), k, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (len(KEYS), k)
    want = np.asarray(ref.replica_lookup(KEYS, img, k, plane=plane))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(replica_sets(port_h, KEYS, k), ref_replica_sets(ref_h, KEYS, k))
    np.testing.assert_array_equal(got.numpy(), ref_replica_sets(ref_h, KEYS, k))
    flat = port.engine_lookup(KEYS, _port_image(img), k=k, device="cpu")
    assert flat.shape == ((len(KEYS),) if k == 1 else (len(KEYS), k))


@pytest.mark.parametrize("plane", PLANES)
@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("name", sorted(STATES))
@pytest.mark.parametrize("algo", ALGORITHMS)
def test_bounded_lookup_matches_reference_and_host(algo, name, k, plane):
    ref_h, port_h = _pair(algo, name)
    img = ref_h.device_image()
    load, cap = _bounded_load(ref_h, img)
    got = port.engine_lookup(KEYS, _port_image(img), k=k, load=load, cap=cap, device="cpu")
    want = np.asarray(ref.engine_lookup(KEYS, img, k=k, load=load, cap=cap, plane=plane))
    np.testing.assert_array_equal(got.numpy(), want)
    host = ref.bounded_replica_sets(ref_h, KEYS, k, load, cap)
    np.testing.assert_array_equal(port.bounded_replica_sets(port_h, KEYS, k, load, cap), host)
    np.testing.assert_array_equal(got.numpy().reshape(-1, k), host)
    assert (load[got.numpy()] < cap).all()


@pytest.mark.parametrize("algo", ALGORITHMS)
def test_infeasible_bounded_lookup_raises_in_both(algo):
    """Every bucket but one is full: a second slot below the cap does not
    exist, both engines run out of salts and raise."""
    ref_h, _ = _pair(algo, "fresh")
    img = ref_h.device_image()
    load = np.ones(ref.bounded_load_len(img), np.int32)
    load[min(ref_h.working_set())] = 0
    keys = KEYS[:6]
    with pytest.raises(RuntimeError, match="salt budget exhausted"):
        port.engine_lookup(keys, _port_image(img), k=2, load=load, cap=1, device="cpu")
    with pytest.raises(RuntimeError, match="salt budget exhausted"):
        ref.engine_lookup(keys, img, k=2, load=load, cap=1, plane="jnp")
    one = port.engine_lookup(keys, _port_image(img), k=1, load=load, cap=1, device="cpu")
    assert one.tolist() == [min(ref_h.working_set())] * len(keys)


@pytest.mark.parametrize("plane", PLANES)
@pytest.mark.parametrize("algo", ALGORITHMS)
def test_replica_diff_matches_reference(algo, plane):
    ref_h, _ = _pair(algo, "churned")
    store = RefStore(ref_h)
    churn(ref_h, 6, seed=12)
    store.sync()
    old_img, new_img = store.previous_image(), store.image()
    got = port.engine_diff(KEYS, _port_image(old_img), _port_image(new_img), k=3,
                           device="cpu")
    want = ref.engine_diff(KEYS, old_img, new_img, k=3, plane=plane)
    assert got.old.shape == got.new.shape == (len(KEYS), 3)
    np.testing.assert_array_equal(got.old.numpy(), want.old)
    np.testing.assert_array_equal(got.new.numpy(), want.new)
    np.testing.assert_array_equal(got.moved.numpy(), want.moved)
    assert got.num_moved == want.num_moved > 0


def _walk_inputs(image, seed: int):
    rng = np.random.default_rng(seed)
    chain = rng.integers(0, 2**32, size=len(KEYS), dtype=np.uint32)
    probe = rng.integers(0, 9, size=len(KEYS)).astype(np.int32)
    pending = rng.random(len(KEYS)) < 0.6
    load = rng.integers(0, 4, size=ref.bounded_load_len(image)).astype(np.int32)
    return chain, probe, pending, load


@pytest.mark.parametrize("plane", PLANES)
@pytest.mark.parametrize("cap", [1, 3])
@pytest.mark.parametrize("algo", ALGORITHMS)
def test_chain_walk_matches_reference(algo, cap, plane):
    ref_h, _ = _pair(algo, "churned")
    img = ref_h.device_image()
    chain, probe, pending, load = _walk_inputs(img, seed=cap)
    got = port.engine_chain_walk(chain, probe, pending, _port_image(img), load, cap,
                                 device="cpu")
    want = ref.engine_chain_walk(chain, probe, pending, img, load, cap, plane=plane)
    assert got[1].dtype == np.uint32
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # a lane that is not pending keeps its chain and probe
    np.testing.assert_array_equal(got[1][~pending], chain[~pending])
    np.testing.assert_array_equal(got[2][~pending], probe[~pending])


@pytest.mark.parametrize("plane", PLANES)
@pytest.mark.parametrize("algo", ALGORITHMS)
def test_bounded_assign_matches_reference_and_host(algo, plane):
    ref_h, port_h = _pair(algo, "churned")
    img = ref_h.device_image()
    keys = KEYS[:256]
    cap = max(1, math.ceil(1.25 * len(keys) / ref_h.working))
    load0 = np.zeros(ref.bounded_load_len(img), np.int32)
    got, got_load = port.bounded_assign(keys, _port_image(img), load0, cap, device="cpu")
    want, want_load = ref.bounded_assign(keys, img, load0, cap, plane=plane)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_load, want_load)
    host, host_load = bounded_assign_ref(port_h, keys, load0, cap)
    np.testing.assert_array_equal(host, got)
    np.testing.assert_array_equal(host_load, got_load)
    assert got_load.max() <= cap and (load0 == 0).all()


def test_infeasible_assign_raises_on_both_planes():
    ref_h, port_h = _pair("memento", "fresh")
    img = ref_h.device_image()
    keys, cap = KEYS[:40], 1  # 40 keys, 16 buckets × cap 1
    load0 = np.zeros(ref.bounded_load_len(img), np.int32)
    with pytest.raises(RuntimeError, match="no bucket below capacity"):
        port.bounded_assign(keys, _port_image(img), load0, cap, device="cpu")
    with pytest.raises(RuntimeError, match="no bucket below capacity"):
        bounded_assign_ref(port_h, keys, load0, cap)


@pytest.mark.parametrize("seed", range(4))
def test_accept_in_index_order_and_probe_bound_match_reference(seed):
    rng = np.random.default_rng(seed)
    m = 500
    b = rng.integers(0, 30, size=m).astype(np.int32)
    pending = rng.random(m) < 0.7
    load = rng.integers(0, 5, size=30).astype(np.int32)
    for cap in (1, 3, 6):
        np.testing.assert_array_equal(accept_in_index_order(b, pending, load, cap),
                                      ref_accept(b, pending, load, cap))
    assert accept_in_index_order(b, np.zeros(m, bool), load, 3).shape == (0,)
    for n in (0, 1, 128, 10**6):
        assert walk_probe_bound(n) == ref_walk_probe_bound(n)


def _bounded_events(bl, rng, lifo: bool):
    """One churn script of assignments, releases, removals and joins."""
    bl.assign_batch(rng.integers(0, 2**32, size=120, dtype=np.uint64))
    yield
    for key in rng.integers(0, 2**32, size=10, dtype=np.uint64):
        bl.assign(int(key))
    bl.release(int(sorted(bl.assignment)[3]))
    yield
    bl.remove(bl.size - 1 if lifo else sorted(bl.working_set())[2])
    yield
    bl.add()
    bl.assign_batch(rng.integers(0, 2**32, size=40, dtype=np.uint64))
    yield


@pytest.mark.parametrize("algo", ALGORITHMS)
def test_bounded_load_rides_deltas_through_the_store(algo):
    """The same events on the reference's and the port's overlay: equal
    assignments, loads, sync modes and image fingerprints, and the load
    words on the device equal the host's."""
    ref_bl = RefBoundedLoad(ref_make_hash(algo, 24, capacity=96, variant="32"), c=1.5)
    bl = BoundedLoad(make_hash(algo, 24, capacity=96, variant="32"), c=1.5)
    ref_store, store = RefStore(ref_bl), DeviceImageStore(bl, device="cpu")
    assert image_fingerprint(store.image()) == ref_fingerprint(ref_store.image())
    lifo = lifo_only(algo)
    steps = zip(_bounded_events(ref_bl, np.random.default_rng(1), lifo),
                _bounded_events(bl, np.random.default_rng(1), lifo))
    for _ in steps:
        assert bl.assignment == ref_bl.assignment
        np.testing.assert_array_equal(bl.load, ref_bl.load)
        got, want = store.sync(), ref_store.sync()
        assert (got.mode, got.events, got.words) == (want.mode, want.events, want.words)
        assert image_fingerprint(store.image()) == ref_fingerprint(ref_store.image())
        dev_load = store.image().arrays["load"].numpy()
        np.testing.assert_array_equal(dev_load[: bl.load.shape[0]], bl.load)
        np.testing.assert_array_equal(store.lookup(KEYS).numpy(),
                                      [bl.lookup(int(k)) for k in KEYS])
    cap = bl.capacity(incoming=0) + 1
    got = store.lookup(KEYS, k=2, load=store.image().arrays["load"], cap=cap)
    want = ref_store.lookup(KEYS, k=2, load=ref_store.image().arrays["load"], cap=cap,
                            plane="jnp")
    np.testing.assert_array_equal(got.numpy(), want)
    assert bl.peak_to_mean() == ref_bl.peak_to_mean()


def test_bounded_load_memento_and_bad_c():
    bl = BoundedLoadMemento(10, c=1.25, variant="32")
    for key in KEYS[:200]:
        bl.assign(int(key))
    assert bl.m is bl.ch and bl.name == "memento-bounded"
    assert bl.load.max() <= bl.capacity(incoming=0)
    before = dict(bl.assignment)
    victim = sorted(bl.working_set())[0]
    moves = bl.remove(victim)
    assert set(moves) == {k for k, b in before.items() if b == victim}
    with pytest.raises(ValueError):
        BoundedLoadMemento(4, c=1.0)


def test_bounded_from_state_carries_the_reference_across():
    ref_bl = RefBoundedLoad(ref_make_hash("memento", 30, variant="32"), c=1.25)
    ref_bl.assign_batch(KEYS[:150].astype(np.uint64))
    ref_bl.remove(sorted(ref_bl.working_set())[4])
    m = ref_bl.ch
    bl = bounded_from_state(memento_from_state(m.n, m.l, m.R, epoch=m.epoch), ref_bl.c,
                            ref_bl.load, ref_bl.assignment, ref_bl.epoch)
    assert image_fingerprint(bl.device_image()) == ref_fingerprint(ref_bl.device_image())
    assert bl.assign(int(KEYS[200])) == ref_bl.assign(int(KEYS[200]))
    np.testing.assert_array_equal(bl.assign_batch(KEYS[201:260].astype(np.uint64)),
                                  ref_bl.assign_batch(KEYS[201:260].astype(np.uint64)))
    assert bl.assignment == ref_bl.assignment
    np.testing.assert_array_equal(bl.load, ref_bl.load)


@pytest.mark.parametrize("algo", ALGORITHMS)
def test_wrappers_check_the_new_operands(algo):
    img = _port_image(state(algo, 64, 10, seed=2).device_image())
    tables, scalars = port.image_operands(img)
    keys = port.key_tensor(KEYS, "cpu")
    need = port.bounded_load_len(img)
    load = torch.zeros(need, dtype=torch.int32)
    for bad in (load[:-1], load.to(torch.int64), load.reshape(-1, 1), load[::2]):
        with pytest.raises(ValueError):
            port.kernel_replica(algo, keys, 2, tables, scalars, bad, 3)
        with pytest.raises(ValueError):
            port.kernel_walk(algo, keys, torch.zeros_like(keys),
                             torch.ones(len(keys), dtype=torch.bool), tables, scalars, bad, 3)
    with pytest.raises(ValueError):
        port.kernel_replica(algo, keys, 0, tables, scalars)
    with pytest.raises(ValueError):
        port.kernel_replica(algo, keys, 2, tables, scalars, load, None)
    with pytest.raises(ValueError):
        port.kernel_walk(algo, keys, torch.zeros(3, dtype=torch.int32),
                         torch.ones(len(keys), dtype=torch.bool), tables, scalars, load, 3)
    with pytest.raises(ValueError):
        port.kernel_walk(algo, keys, torch.zeros_like(keys),
                         torch.ones(len(keys), dtype=torch.int32), tables, scalars, load, 3)
    with pytest.raises(ValueError):
        port.engine_lookup(KEYS, img, k=2, load=load, device="cpu")  # no cap
    assert port.kernel_replica(algo, keys[:0], 3, tables, scalars).shape == (0, 3)
    o, n, moved = port.kernel_replica_diff(algo, keys, 2, (tables, scalars),
                                           (tables, scalars))
    assert torch.equal(o, n) and not moved.any()


def _dx_at_ratio(ratio: int, a: int = 6400):
    """The reference's DxHash of capacity ``a`` with all but a / ratio
    buckets removed, and the port's after the same removals."""
    ref_h = ref_make_hash("dx", a, capacity=a, variant="32")
    port_h = make_hash("dx", a, capacity=a, variant="32")
    for b in np.random.default_rng(ratio).permutation(a)[: a - a // ratio].tolist():
        ref_h.remove(int(b))
        port_h.remove(int(b))
    return ref_h, port_h


@pytest.mark.parametrize("bounded", [False, True])
@pytest.mark.parametrize("ratio", [8, 40, 128])
def test_dx_replica_sets_match_reference_where_the_card_takes_lane_groups(ratio, bounded):
    """DxHash k = 3 sets, and bounded k = 2 sets, at ⌈a/w⌉ = 8, 40 and 128
    (a = 6400): the states on which ``dx_replica`` runs a key's walk on 2, 8
    and 32 lanes, equal to the reference engine and the host."""
    ref_h, port_h = _dx_at_ratio(ratio)
    img = ref_h.device_image()
    if bounded:
        load, cap = _bounded_load(ref_h, img)
        got = port.engine_lookup(KEYS, _port_image(img), k=2, load=load, cap=cap, device="cpu")
        want = np.asarray(ref.engine_lookup(KEYS, img, k=2, load=load, cap=cap, plane="jnp"))
        host = port.bounded_replica_sets(port_h, KEYS, 2, load, cap)
        np.testing.assert_array_equal(host, ref.bounded_replica_sets(ref_h, KEYS, 2, load, cap))
    else:
        got = port.engine_lookup(KEYS, _port_image(img), k=3, device="cpu")
        want = np.asarray(ref.engine_lookup(KEYS, img, k=3, plane="jnp"))
        host = replica_sets(port_h, KEYS, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), host)


@pytest.mark.parametrize("old", ["stable", "other capacity"])
@pytest.mark.parametrize("ratio", [8, 40, 128])
def test_dx_replica_diff_matches_reference_where_the_card_takes_lane_groups(ratio, old):
    """DxHash k = 3 diffs into a state at ⌈a/w⌉ = 8, 40 and 128 (a = 6400:
    the states on which ``dx_replica_diff`` runs both epochs' walks on 2, 8
    and 32 lanes a key), from the stable state of that capacity and from a
    churned state of another (a = 4000, ⌈a/w⌉ = 4, whose candidates
    differ): equal to the reference engine's diff and to the host's sets."""
    ref_new, port_new = _dx_at_ratio(ratio)
    if old == "stable":
        ref_old = ref_make_hash("dx", 6400, capacity=6400, variant="32")
        port_old = make_hash("dx", 6400, capacity=6400, variant="32")
    else:
        ref_old, port_old = _dx_at_ratio(4, a=4000)
    imgs = [h.device_image() for h in (ref_old, ref_new)]
    got = port.engine_diff(KEYS, *map(_port_image, imgs), k=3, device="cpu")
    want = ref.engine_diff(KEYS, *imgs, k=3, plane="jnp")
    np.testing.assert_array_equal(got.old.numpy(), want.old)
    np.testing.assert_array_equal(got.new.numpy(), want.new)
    np.testing.assert_array_equal(got.moved.numpy(), want.moved)
    np.testing.assert_array_equal(got.old.numpy(), replica_sets(port_old, KEYS, 3))
    np.testing.assert_array_equal(got.new.numpy(), replica_sets(port_new, KEYS, 3))
    assert 0 < got.num_moved == want.num_moved


def _memento_epochs(pair: str):
    """Two reference Memento states, old and new: one removal inside a
    churned state (n kept), the last bucket removed from an unchurned
    state (n - 1) and a bucket added to one (n + 1)."""
    old, new = (ref_make_hash("memento", 200, variant="32") for _ in range(2))
    if pair == "one removal":
        churn(old, 120, seed=5)
        churn(new, 120, seed=5)
        new.remove(sorted(new.working_set())[3])
    elif pair == "last bucket":
        new.remove(new.n - 1)
    else:
        new.add()
    return old, new


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("pair", ["one removal", "last bucket", "add"])
def test_memento_replica_diff_matches_reference_for_equal_and_changed_n(pair, packed):
    """Memento k = 3 diffs, dense and packed, between epochs of equal n and
    of n - 1 and n + 1 (the pairs on which ``memento_replica_diff`` shares
    jump32 between the epochs or runs one each), equal to the reference."""
    from repro.core import packing as rpk

    old, new = _memento_epochs(pair)
    assert (old.n == new.n) == (pair == "one removal")
    imgs = [h.device_image() for h in (old, new)]
    if packed:
        imgs = [rpk.pack_image(i) for i in imgs]
    ports = [image_from_arrays(i.algo, i.n, {k: np.asarray(v) for k, v in i.arrays.items()},
                               i.scalars, i.epoch, packed=i.packed) for i in imgs]
    got = port.engine_diff(KEYS, *ports, k=3, device="cpu")
    want = ref.engine_diff(KEYS, *imgs, k=3, plane="jnp")
    np.testing.assert_array_equal(got.old.numpy(), want.old)
    np.testing.assert_array_equal(got.new.numpy(), want.new)
    np.testing.assert_array_equal(got.moved.numpy(), want.moved)
    np.testing.assert_array_equal(got.new.numpy(), ref_replica_sets(new, KEYS, 3))
    assert got.num_moved == want.num_moved > 0


def _host_walk(h, chain: int, probe: int, pending: bool, load, cap: int):
    """The host's chain-walk step of one lane."""
    from repro_torch.core.hashing import hash2_32

    b = h.lookup(chain)
    while pending and load[b] >= cap and probe < walk_probe_bound(len(load)):
        probe += 1
        chain = hash2_32(chain, probe)
        b = h.lookup(chain)
    return b, chain, probe


@pytest.mark.parametrize("plane", PLANES)
@pytest.mark.parametrize("ratio", [8, 40, 128])
def test_dx_chain_walk_matches_reference_where_the_card_takes_lane_groups(ratio, plane):
    """DxHash chain-walk steps at ⌈a/w⌉ = 8, 40 and 128 (a = 6400): the
    states on which ``dx_walk`` runs a lane's step on 2, 8 and 32 lanes, at
    a cap that three buckets in four reach, so that pending lanes walk
    several steps; equal to the reference engine and the host walk."""
    ref_h, port_h = _dx_at_ratio(ratio)
    img = ref_h.device_image()
    chain, probe, pending, load = _walk_inputs(img, seed=ratio)
    got = port.engine_chain_walk(chain, probe, pending, _port_image(img), load, 1,
                                 device="cpu")
    want = ref.engine_chain_walk(chain, probe, pending, img, load, 1, plane=plane)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert (got[2] - probe)[pending].max() >= 4
    host = [_host_walk(port_h, int(c), int(p), bool(q), load, 1)
            for c, p, q in zip(chain[:40], probe[:40], pending[:40])]
    assert host == list(zip(*(g[:40].tolist() for g in got)))


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("table", ["dense", "packed", "compact"])
def test_memento_bounded_sets_match_reference_at_a_cap_that_rejects_often(table, k):
    """Memento bounded k = 2 and k = 4 sets on dense, packed and compact
    images at a cap that half the buckets reach, so that the walk rejects
    salt 0 for some keys and later salts for most (the states of the
    card's bounded walk, one loop over the salts with salt 0 apart): equal
    to the reference engine and the host."""
    from repro.core import packing as rpk

    ref_h = state("memento", 300, 150, seed=17)
    img = ref_h.device_image()
    if table == "packed":
        img = rpk.pack_image(img)
    port_img = image_from_arrays(img.algo, img.n, {n: np.asarray(v) for n, v in img.arrays.items()},
                                 img.scalars, img.epoch, packed=img.packed)
    load = np.random.default_rng(k).integers(0, 4, size=ref.bounded_load_len(img)).astype(np.int32)
    kw = {"table": "compact"} if table == "compact" else {}
    got = port.engine_lookup(KEYS, port_img, k=k, load=load, cap=2, device="cpu", **kw)
    want = np.asarray(ref.engine_lookup(KEYS, img, k=k, load=load, cap=2,
                                        plane="pallas" if table == "compact" else "jnp", **kw))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), ref.bounded_replica_sets(ref_h, KEYS, k, load, 2))
    assert (load[got.numpy()] < 2).all()


@pytest.mark.parametrize("start", ["probe 0 to 8", "probe 1 to 3 below max_probe"])
def test_memento_chain_walk_of_every_lane_matches_reference(start):
    """Memento chain-walk steps with every lane pending at cap 1, a cap
    that three buckets in four reach, so that lanes walk more steps than
    a round of the card's walk looks up, from probes 0 to 8, or from 1 to
    3 below max_probe, where the steps a round would look up cross the
    bound: equal to the reference engine (jnp plane) and the host walk."""
    ref_h, port_h = _pair("memento", "churned")
    img = ref_h.device_image()
    chain, probe, _, load = _walk_inputs(img, seed=23)
    max_probe = ref_walk_probe_bound(len(load))
    if start != "probe 0 to 8":
        probe = (max_probe - np.random.default_rng(24).integers(1, 4, size=len(KEYS))).astype(
            np.int32)
    pending = np.ones(len(KEYS), bool)
    got = port.engine_chain_walk(chain, probe, pending, _port_image(img), load, 1,
                                 device="cpu")
    want = ref.engine_chain_walk(chain, probe, pending, img, load, 1, plane="jnp")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    steps = got[2] - probe
    if start == "probe 0 to 8":
        assert steps.max() >= 5
    else:
        assert (got[2] == max_probe).any() and (steps < max_probe - probe).any()
    host = [_host_walk(port_h, int(c), int(p), True, load, 1)
            for c, p in zip(chain[:40], probe[:40])]
    assert host == list(zip(*(g[:40].tolist() for g in got)))


@pytest.mark.parametrize("start", ["probe 0 to 8", "probe 1 to 3 below max_probe"])
def test_jump_chain_walk_of_every_lane_matches_reference(start):
    """JumpHash chain-walk steps with every lane pending at cap 1, a cap
    that three buckets in four reach, so that lanes walk several steps (the
    rounds of ``jump_walk``'s queue), from probes 0 to 8, or from 1 to 3
    below max_probe, where lanes stop at the bound: equal to the reference
    engine (jnp plane) and the host walk."""
    ref_h, port_h = _pair("jump", "churned")
    img = ref_h.device_image()
    chain, probe, _, load = _walk_inputs(img, seed=25)
    max_probe = ref_walk_probe_bound(len(load))
    if start != "probe 0 to 8":
        probe = (max_probe - np.random.default_rng(26).integers(1, 4, size=len(KEYS))).astype(
            np.int32)
    pending = np.ones(len(KEYS), bool)
    got = port.engine_chain_walk(chain, probe, pending, _port_image(img), load, 1,
                                 device="cpu")
    want = ref.engine_chain_walk(chain, probe, pending, img, load, 1, plane="jnp")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    steps = got[2] - probe
    if start == "probe 0 to 8":
        assert steps.max() >= 5
    else:
        assert (got[2] == max_probe).any() and (steps < max_probe - probe).any()
    host = [_host_walk(port_h, int(c), int(p), True, load, 1)
            for c, p in zip(chain[:40], probe[:40])]
    assert host == list(zip(*(g[:40].tolist() for g in got)))


@pytest.mark.parametrize("working", [1, 2, 3])
def test_anchor_replica_sets_of_few_buckets_match_reference(working):
    """AnchorHash k = 3 sets with 1, 2 or 3 of 64 buckets working, where
    salts collide on the same buckets and, below 3, every row runs out of
    salts and keeps the key's own bucket in its open slots: equal to the
    reference engine (jnp plane), and at 3 to the reference's replica
    sets and the host."""
    ref_h = state("anchor", 16, 16 - working, seed=3)
    port_h = make_hash("anchor", 16, capacity=64, variant="32")
    churn(port_h, 16 - working, seed=3)
    assert port_h.working_set() == ref_h.working_set()
    img = ref_h.device_image()
    got = port.replica_lookup(KEYS, _port_image(img), 3, device="cpu")
    want = np.asarray(ref.replica_lookup(KEYS, img, 3, plane="jnp"))
    np.testing.assert_array_equal(got.numpy(), want)
    first = port.engine_lookup(KEYS, _port_image(img), device="cpu").numpy()
    np.testing.assert_array_equal(got.numpy()[:, 0], first)
    if working < 3:
        np.testing.assert_array_equal(got.numpy()[:, working:],
                                      np.repeat(first[:, None], 3 - working, axis=1))
    else:
        np.testing.assert_array_equal(got.numpy(), ref_replica_sets(ref_h, KEYS, 3))
        np.testing.assert_array_equal(got.numpy(), replica_sets(port_h, KEYS, 3))
