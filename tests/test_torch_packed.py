"""The port's packed and compact layouts against the reference, exactly, on
the CPU: packing primitives (byte-equal arrays), lookups of every mode on
packed images (the reference engine on its jnp plane, and on its Pallas
plane in interpret mode where ``tests/test_packed.py`` uses it), the
compact store after every churn event, packed epoch deltas, the compact
table, the public ``ops`` wrappers and the router with compact images."""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conformance import ALGORITHMS, churn, churn_mixed, state
from repro.core import DeviceImageStore as RefStore
from repro.core import MementoTables as RefTables
from repro.core import image_fingerprint as ref_fingerprint
from repro.core import make_hash as ref_make_hash
from repro.core import packing as rpk
from repro.core.image_store import delta_fits as ref_delta_fits
from repro.core.protocol import ImageDelta as RefDelta
from repro.kernels import engine as ref
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro.kernels.delta_apply import scatter_update as ref_scatter
from repro.serve.router import SessionRouter as RefRouter
from repro_torch.convert import image_from_arrays, memento_from_state
from repro_torch.core import packing as pk
from repro_torch.core import protocol as pp
from repro_torch.core.image_store import DeviceImageStore, delta_fits
from repro_torch.core.tables import MementoTables, tables_from_state
from repro_torch.kernels import engine as port
from repro_torch.kernels import ops, ref as port_ref
from repro_torch.kernels.delta_apply import scatter_update
from repro_torch.serve.router import SessionRouter

KEYS = np.random.default_rng(99).integers(0, 2**32, size=700, dtype=np.uint32)
PLANES = ["jnp", "pallas"]


def _port_image(img):
    """A reference image (dense or packed) as a port image, dtypes kept."""
    return image_from_arrays(img.algo, img.n, {k: np.asarray(v) for k, v in img.arrays.items()},
                             img.scalars, img.epoch, packed=img.packed)


def _same_arrays(port_arrays: dict, ref_arrays: dict) -> None:
    """Same names, dtype widths and bytes (uint32 words as int32 bits)."""
    assert sorted(port_arrays) == sorted(ref_arrays)
    for name, want in ref_arrays.items():
        got = port_arrays[name]
        got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
        want = np.asarray(want)
        assert got.dtype.itemsize == want.dtype.itemsize, name
        assert got.tobytes() == want.tobytes(), name


def _packed_pair(algo: str, n0: int, removals: int, seed: int, **kw):
    """A host state, its reference packed image and the port's packing of
    the same dense image."""
    h = state(algo, n0, removals, seed=seed)
    img = h.device_image(**kw)
    return h, rpk.pack_image(img), pk.pack_image(_port_image(img))


# ---------------------------------------------------------------------------
# Packing primitives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("value", [0, 100, 127, 128, 32767, 32768, 2**31 - 1])
def test_narrow_dtype_thresholds(value):
    assert pk.narrow_dtype(value) == rpk.narrow_dtype(value)


@pytest.mark.parametrize("removed", [0, 3, 60, 255])
@pytest.mark.parametrize("dtype", [np.int16, np.int32])
def test_build_slots_matches_reference(removed, dtype):
    repl = np.full(512, -1, np.int32)
    rng = np.random.default_rng(removed)
    idx = rng.permutation(512)[:removed]
    repl[idx] = rng.integers(0, 512, size=removed)
    for nslots in (None, 1024):
        got = pk.build_slots(repl, nslots=nslots, dtype=dtype)
        want = rpk.build_slots(repl, nslots=nslots, dtype=dtype)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    assert pk._slot_count(removed, headroom=2) == rpk._slot_count(removed, headroom=2)


def test_build_slots_rejects_what_the_reference_rejects():
    repl = np.zeros(300, np.int32)
    for nslots in (100, 256):  # not a power of two; load factor above 0.5
        with pytest.raises(ValueError):
            rpk.build_slots(repl, nslots=nslots)
        with pytest.raises(ValueError):
            pk.build_slots(repl, nslots=nslots)


@pytest.mark.parametrize("removals", [0, 30])
@pytest.mark.parametrize("algo", ALGORITHMS)
def test_pack_image_matches_reference(algo, removals):
    _, want, got = _packed_pair(algo, 96, removals, seed=1)
    assert got.packed and want.packed
    _same_arrays(got.arrays, want.arrays)
    assert (got.n, got.epoch, got.scalars) == (want.n, want.epoch, want.scalars)
    assert pp.image_fingerprint(got) == ref_fingerprint(want)
    assert pk.image_table_bytes(got) == rpk.image_table_bytes(want)
    assert pk.image_table_names(got) == rpk.image_table_names(want)
    if algo == "memento":
        assert pk.host_arrays(got)["state"].dtype == np.uint32


@pytest.mark.parametrize("algo", ALGORITHMS)
def test_unpack_image_round_trips(algo):
    h = state(algo, 96, 30, seed=1)
    img = h.device_image()
    back = pk.unpack_image(pk.pack_image(_port_image(img)))
    want = rpk.unpack_image(rpk.pack_image(img))
    assert not back.packed
    _same_arrays(back.arrays, want.arrays)
    for name, arr in img.arrays.items():
        a, b = np.asarray(arr), back.arrays[name].numpy()
        m = min(len(a), len(b))
        assert a[:m].tobytes() == b[:m].tobytes()


def test_unpack_rejects_an_inconsistent_bitmap():
    _, _, got = _packed_pair("memento", 96, 10, seed=2)
    state_words = got.arrays["state"].clone()
    state_words[0] = 0  # buckets 0..31 marked removed, no slot holds them
    bad = pp.DeviceImage("memento", got.n, dict(got.arrays, state=state_words),
                         epoch=got.epoch, packed=True)
    with pytest.raises(ValueError, match="inconsistent"):
        pk.unpack_image(bad)


# ---------------------------------------------------------------------------
# Every mode on packed images, against the reference engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("plane", PLANES)
@pytest.mark.parametrize("algo", ALGORITHMS)
def test_packed_lookup_matches_reference_and_host(algo, plane):
    h, want_img, img = _packed_pair(algo, 96, 30, seed=4)
    got = port.engine_lookup(KEYS, img, device="cpu")
    want = np.asarray(ref.engine_lookup(KEYS, want_img, plane=plane))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), ref_ref.lookup_host(KEYS, h))


@pytest.mark.parametrize("plane", PLANES)
@pytest.mark.parametrize("algo", ALGORITHMS)
def test_packed_replica_sets_match_reference(algo, plane):
    _, want_img, img = _packed_pair(algo, 64, 16, seed=5)
    got = port.engine_lookup(KEYS, img, k=3, device="cpu")
    want = np.asarray(ref.engine_lookup(KEYS, want_img, k=3, plane=plane))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("algo", ["memento", "anchor"])
def test_packed_bounded_replica_matches_reference(algo):
    h, want_img, img = _packed_pair(algo, 96, 20, seed=6)
    cap = max(2, -(-len(KEYS) * 5 // (4 * h.working)))
    assert port.bounded_load_len(img) == ref.bounded_load_len(want_img)
    load = np.zeros(port.bounded_load_len(img), np.int32)
    load[sorted(h.working_set())[: h.working // 4]] = cap
    got = port.engine_lookup(KEYS, img, k=2, load=load, cap=cap)
    want = np.asarray(ref.engine_lookup(KEYS, want_img, k=2, load=load, cap=cap,
                                        plane="pallas"))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("algo", ALGORITHMS)
def test_packed_epoch_diff_matches_reference(algo, k):
    h = state(algo, 96, 10, seed=7)
    old = h.device_image(capacity=512)
    churn_mixed(h, 15, seed=8)
    new = h.device_image(capacity=512)
    old_p, new_p = rpk.pack_image(old), rpk.pack_image(new)
    got = port.engine_diff(KEYS, _port_image(old_p), _port_image(new_p), k=k, device="cpu")
    want = ref.engine_diff(KEYS, old_p, new_p, k=k, plane="jnp")
    np.testing.assert_array_equal(got.old.numpy(), want.old)
    np.testing.assert_array_equal(got.new.numpy(), want.new)
    np.testing.assert_array_equal(got.moved.numpy(), want.moved)


@pytest.mark.parametrize("algo", ALGORITHMS)
def test_packed_walk_and_bounded_assign_match_reference(algo):
    h, want_img, img = _packed_pair(algo, 200, 60, seed=9)
    rng = np.random.default_rng(10)
    load = rng.integers(0, 4, size=port.bounded_load_len(img)).astype(np.int32)
    probe = rng.integers(0, 6, size=len(KEYS)).astype(np.int32)
    pending = rng.random(len(KEYS)) < 0.6
    got = port.engine_chain_walk(KEYS, probe, pending, img, load, 2, device="cpu")
    want = ref.engine_chain_walk(KEYS, probe, pending, want_img, load, 2, plane="jnp")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    cap = -(-5 * len(KEYS) // (4 * h.working))
    load0 = np.zeros(port.bounded_load_len(img), np.int32)
    got = port.bounded_assign(KEYS, img, load0, cap, device="cpu")
    want = ref.bounded_assign(KEYS, want_img, load0, cap, plane="jnp")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("case", ["every bucket at the cap", "probe one below max_probe",
                                  "all pending", "none pending"])
def test_packed_walk_edges_match_reference(case):
    """A packed Memento walk step at its edges against the reference: every
    pending lane walking to max_probe, lanes one step from it, and every or
    no lane pending.  The bitmap is cut to its one word that n = 8 needs,
    so the load has 32 words and max_probe is 64 * 32 + 64."""
    from repro.core.bounded import walk_probe_bound as ref_walk_probe_bound

    _, packed, _ = _packed_pair("memento", 8, 2, seed=11)
    cut = dataclasses.replace(packed, arrays={**packed.arrays,
                                              "state": packed.arrays["state"][:1]})
    img = _port_image(cut)
    max_probe = ref_walk_probe_bound(port.bounded_load_len(img))
    assert port.bounded_load_len(img) == 32 and max_probe == 64 * 32 + 64
    rng = np.random.default_rng(12)
    keys = KEYS[:64] if case == "every bucket at the cap" else KEYS
    load = rng.integers(0, 4, size=32).astype(np.int32)
    probe = rng.integers(0, 9, size=len(keys)).astype(np.int32)
    pending = rng.random(len(keys)) < 0.6
    if case == "every bucket at the cap":
        load[:] = 2
    elif case == "probe one below max_probe":
        probe[:] = max_probe - 1
    else:
        pending[:] = case == "all pending"
    got = port.engine_chain_walk(keys, probe, pending, img, load, 2, device="cpu")
    want = ref.engine_chain_walk(keys, probe, pending, cut, load, 2, plane="jnp")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    if case == "every bucket at the cap":
        assert (got[2][pending] == max_probe).all()
    np.testing.assert_array_equal(got[2][~pending], probe[~pending])


def test_packed_and_dense_diffs_refuse_mixed_layouts():
    h = state("memento", 64, 8, seed=9)
    dense = _port_image(h.device_image())
    packed = pk.pack_image(dense)
    with pytest.raises(ValueError, match="one layout"):
        port.engine_diff(KEYS, dense, packed)
    with pytest.raises(ValueError, match="one layout"):
        ref.engine_diff(KEYS, h.device_image(), rpk.pack_image(h.device_image()),
                        plane="pallas")
    with pytest.raises(ValueError, match="cannot serve"):
        port.engine_lookup(KEYS, packed, table="compact")
    with pytest.raises(ValueError, match="cannot read a dense image"):
        port.engine_lookup(KEYS, dense, table="packed")


@pytest.mark.parametrize("algo", ["memento", "anchor"])
def test_hand_built_int8_image_matches_reference(algo):
    """``pack_image`` pads every table to 128 entries, so it never gives
    int8; an image narrowed by hand runs the same lookups."""
    h = state(algo, 100, 40, seed=11) if algo == "memento" else \
        ref_make_hash("anchor", 100, capacity=120, variant="32")
    if algo == "anchor":
        churn(h, 40, seed=11)
    p = rpk.pack_image(h.device_image())
    names = ("slot_b", "slot_c") if algo == "memento" else ("A", "K")
    arrays = {k: (np.asarray(v).astype(np.int8) if k in names else np.asarray(v))
              for k, v in p.arrays.items()}
    want_img = type(p)(algo=algo, n=p.n, arrays=arrays, scalars=dict(p.scalars),
                       epoch=p.epoch, packed=True)
    img = _port_image(want_img)
    assert img.arrays[names[0]].dtype == torch.int8
    for k in (1, 3):
        got = port.engine_lookup(KEYS, img, k=k)
        want = np.asarray(ref.engine_lookup(KEYS, want_img, k=k, plane="jnp"))
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(port.engine_lookup(KEYS, img).numpy(),
                                  ref_ref.lookup_host(KEYS, h))


def test_plain_work_counts_probes():
    """The packed reader counts the bitmap words and the slots it reads;
    a stable image reads one word a table read and probes nothing, and
    Alg. 4's repeated read of repl(d), which the kernel does not make, is
    not counted."""
    h = state("memento", 300, 0, seed=0)
    img = pk.pack_image(_port_image(h.device_image()))
    tables, scalars = port.image_operands(img)
    work: dict = {}
    port.lookup_plain("memento", port.key_tensor(KEYS, "cpu"), tables, scalars, work,
                      table="packed")
    assert work["bit"] == len(KEYS) and work.get("slot", 0) == 0
    churn(h, 200, seed=1)
    img = pk.pack_image(_port_image(h.device_image()))
    work = {}
    port.lookup_plain("memento", port.key_tensor(KEYS, "cpu"), *port.image_operands(img),
                      work, table="packed")
    assert work["bit"] == len(KEYS) + work["outer"] + work.get("read", 0)
    assert work["slot"] >= work["start"] > 0


# ---------------------------------------------------------------------------
# The compact store: packed epoch deltas
# ---------------------------------------------------------------------------

class _CompactStores:
    """Both compact stores over one ``churn_mixed`` sequence, compared
    after every synced event."""

    def __init__(self, algo: str, n0: int, *, mode: str = "sync", capacity=None):
        cap = capacity or 4 * n0
        self.port_h = pp.make_hash(algo, n0, capacity=cap, variant="32")
        self.ref_h = ref_make_hash(algo, n0, capacity=cap, variant="32")
        self.port = DeviceImageStore(self.port_h, device="cpu", compact=True)
        self.ref = RefStore(self.ref_h, compact=True)
        self.mode = mode
        self.stats: list[str] = []
        self.check()

    @property
    def working(self):
        return self.ref_h.working

    @property
    def size(self):
        return self.ref_h.size

    @property
    def name(self):
        return self.ref_h.name

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
        if self.mode == "sync":
            got, want = self.port.sync(), self.ref.sync()
        else:
            got, want = self.port.sync_async().stats, self.ref.sync_async().stats
        assert (got.mode, got.events, got.words, got.epoch) == \
            (want.mode, want.events, want.words, want.epoch)
        self.stats.append(got.mode)
        self.check()

    def check(self):
        self.port.flush()
        self.ref.flush()
        p, r = self.port.image(), self.ref.image()
        assert p.packed and r.packed
        assert (p.n, p.epoch, p.scalars) == (r.n, r.epoch, r.scalars)
        _same_arrays(p.arrays, r.arrays)
        _same_arrays(self.port._mirror, self.ref._mirror)
        assert pp.image_fingerprint(p) == ref_fingerprint(r)
        assert self.port.capacity == self.ref.capacity
        assert self.port.totals.__dict__ == self.ref.totals.__dict__


@pytest.mark.parametrize("mode", ["sync", "async"])
@pytest.mark.parametrize("algo", ALGORITHMS)
def test_compact_store_tracks_the_reference_store(algo, mode):
    s = _CompactStores(algo, 64, mode=mode)
    churn_mixed(s, 40, seed=20, p_remove=0.7)
    assert "delta" in s.stats  # churn rode the packed delta path
    np.testing.assert_array_equal(s.port.lookup(KEYS).numpy(),
                                  ref_ref.lookup_host(KEYS, s.port_h))
    np.testing.assert_array_equal(s.port.lookup(KEYS, k=2).numpy(),
                                  np.asarray(s.ref.lookup(KEYS, k=2)))
    got, want = s.port.migration_diff(KEYS), s.ref.migration_diff(KEYS)
    np.testing.assert_array_equal(got.old.numpy(), want.old)
    np.testing.assert_array_equal(got.new.numpy(), want.new)
    np.testing.assert_array_equal(got.moved.numpy(), want.moved)


def test_compact_store_remove_then_restore_uses_tombstones():
    s = _CompactStores("memento", 128, capacity=512)
    for b in sorted(s.working_set())[:6]:
        s.remove(b)
    for _ in range(6):  # restores set bitmap bits and leave tombstones
        s.add()
    assert s.stats == ["delta"] * 12
    assert (s.port._mirror["slot_b"] == pk.TOMBSTONE).sum() > 0
    np.testing.assert_array_equal(s.port.lookup(KEYS).numpy(),
                                  ref_ref.lookup_host(KEYS, s.port_h))
    # a removal after the restores probes past the tombstones
    victim = sorted(s.working_set())[3]
    s.remove(victim)
    np.testing.assert_array_equal(s.port.lookup(KEYS).numpy(),
                                  ref_ref.lookup_host(KEYS, s.port_h))


def test_compact_store_slot_overflow_falls_back_to_snapshot():
    s = _CompactStores("memento", 512, capacity=512)
    rng = np.random.default_rng(0)
    for _ in range(400):
        ws = sorted(s.port_h.working_set())
        b = ws[int(rng.integers(len(ws)))]
        s.port_h.remove(b)
        s.ref_h.remove(b)
    got, want = s.port.sync(), s.ref.sync()
    assert got.mode == want.mode == "snapshot" and got.words == want.words
    s.check()
    np.testing.assert_array_equal(s.port.lookup(KEYS).numpy(),
                                  ref_ref.lookup_host(KEYS, s.port_h))


def test_compact_store_snapshots_when_its_slots_fill():
    """One event at a time: the 128-slot table takes deltas until live
    entries and tombstones pass half of it, then the store repacks."""
    s = _CompactStores("memento", 200)
    churn_mixed(s, 120, seed=2, p_remove=0.8)
    assert "snapshot" in s.stats and "delta" in s.stats


@pytest.mark.parametrize("algo", ALGORITHMS)
def test_packed_delta_updates_match_reference(algo):
    h = state(algo, 96, 10, seed=31)
    want_img = rpk.pack_image(h.device_image(capacity=384))
    img = _port_image(want_img)
    ref_mirror = {k: np.array(v) for k, v in want_img.arrays.items()}
    mirror = pk.host_arrays(img)
    base = h.epoch
    churn_mixed(h, 12, seed=32, p_remove=0.6)
    delta = h.device_delta(base)
    port_delta = pp.ImageDelta(delta.algo, delta.base_epoch, delta.epoch, delta.n,
                               dict(delta.updates), dict(delta.scalars))
    got = pk.packed_delta_updates(mirror, port_delta)
    want = rpk.packed_delta_updates(ref_mirror, delta)
    assert (got is None) == (want is None) and got is not None
    _same_arrays({k: v[0] for k, v in got.items()}, {k: v[0] for k, v in want.items()})
    _same_arrays({k: v[1] for k, v in got.items()}, {k: v[1] for k, v in want.items()})
    _same_arrays(mirror, ref_mirror)


def test_packed_delta_updates_return_none_where_the_reference_does():
    h = state("memento", 96, 5, seed=31)
    want_img = rpk.pack_image(h.device_image())
    mirror = pk.host_arrays(_port_image(want_img))
    beyond = 32 * len(mirror["state"])  # past the bitmap
    update = {"repl": (np.array([beyond]), np.array([0]))}
    assert pk.packed_delta_updates(mirror, pp.ImageDelta(
        "memento", 0, 1, beyond + 1, update)) is None
    assert rpk.packed_delta_updates({k: np.array(v) for k, v in want_img.arrays.items()},
                                    RefDelta("memento", 0, 1, beyond + 1, update)) is None


@pytest.mark.parametrize("n", [100, 130, 4000])
def test_delta_fits_compact_rule_matches_reference(n):
    delta = RefDelta("memento", 0, 1, n, {})
    port_delta = pp.ImageDelta("memento", 0, 1, n, {})
    for caps in ({"state": 4}, {"state": 128}, {"state": 128, "load": 200}, {}):
        for compact in (False, True):
            assert delta_fits(caps, port_delta, compact=compact) == \
                ref_delta_fits(caps, delta, compact=compact)


@pytest.mark.parametrize("dtype", [np.int16, np.int8])
def test_narrow_scatter_matches_reference(dtype):
    table = np.random.default_rng(3).integers(-2, 100, size=256).astype(dtype)
    idx = np.asarray([3, 200, 3, 17], np.int32)
    vals = np.asarray([-2, 99, -1, 42], np.int32)
    got = scatter_update(torch.from_numpy(table.copy()), idx, vals)
    want = np.asarray(ref_scatter(table, idx, vals, plane="jnp"))
    assert got.dtype == torch.from_numpy(table).dtype
    assert got.numpy().tobytes() == want.tobytes()


# ---------------------------------------------------------------------------
# The compact table, the ops wrappers, the ref oracles, the router
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("removals", [0, 120, 270])
def test_compact_lookup_matches_reference(removals):
    h = state("memento", 300, removals, seed=12)
    repl = np.asarray(h.device_image().arrays["repl"])
    slot_b, slot_c = port.build_compact_table(torch.from_numpy(repl))
    want_b, want_c = ref.build_compact_table(repl)
    assert slot_b.numpy().tobytes() == np.asarray(want_b).tobytes()
    assert slot_c.numpy().tobytes() == np.asarray(want_c).tobytes()
    got = port.compact_lookup(port.key_tensor(KEYS, "cpu"), slot_b, slot_c, h.n)
    want = np.asarray(ref.compact_lookup(KEYS, want_b, want_c, h.n))
    np.testing.assert_array_equal(got.numpy(), want)
    for table in ("compact", "dense", "jnp"):
        got = ops.memento_lookup(KEYS, repl, h.n, table=table, device="cpu")
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(ref_ops.memento_lookup(KEYS, repl, h.n, table=table)))
    img = _port_image(h.device_image())
    np.testing.assert_array_equal(port.engine_lookup(KEYS, img, table="compact").numpy(),
                                  ref_ref.lookup_host(KEYS, h))


def test_compact_tables_serve_only_the_lookup():
    """Compact tables serve lookup mode, k-replica sets included (equal to
    the reference's Pallas plane); diffs, walks and unknown tables raise,
    as in the reference."""
    h = state("memento", 100, 30, seed=13)
    ref_img = h.device_image()
    img = _port_image(ref_img)
    np.testing.assert_array_equal(
        port.engine_lookup(KEYS, img, k=2, table="compact").numpy(),
        np.asarray(ref.engine_lookup(KEYS, ref_img, k=2, table="compact", plane="pallas")))
    with pytest.raises(ValueError, match="lookup mode only"):
        port.EngineOp("memento", diff=True, table="compact")
    with pytest.raises(ValueError, match="lookup mode only"):
        port.EngineOp("memento", mode="walk", table="compact")
    tables, scalars = port.image_operands(img, "compact")
    with pytest.raises(ValueError, match="not diffs"):
        port.kernel_diff("memento", port.key_tensor(KEYS, "cpu"), (tables, scalars),
                         (tables, scalars), table="compact")
    with pytest.raises(ValueError, match="unknown table kind"):
        ops.memento_lookup(KEYS, img.arrays["repl"], h.n, table="sparse")
    with pytest.raises(ValueError):
        ops.device_lookup(KEYS, _port_image(state("anchor", 50, 3, seed=1).device_image()),
                          table="compact")


def _churned_and_restored(n: int, seed: int):
    """A Memento state with removals and then restores (the restored
    buckets leave the table again), ``variant="32"``."""
    h = state("memento", n, n // 3, seed=seed)
    for _ in range(n // 10):
        h.add()
    churn(h, n // 20, seed=seed + 1)
    return h


@pytest.mark.parametrize("k,bounded", [(2, False), (3, False), (2, True)])
@pytest.mark.parametrize("seed", [21, 22])
def test_compact_replica_sets_match_reference(seed, k, bounded):
    """k-replica sets over the compact table, unbounded and bounded (c =
    1.25, loads from a bounded assignment of half the keys), equal the
    reference's Pallas plane and the port's dense sets."""
    h = _churned_and_restored(240, seed)
    ref_img = h.device_image()
    img = _port_image(ref_img)
    kw = {}
    if bounded:
        cap = int(np.ceil(1.25 * len(KEYS) / h.working))
        zeros = np.zeros(port.bounded_load_len(img), np.int32)
        _, load = port.bounded_assign(KEYS[: len(KEYS) // 2], img, zeros, cap, device="cpu")
        kw = {"load": load, "cap": cap}
    got = port.engine_lookup(KEYS, img, k=k, table="compact", **kw)
    want = np.asarray(ref.engine_lookup(KEYS, ref_img, k=k, table="compact", plane="pallas",
                                        **kw))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), port.engine_lookup(KEYS, img, k=k, **kw).numpy())
    np.testing.assert_array_equal(port.replica_lookup(KEYS, img, k, table="compact", **kw).numpy(),
                                  want)


CROSS_PAIRS = [(a, b) for a in ALGORITHMS for b in ALGORITHMS if a != b]


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("old_algo,new_algo", CROSS_PAIRS)
def test_cross_algorithm_diff_matches_reference(old_algo, new_algo, k):
    """A diff between images of two algorithms (a migration) equals the
    reference's jnp result: dense -> dense, and dense -> packed."""
    h_old, h_new = state(old_algo, 120, 40, seed=23), state(new_algo, 150, 30, seed=24)
    ref_old, ref_new = h_old.device_image(), h_new.device_image()
    for want_new in (ref_new, rpk.pack_image(ref_new)):
        got = port.engine_diff(KEYS, _port_image(ref_old), _port_image(want_new), k=k,
                               device="cpu")
        want = ref.engine_diff(KEYS, ref_old, want_new, k=k, plane="jnp")
        np.testing.assert_array_equal(got.old.numpy(), want.old)
        np.testing.assert_array_equal(got.new.numpy(), want.new)
        np.testing.assert_array_equal(got.moved.numpy(), want.moved)
        assert got.num_moved == want.num_moved


@pytest.mark.parametrize("compact_images", [False, True])
def test_router_accessors_match_reference(compact_images):
    """``SessionRouter.memento`` (the host state) and ``device_image()``
    (the store's front image) equal the reference's, before and after
    membership changes."""
    port_r = SessionRouter(90, device="cpu", compact_images=compact_images)
    ref_r = RefRouter(90, compact_images=compact_images)
    assert port_r.memento is port_r.ch and ref_r.memento is ref_r.ch
    for step in range(3):
        p, r = port_r.device_image(), ref_r.device_image()
        assert p is port_r.image_store().image()
        assert (p.algo, p.n, p.epoch, p.packed, p.scalars) == (r.algo, r.n, r.epoch,
                                                              bool(r.packed), r.scalars)
        _same_arrays(p.arrays, r.arrays)
        assert sorted(port_r.memento.working_set()) == sorted(ref_r.memento.working_set())
        victim = 7 + 11 * step
        assert port_r.fail_replica(victim) == ref_r.fail_replica(victim)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("algo", ALGORITHMS)
def test_device_lookup_matches_reference_ops(algo, packed):
    h = state(algo, 120, 40, seed=14)
    want_img = h.device_image()
    if packed:
        want_img = rpk.pack_image(want_img)
    img = _port_image(want_img)
    for k in (1, 2):
        got = ops.device_lookup(KEYS, img, k=k, device="cpu")
        want = np.asarray(ref_ops.device_lookup(KEYS, want_img, k=k, plane="jnp"))
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(port_ref.lookup_image_ref(KEYS, img).numpy(),
                                  ref_ref.lookup_host(KEYS, h))


def test_lookup_from_tables_matches_reference():
    ref_h = ref_make_hash("memento", 200, variant="32")
    churn(ref_h, 80, seed=15)
    h = memento_from_state(ref_h.n, ref_h.l, ref_h.R)
    tables, ref_tables = MementoTables(h), RefTables(ref_h)
    np.testing.assert_array_equal(tables.repl, ref_tables.repl)
    for table in ("dense", "compact"):
        got = ops.lookup_from_tables(KEYS, tables, table=table, device="cpu")
        want = np.asarray(ref_ops.lookup_from_tables(KEYS, ref_tables, table=table))
        np.testing.assert_array_equal(got.numpy(), want)
    for m, t in ((h, tables), (ref_h, ref_tables)):
        b = sorted(m.working_set())[5]
        m.remove(b)
        t.on_remove(b)
        t.on_add(m.add())
        t.check()
    np.testing.assert_array_equal(tables.repl, ref_tables.repl)
    repl, n = tables_from_state(h.n, h.R)
    np.testing.assert_array_equal(port_ref.memento_lookup_ref(KEYS, repl, n).numpy(),
                                  ref_ref.memento_lookup_host(KEYS, ref_h))


@pytest.mark.parametrize("algo", [a for a in ALGORITHMS if a not in ("memento", "power")])
def test_ref_oracles_match_reference(algo):
    """The ``*_ref`` oracles the reference exports (Memento's is held in
    ``test_lookup_from_tables_matches_reference``; PowerHash has none)."""
    h = state(algo, 120, 40, seed=16) if algo != "jump" else ref_make_hash("jump", 77,
                                                                          variant="32")
    img = h.device_image()
    a = {k: np.asarray(v) for k, v in img.arrays.items()}
    j = {k: jnp.asarray(v) for k, v in a.items()}
    if algo == "anchor":
        got = port_ref.anchor_lookup_ref(KEYS, a["A"], a["K"], img.n)
        want = ref_ref.anchor_lookup_ref(KEYS, j["A"], j["K"], img.n)
    elif algo == "dx":
        s = img.scalars
        got = port_ref.dx_lookup_ref(KEYS, a["words"], img.n, s["max_probes"], s["fallback"])
        want = ref_ref.dx_lookup_ref(KEYS, j["words"], img.n, s["max_probes"], s["fallback"])
    else:
        got = port_ref.jump32_ref(KEYS, img.n)
        want = ref_ref.jump32_ref(KEYS, img.n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


IDS = np.random.default_rng(51).integers(0, 2**63, size=1500, dtype=np.uint64)


@pytest.mark.parametrize("replicas_k", [1, 3])
@pytest.mark.parametrize("sync_mode", ["block", "overlap"])
def test_router_with_compact_images_matches_reference(sync_mode, replicas_k):
    port_r = SessionRouter(200, device="cpu", compact_images=True, sync_mode=sync_mode,
                           replicas_k=replicas_k)
    ref_r = RefRouter(200, compact_images=True, sync_mode=sync_mode, replicas_k=replicas_k)

    def same():
        np.testing.assert_array_equal(port_r.route_batch(IDS),
                                      np.asarray(ref_r.route_batch(IDS)))

    same()
    assert port_r.image_store().image().packed
    for victim in (3, 150, 199, 77):
        port_r.mark_failed(victim)
        ref_r.mark_failed(victim)
        same()
        assert port_r.fail_replica(victim) == ref_r.fail_replica(victim)
        same()
    for _ in range(3):
        assert port_r.restore_replica() == ref_r.restore_replica()
        same()
    port_r.image_store().flush()
    ref_r.image_store().flush()
    same()
    assert port_r.stats.as_dict() == ref_r.stats.as_dict()
    assert port_r.image_store().totals.__dict__ == ref_r.image_store().totals.__dict__
