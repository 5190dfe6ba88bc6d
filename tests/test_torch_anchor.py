"""The port's model of the AnchorHash diffs' kernels (``anchor_replica_diff``,
``anchor_packed_diff`` and ``anchor_packed_replica_diff``: their check,
``anchor_nest_plain``, and their walk of both epochs through the deeper
one's tables, ``anchor_nested_plain``, ``anchor_pair_diff_plain`` and
``anchor_pair_replica_diff_plain``) against the reference, exactly:
removal-only epoch pairs (one with no removal in the older epoch), restore
pairs (the newer epoch the shallower) and pairs whose removal stacks part
after a common prefix (remove x, restore it, remove y), where the check
must say no; k = 1 and k = 3; dense, and packed at int16 and int8 (and one
epoch of each), with tables padded past a.  The check's verdict and the
shallower epoch's working count are held against the host's removal
stacks."""
from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import make_hash as ref_make_hash
from repro.core import packing as rpk
from repro.kernels import engine as ref
from repro_torch.convert import image_from_arrays
from repro_torch.kernels import engine as port

KEYS = np.concatenate([
    np.asarray([0, 1, 2**31 - 1, 2**31, 2**32 - 1], np.uint32),
    np.random.default_rng(26).integers(0, 2**32, size=1500, dtype=np.uint32)])


class _Epoch:
    """One snapshot of a reference AnchorHash: its image, removal stack and
    working count."""

    def __init__(self, h):
        self.image = h.device_image()
        self.stack = list(h.R)
        self.working = h.N

    def operands(self):
        img = self.image
        return port.image_operands(
            image_from_arrays(img.algo, img.n, img.arrays, img.scalars, img.epoch))


def _remove(h, count: int, rng) -> None:
    for b in rng.permutation(h.a).tolist():
        if count == 0:
            return
        if h.is_working(b) and h.N > 1:
            h.remove(b)
            count -= 1


def _working_victim(h, rng) -> int:
    return int(rng.choice(sorted(h.working_set())))


def _pair(kind: str, a: int, w_old: int, w_new: int, seed: int):
    """(old, new) snapshots of one reference AnchorHash of capacity ``a``:
    "remove", w_old working, then removals down to w_new; "restore", the
    same two states the other way round (the newer epoch restores the older
    one's last removals); "diverge", w_old working and one more bucket x
    removed, then x restored and another bucket y removed (w_new unused)."""
    rng = np.random.default_rng(seed)
    h = ref_make_hash("anchor", a, capacity=a, variant="32")
    if kind in ("remove", "restore"):
        hi, lo = max(w_old, w_new), min(w_old, w_new)
        _remove(h, a - hi, rng)
        shallow = _Epoch(h)
        _remove(h, hi - lo, rng)
        deep = _Epoch(h)
        return (shallow, deep) if kind == "remove" else (deep, shallow)
    _remove(h, a - w_old, rng)
    h.remove(_working_victim(h, rng))
    old = _Epoch(h)
    h.add()
    h.remove(_working_victim(h, rng))
    return old, _Epoch(h)


#: (kind, a, older epoch's working count, newer one's)
PAIRS = [
    ("remove", 50, 50, 10),          # the older epoch has no removal
    ("remove", 400, 200, 3),         # the deeper row's salts outlast the other's
    ("remove", 400, 399, 398),       # one removal
    ("remove", 4000, 2000, 1000),
    ("remove", 4000, 1000, 100),     # a one-shot 90 % removal
    ("restore", 400, 3, 200),
    ("restore", 4000, 100, 1000),
    ("restore", 4000, 1000, 1000),   # one epoch twice
    ("diverge", 400, 200, 0),
    ("diverge", 4000, 100, 0),
]
_IDS = [f"{kind} a={a} {wo}->{wn}" for kind, a, wo, wn in PAIRS]


def _stack_verdict(old: _Epoch, new: _Epoch) -> tuple[int, int]:
    """The check's verdict from the host's removal stacks: the older epoch
    is the shallower when its stack is a prefix of the newer one's (equal
    stacks included), else the newer when its stack is a prefix of the
    older one's, else none."""
    if new.stack[:len(old.stack)] == old.stack:
        return port.NEST_OLD_SHALLOW, old.working
    if old.stack[:len(new.stack)] == new.stack:
        return port.NEST_NEW_SHALLOW, new.working
    return port.NEST_NONE, 0


@pytest.mark.parametrize("pair", PAIRS, ids=_IDS)
def test_nest_check_matches_host_stacks(pair):
    """``anchor_nest_plain`` (the kernel's check, from A and K alone) gives
    the verdict and the shallower epoch's working count that the host's
    removal stacks give; "diverge" pairs do not nest."""
    old, new = _pair(*pair, seed=len(pair[0]) + pair[1])
    want = _stack_verdict(old, new)
    assert port.anchor_nest_plain(old.operands(), new.operands()) == want
    assert (want[0] == port.NEST_NONE) == (pair[0] == "diverge")
    keys = port.key_tensor(KEYS[:64], "cpu")
    nest = port.kernel_replica_diff("anchor", keys, 3, old.operands(), new.operands(),
                                    with_nest=True)[3]
    assert tuple(nest.tolist()) == want


def test_nest_words_match_the_kernel_source():
    """The check's workspace that ``kernel_replica_diff`` puts past the end
    of ``moved`` is as long as the kernel's ``NestWork``, and the check's
    one-block bound is the kernel's."""
    src = (Path(port.__file__).parent / "csrc" / "engine.cu").read_text()
    assert f"constexpr int kNestWords = {port.NEST_WORDS};" in src
    assert f"constexpr int32_t kNestBlockMax = 1 << {port.NEST_BLOCK_MAX.bit_length() - 1};" in src


@pytest.mark.parametrize("pair", [p for p in PAIRS if p[0] != "diverge"],
                         ids=[i for p, i in zip(PAIRS, _IDS) if p[0] != "diverge"])
def test_nested_walk_gives_both_epochs_lookups(pair):
    """One ``anchor_nested_plain`` walk through the deeper epoch's tables
    gives the shallower epoch's lookup where it first meets a bucket
    stamped below the shallower working count, and the deeper epoch's where
    it ends: both equal the reference's lookups of each epoch (jnp
    plane)."""
    old, new = _pair(*pair, seed=len(pair[0]) + pair[1])
    verdict, n_shallow = port.anchor_nest_plain(old.operands(), new.operands())
    shallow, deep = (old, new) if verdict == port.NEST_OLD_SHALLOW else (new, old)
    (A, K), (a,) = deep.operands()
    keys = port.key_tensor(KEYS, "cpu")
    got = port.anchor_nested_plain(port.as_u32(keys), A, K, a, n_shallow)
    for g, epoch in zip(got, (shallow, deep)):
        want = np.asarray(ref.engine_lookup(KEYS, epoch.image, plane="jnp"))
        np.testing.assert_array_equal(g.numpy(), want)
    assert got[0].shape == got[1].shape == (len(KEYS),)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("pair", PAIRS, ids=_IDS)
def test_pair_model_matches_reference_diff(pair, k):
    """``anchor_pair_replica_diff_plain`` (the check, then both rows on one
    salt walk through the deeper epoch's tables; two walks for pairs that do
    not nest) equals the reference's k-slot diff of the two epochs and the
    port's ``replica_diff_plain``."""
    old, new = _pair(*pair, seed=len(pair[0]) + pair[1])
    keys = port.key_tensor(KEYS, "cpu")
    got = port.anchor_pair_replica_diff_plain(keys, k, old.operands(), new.operands())
    want = ref.engine_diff(KEYS, old.image, new.image, k=k, plane="jnp")
    for g, w in zip(got, (want.old, want.new, want.moved)):
        np.testing.assert_array_equal(g.numpy().reshape(np.shape(w)), np.asarray(w))
    for g, w in zip(got, port.replica_diff_plain("anchor", keys, k, old.operands(),
                                                 new.operands())):
        assert torch.equal(g, w)


@pytest.mark.parametrize("pair", [p for p in PAIRS if p[0] != "diverge"],
                         ids=[i for p, i in zip(PAIRS, _IDS) if p[0] != "diverge"])
def test_pair_model_draws_each_salt_once_for_both_rows(pair):
    """The pair walk's salted tries: each row tries the salts its epoch's
    own walk tries (``replica_plain``'s counter), each salt either row needs
    is drawn once, and on "a=400 200->3" at k = 3 some salts serve the
    deeper row alone (its three buckets collide) and some the shallower row
    alone (its walk then stops at the shallower answer)."""
    old, new = _pair(*pair, seed=len(pair[0]) + pair[1])
    keys = port.key_tensor(KEYS, "cpu")
    work: dict = {}
    port.anchor_pair_replica_diff_plain(keys, 3, old.operands(), new.operands(), work)
    verdict, _ = port.anchor_nest_plain(old.operands(), new.operands())
    shallow, deep = (old, new) if verdict == port.NEST_OLD_SHALLOW else (new, old)
    for role, epoch in (("shallow", shallow), ("deep", deep)):
        plain: dict = {}
        port.replica_plain("anchor", keys, 3, *epoch.operands(), work=plain)
        assert work.get(f"try_{role}", 0) == plain.get("try", 0), role
    both = work.get("try_shallow", 0) + work.get("try_deep", 0)
    assert max(work.get("try_shallow", 0), work.get("try_deep", 0)) <= work["try"] <= both
    assert work["lookups"] == len(KEYS) + work["try"]
    if pair[1:] in ((400, 200, 3), (400, 3, 200)):
        assert work["try"] > work["try_shallow"] and work["try"] > work["try_deep"]


def _packed(epoch: _Epoch, dtype, fill: int | None = None):
    """``epoch``'s image packed by the reference (A and K int16 at a ≤ 2^15),
    cast to ``dtype`` by hand (the values fit), and with ``fill`` written
    into every A and K word past a (``pack_image`` pads the tables to 128
    words at least): the reference's packed image and the port's operands of
    it."""
    img = rpk.pack_image(epoch.image)
    arrays = {}
    for name, v in img.arrays.items():
        v = np.asarray(v).astype(dtype)
        if fill is not None:
            v[img.n:] = fill
        arrays[name] = v
    ref_img = type(img)(algo=img.algo, n=img.n, arrays=arrays, scalars=dict(img.scalars),
                        epoch=img.epoch, packed=True)
    port_img = image_from_arrays(img.algo, img.n, arrays, img.scalars, img.epoch, packed=True)
    return ref_img, port.image_operands(port_img, "packed")


#: packed epoch pairs: (kind, a, older epoch's working count, newer one's,
#: older epoch's dtype, newer one's, the padding's fill of the shallower
#: epoch, of the deeper one); int16 from ``pack_image``, int8 by hand
PACKED_PAIRS = [
    ("remove", 4000, 1000, 100, np.int16, np.int16, None, None),
    ("restore", 4000, 100, 1000, np.int16, np.int16, None, None),
    ("diverge", 4000, 100, 0, np.int16, np.int16, None, None),
    ("remove", 120, 60, 10, np.int8, np.int8, None, None),
    ("restore", 120, 10, 60, np.int8, np.int8, None, None),
    ("diverge", 120, 30, 0, np.int8, np.int8, None, None),
    ("remove", 120, 60, 59, np.int8, np.int16, None, None),   # one epoch of each width
    ("restore", 120, 5, 80, np.int16, np.int8, None, None),
    # the padding, if read, would part the stacks (a removal only the
    # shallower epoch made) or put the deeper epoch's stamps above N_S
    ("remove", 100, 50, 49, np.int8, np.int8, 1, 127),
    ("restore", 120, 7, 90, np.int16, np.int16, 3, 119),
]
_PACKED_IDS = [f"{kind} a={a} {wo}->{wn} {np.dtype(do).name}->{np.dtype(dn).name}"
               f"{' padded' if fs is not None else ''}"
               for kind, a, wo, wn, do, dn, fs, fd in PACKED_PAIRS]


def _packed_pair(kind, a, w_old, w_new, dtype_old, dtype_new, fill_shallow, fill_deep):
    """A packed pair of PACKED_PAIRS: the host epochs (old, new) and each
    epoch's (reference image, port operands)."""
    old, new = _pair(kind, a, w_old, w_new, seed=len(kind) + a + w_old)
    shallow_is_old = kind != "restore"
    fills = (fill_shallow, fill_deep) if shallow_is_old else (fill_deep, fill_shallow)
    return (old, new), (_packed(old, dtype_old, fills[0]), _packed(new, dtype_new, fills[1]))


@pytest.mark.parametrize("pair", PACKED_PAIRS, ids=_PACKED_IDS)
def test_packed_nest_check_matches_host_stacks(pair):
    """``anchor_nest_plain`` over packed epochs of any width gives the host
    stacks' verdict and N_S, whatever the tables hold past a; so does
    ``kernel_diff`` / ``kernel_replica_diff(..., with_nest=True)`` of the
    packed entries on the CPU, whose outputs are the plain versions'."""
    (old, new), ((_, o), (_, n)) = _packed_pair(*pair)
    want = _stack_verdict(old, new)
    assert (want[0] == port.NEST_NONE) == (pair[0] == "diverge")
    assert port.anchor_nest_plain(o, n) == want
    keys = port.key_tensor(KEYS[:64], "cpu")
    *got, nest = port.kernel_diff("anchor", keys, o, n, table="packed", with_nest=True)
    assert tuple(nest.tolist()) == want
    for g, w in zip(got, port.diff_plain("anchor", keys, o, n, table="packed")):
        assert torch.equal(g, w)
    *got, nest = port.kernel_replica_diff("anchor", keys, 3, o, n, table="packed",
                                          with_nest=True)
    assert tuple(nest.tolist()) == want
    for g, w in zip(got, port.replica_diff_plain("anchor", keys, 3, o, n, table="packed")):
        assert torch.equal(g, w)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("pair", PACKED_PAIRS, ids=_PACKED_IDS)
def test_packed_pair_models_match_reference_diff(pair, k):
    """The pair models on packed epochs (``anchor_pair_diff_plain`` at k = 1,
    ``anchor_pair_replica_diff_plain`` at k = 3: the check, then one walk
    through the deeper epoch's narrow tables, or two walks) equal the
    reference's ``engine_diff`` of the same packed images (jnp plane) and
    the port's two-walk plain versions."""
    _, ((ref_o, o), (ref_n, n)) = _packed_pair(*pair)
    keys = port.key_tensor(KEYS, "cpu")
    if k == 1:
        got = port.anchor_pair_diff_plain(keys, o, n)
        plain = port.diff_plain("anchor", keys, o, n, table="packed")
    else:
        got = port.anchor_pair_replica_diff_plain(keys, k, o, n)
        plain = port.replica_diff_plain("anchor", keys, k, o, n, table="packed")
    want = ref.engine_diff(KEYS, ref_o, ref_n, k=k, plane="jnp")
    for g, w in zip(got, (want.old, want.new, want.moved)):
        np.testing.assert_array_equal(g.numpy().reshape(np.shape(w)), np.asarray(w))
    for g, w in zip(got, plain):
        assert torch.equal(g, w)


@pytest.mark.parametrize("pair", [p for p in PAIRS if p[0] != "diverge"],
                         ids=[i for p, i in zip(PAIRS, _IDS) if p[0] != "diverge"])
def test_k1_pair_model_walks_once_for_both_epochs(pair):
    """``anchor_pair_diff_plain`` looks each key up once for both epochs, and
    its walk reads what the deeper epoch's own lookup reads: its counters
    equal ``lookup_plain``'s on the deeper epoch."""
    old, new = _pair(*pair, seed=len(pair[0]) + pair[1])
    verdict, _ = port.anchor_nest_plain(old.operands(), new.operands())
    deep = new if verdict == port.NEST_OLD_SHALLOW else old
    keys = port.key_tensor(KEYS, "cpu")
    work: dict = {}
    port.anchor_pair_diff_plain(keys, old.operands(), new.operands(), work)
    alone: dict = {}
    port.lookup_plain("anchor", keys, *deep.operands(), alone)
    assert work.pop("lookups") == len(KEYS)
    assert work == alone
