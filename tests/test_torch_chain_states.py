"""The port's plain AnchorHash and Memento bodies against the reference
engine (jnp, and Pallas in interpret mode) at the states their CUDA kernels
are timed on: AnchorHash at a/w = 40 after a one-shot removal and after a
LIFO run of removals (long K chains), its lookup and its epoch diff both
ways; and Memento's k = 1 diff of two epochs of one n (one jump32 serves
both on the card), dense and packed.  Exact."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.core import make_hash as ref_make_hash
from repro.core import packing as rpk
from repro.kernels import engine as ref
from repro_torch.convert import image_from_arrays
from repro_torch.kernels import engine as port

KEYS = np.concatenate([
    np.asarray([0, 1, 2**31, 2**32 - 1], np.uint32),
    np.random.default_rng(17).integers(0, 2**32, size=600, dtype=np.uint32)])
PLANES = ["jnp", "pallas"]
ANCHOR_A = 800  # AnchorHash capacity; a/w = 40 leaves 20 working buckets


def _port_image(img):
    """A reference image (dense or packed) as a port image, dtypes kept."""
    return image_from_arrays(img.algo, img.n, {k: np.asarray(v) for k, v in img.arrays.items()},
                             img.scalars, img.epoch, packed=img.packed)


def _anchor(removal: str, extra: int = 0):
    """The reference's AnchorHash of capacity ``ANCHOR_A``, all working at
    first, brought to a/w = 40: a one-shot removal of random buckets, or a
    LIFO run (the working list's head, then each removal the bucket that
    replaced the last one removed, so every K chain is the run); then
    ``extra`` more removals of the lowest working bucket."""
    h = ref_make_hash("anchor", ANCHOR_A, capacity=ANCHOR_A, variant="32")
    victims = np.random.default_rng(3).permutation(ANCHOR_A).tolist()
    b = None
    while h.working > ANCHOR_A // 40:
        if removal == "one-shot":
            b = int(victims.pop())
        elif b is None or h.A[h.K[b]] != 0:
            b = int(h.W[0])
        else:
            b = int(h.K[b])
        h.remove(b)
    for _ in range(extra):
        h.remove(min(h.working_set()))
    return h


def _operands(img):
    return port.image_operands(_port_image(img))


@pytest.mark.parametrize("plane", PLANES)
@pytest.mark.parametrize("removal", ["one-shot", "LIFO run"])
def test_anchor_body_matches_reference_at_chain_heavy_states(removal, plane):
    """The plain ``anchor_body`` and the reference's engine agree on every
    key; the states walk several removed buckets a key, and the LIFO run
    long successor chains (the plain counters say how many)."""
    h = _anchor(removal)
    img = h.device_image()
    keys = port.key_tensor(KEYS, "cpu")
    work: dict = {}
    got = port.lookup_plain("anchor", keys, *_operands(img), work)
    want = np.asarray(ref.engine_lookup(KEYS, img, plane=plane))
    np.testing.assert_array_equal(got.numpy(), want)
    assert work["outer"] > 3 * len(KEYS)
    assert work["read"] > (10 if removal == "LIFO run" else 1) * len(KEYS)
    assert got[:50].tolist() == [h.lookup(int(k)) for k in KEYS[:50]]


@pytest.mark.parametrize("plane", PLANES)
@pytest.mark.parametrize("removal", ["one-shot", "LIFO run"])
def test_anchor_diff_matches_reference_both_ways(removal, plane):
    """``diff_plain`` of AnchorHash across three more removals, old -> new
    and new -> old, against the reference's fused diff."""
    old, new = _anchor(removal).device_image(), _anchor(removal, extra=3).device_image()
    keys = port.key_tensor(KEYS, "cpu")
    for a, b in ((old, new), (new, old)):
        got = port.diff_plain("anchor", keys, _operands(a), _operands(b))
        want = ref.engine_diff(KEYS, a, b, plane=plane)
        np.testing.assert_array_equal(got[0].numpy(), want.old)
        np.testing.assert_array_equal(got[1].numpy(), want.new)
        np.testing.assert_array_equal(got[2].numpy().astype(bool), np.asarray(want.moved))
        assert want.num_moved > 0


def _memento_pair(pair: str):
    """Two reference Memento epochs of one n: a one-shot removal of 90 % of
    an unchurned cluster, or one removal in a churned one."""
    rng = np.random.default_rng(8)
    old = ref_make_hash("memento", 400, variant="32")
    if pair == "one removal":
        for b in rng.permutation(399)[:150].tolist():  # never n - 1: n stays
            old.remove(int(b))
    before = old.device_image()
    count = 1 if pair == "one removal" else 360
    for b in rng.permutation(sorted(old.working_set() - {old.n - 1}))[:count].tolist():
        old.remove(int(b))
    return before, old.device_image()


@pytest.mark.parametrize("plane", PLANES)
@pytest.mark.parametrize("table", ["dense", "packed"])
@pytest.mark.parametrize("pair", ["one-shot", "one removal"])
def test_memento_diff_of_one_n_matches_reference(pair, table, plane):
    """``diff_plain`` of two Memento epochs of one n, each way round, against
    the reference's fused diff, dense and packed."""
    old, new = _memento_pair(pair)
    assert old.n == new.n
    if table == "packed":
        old, new = rpk.pack_image(old), rpk.pack_image(new)
    keys = port.key_tensor(KEYS, "cpu")
    for a, b in ((old, new), (new, old)):
        got = port.diff_plain("memento", keys, _operands(a), _operands(b), table=table)
        want = ref.engine_diff(KEYS, a, b, plane=plane)
        np.testing.assert_array_equal(got[0].numpy(), want.old)
        np.testing.assert_array_equal(got[1].numpy(), want.new)
        np.testing.assert_array_equal(got[2].numpy().astype(bool), np.asarray(want.moved))
        assert got[2].dtype == torch.bool and want.num_moved > 0
