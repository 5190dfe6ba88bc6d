"""The port's PowerHash plain versions (what ``power_lookup`` and
``power_diff`` are held against on the card) at the top level's band edges
and at the diffs the kernels treat apart (two epochs of one top level, one
band edge crossed, several), against the reference, exactly; and the two
claims the kernels and ``chip_smoke.py`` rest on: the per-key draws and
levels of the warp model (``chip_smoke.power_work``) are the plain
counters', and two epochs of one top level draw one top sequence and one
descent (``power_pair_diff_kernel``)."""
from __future__ import annotations

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import make_hash as ref_make_hash
from repro.kernels import engine as ref
from repro.kernels.primitives import power32 as ref_power32
from repro_torch.convert import image_from_arrays
from repro_torch.core.power import POWER_SALT, POWER_TRY_CAP
from repro_torch.kernels import engine as port
from repro_torch.kernels.primitives import as_u32, hash2

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

KEYS = np.concatenate([
    np.asarray([0, 1, 2**31 - 1, 2**31, 2**32 - 1], np.uint32),
    np.random.default_rng(41).integers(0, 2**32, size=2000, dtype=np.uint32)])
#: n = 1, 2, 3 and each side of the top level's band edges 2^7, 2^16, 2^20
POWER_NS = [1, 2, 3] + [2**k + d for k in (7, 16, 20) for d in (-1, 0, 1)]
#: epoch pairs of one top level (n_old = n_new among them)
EQUAL_LEVEL = [(10**6, 10**6 - 1), (10**5, 10**5 - 1), (1000, 600), (2**20 + 1, 2**21),
               (1000, 1000), (2, 1)]
#: and pairs across one band edge, and across several
CROSSING = [(2**17 + 1, 2**17), (2**16, 2**16 + 1), (3, 2), (10**6, 10**5), (2**20 + 1, 3)]


def _images(n: int):
    """The reference's PowerHash image at ``n`` and the port's copy of it."""
    img = ref_make_hash("power", n, variant="32").device_image()
    return img, image_from_arrays(img.algo, img.n, img.arrays, img.scalars, img.epoch)


def _operands(n: int):
    return port.image_operands(_images(n)[1])


@pytest.mark.parametrize("n", POWER_NS)
def test_plain_power_lookup_at_band_edges_matches_reference(n):
    """The plain ``power_lookup`` on each side of a band edge (the top level
    L changes there) equals the reference's ``power32`` on the CPU and the
    reference host's lookup."""
    got = port.lookup_plain("power", port.key_tensor(KEYS, "cpu"), *_operands(n))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_power32(jnp.asarray(KEYS), n)))
    h = ref_make_hash("power", n, variant="32")
    assert got[:64].tolist() == [h.lookup(int(k)) for k in KEYS[:64]]


@pytest.mark.parametrize("pair", EQUAL_LEVEL + CROSSING)
def test_plain_power_diff_at_equal_and_crossing_levels_matches_reference(pair):
    """``diff_plain("power", ...)`` of two epochs of one top level, across
    one band edge and across several equals the reference's diff."""
    (old, old_port), (new, new_port) = _images(pair[0]), _images(pair[1])
    got = port.diff_plain("power", port.key_tensor(KEYS, "cpu"),
                          port.image_operands(old_port), port.image_operands(new_port))
    want = ref.engine_diff(KEYS, old, new, plane="jnp")
    for g, w in zip(got, (want.old, want.new, want.moved)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("n", [2, 3, 1000, 10**5 - 1, 10**6])
def test_power_rounds_draws_and_levels_equal_plain_counters(n):
    """``chip_smoke.power_work``'s draws and levels a key sum to the plain
    version's counters and equal, key by key, the reference host's
    ``lookup_trace``; ``power_rounds`` over them charges the top level's
    loop only where it runs in each thread, and no draw or level past the
    first draw where every key ends there (n = 2)."""
    keys = port.key_tensor(KEYS, "cpu")
    work: dict = {}
    port.lookup_plain("power", keys, *_operands(n), work)
    draws, levels = chip_smoke.power_work(keys, n)
    assert (int(draws.sum()), int(levels.sum())) == (work.get("draw", 0), work.get("level", 0))
    h = ref_make_hash("power", n, variant="32")
    traces = [h.lookup_trace(int(k)) for k in KEYS]
    assert draws.tolist() == [t[1] for t in traces]
    assert levels.tolist() == [t[2] for t in traces]
    L = chip_smoke.power_level_of(n)
    model = chip_smoke.power_rounds(draws, levels, L)
    assert model["PR 24"] == pytest.approx(model["step 1"] + 3 * (L + 1))
    per_key = chip_smoke.ALGO_OPS["power"][0]
    assert model["step 1"] > model["kept"] >= per_key
    if n == 2:
        assert model["kept"] == per_key
    else:
        assert model["kept"] > per_key


@pytest.mark.parametrize("pair", EQUAL_LEVEL)
def test_equal_level_pair_draws_one_sequence_and_one_descent(pair):
    """Two epochs of one top level L: each epoch's top draws are a prefix of
    one sequence (the epoch of the larger n stops at or before the other),
    and an epoch that descends takes the descent the other takes: the
    buckets that sequence and that descent give equal each epoch's plain
    lookup."""
    n_hi, n_lo = max(pair), min(pair)
    L = chip_smoke.power_level_of(n_hi)
    assert chip_smoke.power_level_of(n_lo) == L
    keys = as_u32(port.key_tensor(KEYS, "cpu"))
    base, mask = POWER_SALT + (L << 6), (2 << L) - 1
    seq = torch.stack([hash2(keys, base + t) & mask for t in range(POWER_TRY_CAP)])
    descent = torch.zeros_like(keys)
    for j in range(L):  # the highest level that takes its draw wins
        c = hash2(keys, POWER_SALT + (j << 6)) & ((2 << j) - 1)
        descent = torch.where(c >= (1 << j), c, descent)
    cols = torch.arange(len(KEYS))
    stops = {}
    for n in (n_hi, n_lo):
        below = seq < n
        stops[n] = torch.where(below.any(0), below.int().argmax(0), POWER_TRY_CAP - 1)
        v = seq[stops[n], cols]
        bucket = torch.where((v < n) & (v >= (1 << L)), v, descent)
        plain = port.lookup_plain("power", port.key_tensor(KEYS, "cpu"), *_operands(n))
        assert torch.equal(bucket, plain.long())
        assert torch.equal(chip_smoke.power_work(port.key_tensor(KEYS, "cpu"), n)[0], stops[n])
    assert (stops[n_hi] <= stops[n_lo]).all()
