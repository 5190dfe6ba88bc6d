"""The port's epoch-delta apply (the ``delta_apply`` kernel's plain torch
version, as its wrapper runs it on CPU tensors) against the reference's
``repro.kernels.delta_apply`` on both planes (Pallas in interpret mode,
and jnp), exactly."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.kernels import delta_apply as ref
from repro_torch.kernels import delta_apply as port

RNG = np.random.default_rng(31)
TABLE = RNG.integers(-1, 500, size=1024).astype(np.int32)


def _updates(k: int, dup: int, seed: int):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, TABLE.size, size=k)
    idx[k - dup:] = idx[:dup]  # repeated indices: the last write wins
    return idx.astype(np.int32), rng.integers(-1, 500, size=k).astype(np.int32)


@pytest.mark.parametrize("plane", ["pallas", "jnp"])
@pytest.mark.parametrize("k,dup", [(1, 0), (7, 0), (8, 3), (9, 4), (300, 120)])
def test_scatter_update_matches_reference(plane, k, dup):
    idx, vals = _updates(k, dup, seed=k)
    table = torch.from_numpy(TABLE.copy())
    got = port.scatter_update(table, idx, vals)
    want = np.asarray(ref.scatter_update(TABLE, idx, vals, plane=plane))
    np.testing.assert_array_equal(got.numpy(), want)
    loop = TABLE.copy()
    for i, v in zip(idx.tolist(), vals.tolist()):
        loop[i] = v
    np.testing.assert_array_equal(got.numpy(), loop)
    np.testing.assert_array_equal(table.numpy(), TABLE)  # input left unchanged


def test_scatter_update_uint32_table():
    words = RNG.integers(0, 2**32, size=256, dtype=np.uint32)
    idx = np.asarray([3, 200, 3], np.int32)
    vals = np.asarray([2**32 - 1, 5, 2**31], np.uint32).view(np.int32)
    got = port.scatter_update(torch.from_numpy(words.view(np.int32)).view(torch.uint32),
                              idx, vals)
    assert got.dtype == torch.uint32
    want = np.asarray(ref.scatter_update(words, idx, vals, plane="pallas"))
    np.testing.assert_array_equal(got.view(torch.int32).numpy().view(np.uint32), want)


def test_scatter_update_rejects_narrow_tables():
    """The int16 and int8 tables of packed images scatter as the
    reference's functional path does; other element types are refused."""
    for dtype in (np.int16, np.int8):
        table = np.arange(16, dtype=dtype)
        got = port.scatter_update(torch.from_numpy(table.copy()), [1, 5, 1], [2, -2, -1])
        want = np.asarray(ref.scatter_update(table, [1, 5, 1], [2, -2, -1], plane="jnp"))
        assert got.numpy().dtype == want.dtype and got.numpy().tobytes() == want.tobytes()
    for dtype in (torch.int64, torch.float32):
        with pytest.raises(ValueError):
            port.scatter_update(torch.zeros(16, dtype=dtype), [1], [2])


@pytest.mark.parametrize("k", [0, 1, 8, 9, 100])
def test_pad_updates_matches_reference(k):
    idx, vals = _updates(max(k, 1), 0, seed=k)
    idx, vals = idx[:k], vals[:k]
    for sentinel in (-1, np.iinfo(np.int32).max):
        for a, b in zip(port._pad_updates(idx, vals, sentinel),
                        ref._pad_updates(idx, vals, sentinel)):
            np.testing.assert_array_equal(a, b)


def test_plain_version_skips_padding_and_out_of_range():
    pidx, pval, k = port._pad_updates(np.asarray([2, -5, 1024, 7]),
                                      np.asarray([11, 12, 13, 14]), sentinel=-1)
    meta = torch.from_numpy(np.concatenate([pidx, pval]))
    out = port.delta_apply(torch.from_numpy(TABLE.copy()), meta, k)
    want = TABLE.copy()
    want[2], want[7] = 11, 14
    np.testing.assert_array_equal(out.numpy(), want)
    assert torch.equal(port.delta_apply(torch.from_numpy(TABLE), meta, 0),
                       torch.from_numpy(TABLE))
    with pytest.raises(ValueError):
        port.delta_apply(torch.from_numpy(TABLE), meta, len(pidx) + 1)


def test_dedup_last_keeps_the_last_write_in_order():
    idx, vals = port.dedup_last([5, 3, 5, 9, 3], [1, 2, 3, 4, 5])
    assert idx.tolist() == [5, 9, 3] and vals.tolist() == [3, 4, 5]


def test_compose_updates_matches_reference():
    seq = [{"repl": _updates(20, 5, seed=s)} for s in range(4)]
    seq.append({"repl": (np.asarray([], np.int32), np.asarray([], np.int32)),
                "load": _updates(6, 2, seed=9)})
    got, want = port.compose_updates(seq), ref.compose_updates(seq)
    assert got.keys() == want.keys()
    for name in want:
        for a, b in zip(got[name], want[name]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("plane", ["pallas", "jnp"])
def test_apply_updates_passes_untouched_arrays_by_reference(plane):
    arrays = {"repl": torch.from_numpy(TABLE.copy()),
              "load": torch.from_numpy(TABLE[::-1].copy()),
              "spare": torch.from_numpy(TABLE[:128].copy())}
    updates = {"repl": _updates(12, 4, seed=1),
               "load": (np.asarray([], np.int32), np.asarray([], np.int32))}
    got = port.apply_updates(arrays, updates)
    assert got["load"] is arrays["load"] and got["spare"] is arrays["spare"]
    assert got["repl"] is not arrays["repl"]
    want = ref.apply_updates({k: v.numpy() for k, v in arrays.items()}, updates,
                             plane=plane)
    for name in arrays:
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))
