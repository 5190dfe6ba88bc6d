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


#: each kernel's table type: torch's, numpy's, and its bits
WIDTHS = {"int32": (torch.int32, np.int32, 32), "int16": (torch.int16, np.int16, 16),
          "int8": (torch.int8, np.int8, 8)}


@pytest.mark.parametrize("plane", ["pallas", "jnp"])
@pytest.mark.parametrize("edge", [-1, 0, 1])
@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_plain_apply_around_the_longest_one_block_table_matches_reference(width, edge, plane):
    """The plain version of each width's delta apply on a table one element
    shorter than, as long as, and one longer than the longest it copies in
    one block (``ONE_BLOCK_MAX``), with updates at the first and last index
    and -1 padding: equal to the reference's apply and an in-order loop,
    the input left unchanged."""
    dtype, np_dtype, _ = WIDTHS[width]
    length = port.ONE_BLOCK_MAX[dtype] + edge
    info = np.iinfo(np_dtype)
    rng = np.random.default_rng(length)
    base = rng.integers(info.min, info.max, size=length, endpoint=True).astype(np_dtype)
    idx = np.concatenate([[0, length - 1], rng.integers(0, length, size=9)]).astype(np.int32)
    vals = rng.integers(info.min, info.max, size=len(idx), endpoint=True).astype(np.int32)
    uidx, uvals = port.dedup_last(idx, vals)
    pidx, pval, count = port._pad_updates(uidx, uvals, sentinel=-1)
    assert (pidx[count:] == -1).all()
    table = torch.from_numpy(base.copy())
    got = port.delta_apply_plain(table, torch.from_numpy(np.concatenate([pidx, pval])), count)
    want = np.asarray(ref.scatter_update(base, idx, vals, plane=plane))
    assert got.numpy().dtype == want.dtype and got.numpy().tobytes() == want.tobytes()
    loop = base.copy()
    for i, v in zip(idx.tolist(), vals.tolist()):
        loop[i] = v
    np.testing.assert_array_equal(got.numpy(), loop)
    np.testing.assert_array_equal(table.numpy(), base)


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_apply_form_is_one_block_up_to_the_longest_table(width):
    """The wrapper's choice of form by length: one block from an empty
    table up to ``ONE_BLOCK_MAX[dtype]`` elements, the copy and the scatter
    above it (the path's 2·10^6-word int32 table among them)."""
    dtype = WIDTHS[width][0]
    top = port.ONE_BLOCK_MAX[dtype]
    for length in (0, 1, 127, 128, top - 1, top):
        assert port.apply_form(length, dtype) == "one block"
    for length in (top + 1, 2 * top, 2_000_000):
        assert port.apply_form(length, dtype) == "copy and scatter"


def test_one_block_lengths_match_the_kernel_source():
    """``ONE_BLOCK_MAX`` is ``csrc/delta_apply.cu``'s ``kOneBlockMaxInt32``,
    ``…Int16`` and ``…Int8``: the lengths at which the kernels switch form."""
    import re
    from pathlib import Path

    src = (Path(port.__file__).parent / "csrc" / "delta_apply.cu").read_text()
    found = dict(re.findall(r"constexpr long long kOneBlockMaxInt(\d+) = 1 << (\d+);", src))
    assert port.ONE_BLOCK_MAX == {dtype: 1 << int(found[str(bits)])
                                  for dtype, _, bits in WIDTHS.values()}
