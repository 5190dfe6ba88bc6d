"""The port's CUDA kernels on the card, against their plain torch versions
and the host.  Marked ``cuda``: every test skips without a GPU.  Imports
nothing of the reference, so it runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core.memento import MementoHash
from repro_torch.kernels import delta_apply as da
from repro_torch.kernels import engine
from repro_torch.serve.router import SessionRouter

pytestmark = pytest.mark.cuda

KEYS = np.concatenate([
    np.asarray([0, 1, 2**31 - 1, 2**31, 2**32 - 1], np.uint32),
    np.random.default_rng(5).integers(0, 2**32, size=20_000, dtype=np.uint32)])


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _churned(n: int, removals: int, seed: int) -> MementoHash:
    """``removals`` removals of random working buckets (one pass over a
    permutation, so large n stays cheap)."""
    m = MementoHash(n, variant="32")
    for b in np.random.default_rng(seed).permutation(n).tolist()[:removals]:
        if m.is_working(b) and m.working > 1:
            m.remove(b)
    return m


@pytest.mark.parametrize("n", [1, 2, 3, 127, 128, 129, 2**16 - 1, 2**16 + 1])
@pytest.mark.parametrize("removed", [0.0, 0.5, 0.9])
def test_memento_lookup_kernel_matches_plain_and_host(dev, n, removed):
    m = _churned(n, int(removed * n), seed=n)
    repl = m.device_image().arrays["repl"].to(dev)
    keys = engine.key_tensor(KEYS, dev)
    out = engine.memento_lookup(keys, repl, m.n)
    torch.cuda.synchronize()
    plain = engine.memento_lookup_plain(keys, repl, m.n)
    assert torch.equal(out, plain)
    host = [m.lookup(int(k)) for k in KEYS[:300]]
    assert out[:300].cpu().tolist() == host


def test_memento_diff_kernel_matches_plain(dev):
    a = _churned(3000, 1000, seed=1)
    b = _churned(3000, 1000, seed=1)
    b.remove(sorted(b.working_set())[7])
    keys = engine.key_tensor(KEYS, dev)
    ra = a.device_image().arrays["repl"].to(dev)
    rb = b.device_image().arrays["repl"].to(dev)
    got = engine.memento_diff(keys, ra, a.n, rb, b.n)
    torch.cuda.synchronize()
    want = engine.memento_diff_plain(keys, ra, a.n, rb, b.n)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_empty_batch_launches_nothing(dev):
    repl = torch.full((128,), -1, dtype=torch.int32, device=dev)
    before = dict(engine.LAUNCHES)
    out = engine.memento_lookup(engine.key_tensor([], dev), repl, 5)
    assert out.shape == (0,) and engine.LAUNCHES == before


def test_kernel_rejects_mixed_devices(dev):
    repl = torch.full((128,), -1, dtype=torch.int32)
    with pytest.raises(ValueError):
        engine.memento_lookup(engine.key_tensor(KEYS, dev), repl, 5)


@pytest.mark.parametrize("table_dtype", [torch.int32, torch.uint32])
def test_delta_apply_kernel_matches_plain_last_write_wins(dev, table_dtype):
    rng = np.random.default_rng(9)
    base = rng.integers(-1, 1000, size=5000).astype(np.int32)
    idx = rng.integers(0, 5000, size=600)
    idx[-100:] = idx[:100]  # duplicates: the last write wins
    idx[5] = -3             # negative and past-the-end indices never write
    idx[6] = 5000
    vals = rng.integers(-1, 1000, size=600).astype(np.int32)
    want = base.copy()
    for i, v in zip(idx.tolist(), vals.tolist()):
        if 0 <= i < len(want):
            want[i] = v
    table = torch.from_numpy(base).to(dev).view(table_dtype)
    out = da.scatter_update(table, idx, vals)
    torch.cuda.synchronize()
    assert out.dtype == table_dtype
    assert (out.view(torch.int32).cpu().numpy() == want).all()
    assert (table.view(torch.int32).cpu().numpy() == base).all()  # out of place
    uidx, uvals = da.dedup_last(idx, vals)
    pidx, pval, k = da._pad_updates(uidx, uvals, sentinel=-1)
    meta = torch.from_numpy(np.concatenate([pidx, pval])).to(dev)
    t32 = table.view(torch.int32)
    assert torch.equal(da.delta_apply(t32, meta, k), da.delta_apply_plain(t32, meta, k))
    assert torch.equal(da.delta_apply(t32, meta, 0), t32)


@pytest.mark.parametrize("sync_mode", ["block", "overlap"])
def test_router_on_cuda_matches_host(dev, sync_mode):
    router = SessionRouter(500, sync_mode=sync_mode)
    assert router.device.type == "cuda"
    ids = np.random.default_rng(2).integers(0, 2**63, size=4000, dtype=np.uint64)
    router.route_batch(ids)
    for victim in (3, 250, 499, 17):
        router.fail_replica(victim)
        router.image_store().flush()
        assert router.route_batch(ids).tolist() == [router.route(int(s)) for s in ids]
    router.restore_replica()
    router.image_store().flush()
    assert router.route_batch(ids).tolist() == [router.route(int(s)) for s in ids]
    assert router.image_store().totals.delta_applies == 5
