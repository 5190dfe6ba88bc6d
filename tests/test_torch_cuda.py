"""The port's CUDA kernels on the card (every layout: dense, packed and
compact), against their plain torch versions and the host.  Marked ``cuda``: every test skips without a GPU.  Imports
nothing of the reference, so it runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
from __future__ import annotations

import contextlib
import threading

import numpy as np
import pytest
import torch

from repro_torch.core.memento import MementoHash
from repro_torch.core.protocol import ALGORITHMS, ALGORITHM_REGISTRY, make_hash
from repro_torch.kernels import delta_apply as da
from repro_torch.kernels import engine
from repro_torch.serve.router import SessionRouter
from repro_torch.sim import make_trace, replay

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


def _algo_state(algo: str, n: int, frac: float, seed: int):
    """A ``variant="32"`` state of ``n`` working buckets (capacity 4n for
    the fixed-capacity ones) after removing ``frac`` of them: random
    victims, or the highest ids for the LIFO-only algorithms."""
    h = make_hash(algo, n, capacity=4 * n, variant="32")
    count = int(frac * n)
    if ALGORITHM_REGISTRY[algo].lifo_only:
        victims = [h.size - 1 - i for i in range(count)]
    else:
        victims = np.random.default_rng(seed).permutation(sorted(h.working_set()))[:count]
    for b in victims:
        h.remove(int(b))
    return h


def _operands(h, dev):
    img = h.device_image()
    img.arrays = {k: v.to(dev) for k, v in img.arrays.items()}
    return engine.image_operands(img)


@pytest.mark.parametrize("n", [1, 2, 3, 127, 129, 2**16 + 1])
@pytest.mark.parametrize("removed", [0.0, 0.9])
@pytest.mark.parametrize("algo", [a for a in ALGORITHMS if a != "memento"])
def test_lookup_kernel_of_every_algorithm_matches_plain_and_host(dev, algo, n, removed):
    h = _algo_state(algo, n, removed, seed=n)
    tables, scalars = _operands(h, dev)
    keys = engine.key_tensor(KEYS, dev)
    before = engine.LAUNCHES[f"{algo}_lookup"]
    out = engine.kernel_lookup(algo, keys, tables, scalars)
    torch.cuda.synchronize()
    assert engine.LAUNCHES[f"{algo}_lookup"] == before + 1
    assert torch.equal(out, engine.lookup_plain(algo, keys, tables, scalars))
    assert out[:300].cpu().tolist() == [h.lookup(int(k)) for k in KEYS[:300]]


@pytest.mark.parametrize("algo", [a for a in ALGORITHMS if a != "memento"])
def test_diff_kernel_of_every_algorithm_matches_plain(dev, algo):
    a = _algo_state(algo, 3000, 0.0, seed=1)
    b = _algo_state(algo, 3000, 0.5, seed=1)
    keys = engine.key_tensor(KEYS, dev)
    old, new = _operands(a, dev), _operands(b, dev)
    got = engine.kernel_diff(algo, keys, old, new)
    torch.cuda.synchronize()
    want = engine.diff_plain(algo, keys, old, new)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[2].any()


@pytest.mark.parametrize("capacity, removed, factor",
                         [(1600, 390, 1), (1600, 0, 1), (1600, 390, 7), (16000, 398, 2),
                          (1600, 393, 5), (16000, 393, 3)])
def test_dx_kernel_returns_fallback_after_max_probes(dev, capacity, removed, factor):
    """Probe bounds of 160 and 4 (one thread a key), 1120 (4 lanes a key)
    and 16000 (32 lanes a key): many keys run out of probes and take the
    fallback bucket.  Bounds of 1145 (4 lanes) and 6858 (16 lanes) are no
    multiple of the group, so a group's last round runs with 1 and 10 of
    its lanes.  The same epoch diffed from a stable one takes half those
    groups (one thread a key, 2, 16; 2 and 8 lanes for 1145 and 6858)."""
    h = make_hash("dx", 400, capacity=capacity, variant="32")
    h._MAX_PROBE_FACTOR = factor
    for b in range(removed):
        h.remove(b)
    tables, scalars = _operands(h, dev)
    keys = engine.key_tensor(KEYS, dev)
    out = engine.kernel_lookup("dx", keys, tables, scalars)
    assert torch.equal(out, engine.lookup_plain("dx", keys, tables, scalars))
    assert int((out == removed).sum()) > 1000
    assert out[:300].cpu().tolist() == [h.lookup(int(k)) for k in KEYS[:300]]
    stable = _operands(make_hash("dx", 400, capacity=capacity, variant="32"), dev)
    got = engine.kernel_diff("dx", keys, stable, (tables, scalars))
    for g, w in zip(got, engine.diff_plain("dx", keys, stable, (tables, scalars))):
        assert torch.equal(g, w)
    assert torch.equal(got[1], out)


def _edge_counts(dev) -> list[int]:
    """Key counts at the edges of a lane group, a warp and a block, and one
    past 1024 keys a streaming multiprocessor."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return [0, 1, 31, 33, 1023, 1025, sms * 1024 + 1]


@pytest.mark.parametrize("ratio", [1, 4, 8, 16, 32, 64, 128, 200])
def test_dx_lookup_kernel_for_every_lane_group(dev, ratio):
    """``dx_lookup`` takes one thread a key (⌈a/w⌉ = 1, 4) or spreads a
    key's probes over G = 2, 4, 8, 16, 32 lanes (⌈a/w⌉ = 8, 16, 32, 64,
    128 and 200): equal to its plain version at every key count around a
    group, a warp and a block, and to the host."""
    a = 6400
    h = make_hash("dx", a, capacity=a, variant="32")
    for b in np.random.default_rng(ratio).permutation(a)[: a - a // ratio].tolist():
        h.remove(int(b))
    tables, scalars = _operands(h, dev)
    lanes = {1: 1, 4: 1, 8: 2, 16: 4, 32: 8, 64: 16, 128: 32, 200: 32}[ratio]
    assert engine.dx_lane_group(scalars[1]) == lanes
    counts = _edge_counts(dev)
    keys_np = np.random.default_rng(ratio).integers(0, 2**32, size=max(counts), dtype=np.uint32)
    keys_np[:5] = [0, 1, 2**31 - 1, 2**31, 2**32 - 1]
    keys = engine.key_tensor(keys_np, dev)
    want = engine.lookup_plain("dx", keys, tables, scalars)
    assert want[:300].cpu().tolist() == [h.lookup(int(k)) for k in keys_np[:300]]
    for count in counts:
        before = engine.LAUNCHES["dx_lookup"]
        out = engine.kernel_lookup("dx", keys[:count], tables, scalars)
        torch.cuda.synchronize()
        assert engine.LAUNCHES["dx_lookup"] == before + (count > 0)
        assert torch.equal(out, want[:count]), count


@pytest.mark.parametrize("a", [1, 2, 3, 7, 1_000_003, 4_000_000])
def test_dx_kernels_take_the_exact_remainder(dev, a):
    """The fixed-divisor remainder of every dx entry at odd and edge
    divisors, on the keys at the ends of the uint32 range."""
    from repro_torch.core.dx import DxHash

    h = DxHash(a, max(1, a // 4), variant="32")
    tables, scalars = _operands(h, dev)
    keys_np = np.concatenate([np.asarray([0, 1, 2**31 - 1, 2**31, 2**32 - 1], np.uint32),
                              KEYS[5:2000]])
    keys = engine.key_tensor(keys_np, dev)
    out = engine.kernel_lookup("dx", keys, tables, scalars)
    assert out.cpu().tolist() == [h.lookup(int(k)) for k in keys_np]
    assert torch.equal(out, engine.lookup_plain("dx", keys, tables, scalars))
    k = min(2, h.working)
    sets = engine.kernel_replica("dx", keys, k, tables, scalars)
    assert torch.equal(sets, engine.replica_plain("dx", keys, k, tables, scalars))
    old, new, moved = engine.kernel_diff("dx", keys, (tables, scalars), (tables, scalars))
    assert torch.equal(old, out) and torch.equal(new, out) and not moved.any()


@pytest.mark.parametrize("algo", ALGORITHMS)
def test_replay_on_cuda_matches_host_plane(dev, algo):
    for scenario in ("oneshot", "churn_storm", "serving_failure"):
        on_card = replay(make_trace(scenario, 0), algo=algo)
        host = replay(make_trace(scenario, 0), algo=algo, plane="host")
        assert on_card.ok and host.ok
        assert on_card.fingerprint == host.fingerprint


def _load(img, seed: int, high: int = 4) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, high, size=engine.bounded_load_len(img)).astype(np.int32)


@pytest.mark.parametrize("n", [1, 3, 129, 2**16 + 1])
@pytest.mark.parametrize("removed", [0.0, 0.9])
@pytest.mark.parametrize("algo", ALGORITHMS)
def test_replica_kernel_matches_plain_and_host(dev, algo, n, removed):
    h = _algo_state(algo, n, removed, seed=n)
    tables, scalars = _operands(h, dev)
    keys = engine.key_tensor(KEYS[:4000], dev)
    k = min(3, h.working)
    before = engine.LAUNCHES[f"{algo}_replica"]
    out = engine.kernel_replica(algo, keys, k, tables, scalars)
    torch.cuda.synchronize()
    assert engine.LAUNCHES[f"{algo}_replica"] == before + 1
    assert torch.equal(out, engine.replica_plain(algo, keys, k, tables, scalars))
    assert out[:200].cpu().tolist() == [h.lookup_k(int(x), k) for x in KEYS[:200]]
    if h.working < 100:
        return  # too few buckets below a cap: the exhausted walk is tested below
    for cap in (1, 3):
        load = torch.from_numpy(_load(h.device_image(), seed=cap)).to(dev)
        got = engine.kernel_replica(algo, keys, 2, tables, scalars, load, cap)
        torch.cuda.synchronize()
        assert torch.equal(got, engine.replica_plain(algo, keys, 2, tables, scalars, load, cap))


@pytest.mark.parametrize("algo", ALGORITHMS)
def test_exhausted_replica_walk_keeps_the_plain_lookup(dev, algo):
    """k above the working buckets, and every bucket at the cap: the lanes
    run out of salts and keep their plain lookup, as the plain version
    does."""
    h = _algo_state(algo, 3, 0.0, seed=1)
    tables, scalars = _operands(h, dev)
    keys = engine.key_tensor(KEYS[:64], dev)
    out = engine.kernel_replica(algo, keys, 5, tables, scalars)
    torch.cuda.synchronize()
    assert torch.equal(out, engine.replica_plain(algo, keys, 5, tables, scalars))
    load = torch.ones(engine.bounded_load_len(h.device_image()), dtype=torch.int32,
                      device=dev)
    out = engine.kernel_replica(algo, keys, 2, tables, scalars, load, 1)
    torch.cuda.synchronize()
    assert torch.equal(out, engine.replica_plain(algo, keys, 2, tables, scalars, load, 1))
    first = engine.kernel_lookup(algo, keys, tables, scalars)
    assert torch.equal(out, torch.stack([first, first], dim=1))


@pytest.mark.parametrize("algo", ALGORITHMS)
def test_replica_diff_kernel_matches_plain(dev, algo):
    a = _algo_state(algo, 3000, 0.0, seed=1)
    b = _algo_state(algo, 3000, 0.5, seed=1)
    keys = engine.key_tensor(KEYS, dev)
    old, new = _operands(a, dev), _operands(b, dev)
    got = engine.kernel_replica_diff(algo, keys, 3, old, new)
    torch.cuda.synchronize()
    want = engine.replica_diff_plain(algo, keys, 3, old, new)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[2].any() and not got[2].all()


@pytest.mark.parametrize("algo", ALGORITHMS)
def test_walk_kernel_matches_plain(dev, algo):
    h = _algo_state(algo, 3000, 0.5, seed=2)
    tables, scalars = _operands(h, dev)
    rng = np.random.default_rng(3)
    chain = engine.key_tensor(KEYS, dev)
    probe = torch.from_numpy(rng.integers(0, 9, size=len(KEYS)).astype(np.int32)).to(dev)
    pending = torch.from_numpy(rng.random(len(KEYS)) < 0.6).to(dev)
    load = torch.from_numpy(_load(h.device_image(), seed=4)).to(dev)
    for cap in (1, 3):
        got = engine.kernel_walk(algo, chain, probe, pending, tables, scalars, load, cap)
        torch.cuda.synchronize()
        want = engine.walk_plain(algo, chain, probe, pending, tables, scalars, load, cap)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("algo", ALGORITHMS)
def test_bounded_assign_on_cuda_matches_host(dev, algo):
    from repro_torch.core.bounded import bounded_assign_ref

    h = _algo_state(algo, 500, 0.5, seed=5)
    img = h.device_image()
    img.arrays = {k: v.to(dev) for k, v in img.arrays.items()}
    keys = KEYS[:3000]
    cap = -(-5 * len(keys) // (4 * h.working))
    load0 = np.zeros(engine.bounded_load_len(img), np.int32)
    got = engine.bounded_assign(keys, img, load0, cap, device=dev)
    plain = engine.bounded_assign(keys, img, load0, cap, device=dev, walk=engine.walk_plain)
    host = bounded_assign_ref(h, keys, load0, cap)
    for g, p, w in zip(got, plain, host):
        assert (g == p).all() and (g == w).all()
    bounded = engine.engine_lookup(KEYS, img, k=2, load=got[1], cap=cap + 1)
    assert bounded.cpu().numpy().tolist()[:100] == engine.bounded_replica_sets(
        h, KEYS[:100], 2, got[1], cap + 1).tolist()


def test_router_k_replica_failover_on_cuda(dev):
    router = SessionRouter(500, replicas_k=3)
    ids = np.random.default_rng(6).integers(0, 2**63, size=4000, dtype=np.uint64)
    base = router.route_batch(ids)
    victim = int(np.bincount(base).argmax())
    router.mark_failed(victim)
    after = router.route_batch(ids)
    assert victim not in set(after.tolist())
    assert (after != base).sum() == (base == victim).sum() == router.stats.failovers
    assert after.tolist() == [router.route(int(s)) for s in ids]


@pytest.mark.parametrize("algo", ALGORITHMS)
def test_session_affinity_replay_on_cuda_matches_host(dev, algo):
    on_card = replay(make_trace("session_affinity", 0), algo=algo)
    host = replay(make_trace("session_affinity", 0), algo=algo, plane="host")
    assert on_card.ok and host.ok and on_card.fingerprint == host.fingerprint


def _narrowed(img, dtype):
    """A packed image with its slots (Memento) or A/K (AnchorHash) cast to
    ``dtype``; the values fit, so every lookup stays the same."""
    from repro_torch.core.protocol import DeviceImage

    names = ("slot_b", "slot_c") if img.algo == "memento" else ("A", "K")
    arrays = {k: (v.to(dtype) if k in names else v) for k, v in img.arrays.items()}
    return DeviceImage(img.algo, img.n, arrays, dict(img.scalars), img.epoch, packed=True)


@pytest.mark.parametrize("width", [1, 2, 4])
@pytest.mark.parametrize("removed", [0.0, 0.5, 0.9])
@pytest.mark.parametrize("algo", ["memento", "anchor"])
def test_packed_kernels_match_plain_and_host(dev, algo, removed, width):
    """Every mode of ``{algo}_packed_*`` at each slot / A-K width, against
    the plain versions (and a diff across two widths)."""
    from repro_torch.core.packing import pack_image

    n = 100 if width == 1 else 3000
    h = _algo_state(algo, n, removed, seed=7) if width > 1 else \
        make_hash(algo, n, capacity=n, variant="32")
    if width == 1:
        for b in np.random.default_rng(7).permutation(n)[: int(removed * n)].tolist():
            if h.working > 1:
                h.remove(int(b))
    dtype = {1: torch.int8, 2: torch.int16, 4: torch.int32}[width]
    img = _narrowed(pack_image(h.device_image()), dtype)
    img.arrays = {k: v.to(dev) for k, v in img.arrays.items()}
    tables, scalars = engine.image_operands(img)
    keys = engine.key_tensor(KEYS[:8000], dev)
    kw = {"table": "packed"}
    before = {k: v for k, v in engine.LAUNCHES.items()}
    out = engine.kernel_lookup(algo, keys, tables, scalars, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, engine.lookup_plain(algo, keys, tables, scalars, **kw))
    assert out[:200].cpu().tolist() == [h.lookup(int(k)) for k in KEYS[:200]]
    load = torch.from_numpy(_load(img, seed=1)).to(dev)
    for k in (1, 2, 3, 8, 9):
        assert torch.equal(engine.kernel_replica(algo, keys, k, tables, scalars, **kw),
                           engine.replica_plain(algo, keys, k, tables, scalars, **kw)), k
        if 2 * k > h.working:
            continue  # too few buckets below the cap: the exhausted walk is tested apart
        assert torch.equal(engine.kernel_replica(algo, keys, k, tables, scalars, load, 3, **kw),
                           engine.replica_plain(algo, keys, k, tables, scalars, load, 3, **kw)), k
    rng = np.random.default_rng(3)
    probe = torch.from_numpy(rng.integers(0, 9, size=keys.numel()).astype(np.int32)).to(dev)
    pending = torch.from_numpy(rng.random(keys.numel()) < 0.6).to(dev)
    for g, w in zip(engine.kernel_walk(algo, keys, probe, pending, tables, scalars, load, 2, **kw),
                    engine.walk_plain(algo, keys, probe, pending, tables, scalars, load, 2, **kw)):
        assert torch.equal(g, w)
    other = pack_image(_algo_state(algo, n, 0.3, seed=8).device_image())  # int16 or int8
    other.arrays = {k: v.to(dev) for k, v in other.arrays.items()}
    old, new = (tables, scalars), engine.image_operands(other)
    for g, w in zip(engine.kernel_diff(algo, keys, old, new, **kw),
                    engine.diff_plain(algo, keys, old, new, **kw)):
        assert torch.equal(g, w)
    for g, w in zip(engine.kernel_replica_diff(algo, keys, 3, old, new, **kw),
                    engine.replica_diff_plain(algo, keys, 3, old, new, **kw)):
        assert torch.equal(g, w)
    torch.cuda.synchronize()
    for mode in ("lookup", "diff", "replica", "replica_diff", "walk"):
        assert engine.LAUNCHES[f"{algo}_packed_{mode}"] > before[f"{algo}_packed_{mode}"]


def test_packed_replica_kernel_at_full_size_and_key_count_edges(dev):
    """``memento_packed_replica`` at n = 10^6, k = 1, 2, 3, 8 and 9,
    unbounded and bounded, against the plain version at key counts around
    a warp and a block, and against the host."""
    from repro_torch.core.packing import pack_image

    n = 10**6
    m = _churned(n, int(0.4 * n), seed=11)
    img = pack_image(m.device_image())
    img.arrays = {k: v.to(dev) for k, v in img.arrays.items()}
    tables, scalars = engine.image_operands(img)
    counts = _edge_counts(dev)
    keys_np = np.random.default_rng(12).integers(0, 2**32, size=max(counts), dtype=np.uint32)
    keys = engine.key_tensor(keys_np, dev)
    load = torch.from_numpy(_load(img, seed=13)).to(dev)
    kw = {"table": "packed"}
    for k in (1, 2, 3, 8, 9):
        for ld, cap in ((None, None), (load, 3)):
            want = engine.replica_plain("memento", keys, k, tables, scalars, ld, cap, **kw)
            for count in counts:
                before = engine.LAUNCHES["memento_packed_replica"]
                out = engine.kernel_replica("memento", keys[:count], k, tables, scalars, ld,
                                            cap, **kw)
                torch.cuda.synchronize()
                assert engine.LAUNCHES["memento_packed_replica"] == before + (count > 0)
                assert torch.equal(out, want[:count]), (k, cap, count)
    assert want[:100].cpu().tolist() == engine.bounded_replica_sets(  # k = 9, bounded
        m, keys_np[:100], 9, load.cpu().numpy(), 3).tolist()
    assert engine.kernel_replica("memento", keys[:100], 3, tables, scalars,
                                 **kw).cpu().tolist() == [m.lookup_k(int(x), 3)
                                                          for x in keys_np[:100]]


def test_exhausted_packed_replica_walk_keeps_the_plain_lookup(dev):
    """k above the working buckets, and every bucket at the cap, on a
    packed image: the lanes run out of salts and keep their plain lookup."""
    from repro_torch.core.packing import pack_image

    m = MementoHash(5, variant="32")
    m.remove(1)
    m.remove(3)
    img = pack_image(m.device_image())
    img.arrays = {k: v.to(dev) for k, v in img.arrays.items()}
    tables, scalars = engine.image_operands(img)
    keys = engine.key_tensor(KEYS[:64], dev)
    kw = {"table": "packed"}
    for k in (5, 9):
        assert torch.equal(engine.kernel_replica("memento", keys, k, tables, scalars, **kw),
                           engine.replica_plain("memento", keys, k, tables, scalars, **kw))
    load = torch.ones(engine.bounded_load_len(img), dtype=torch.int32, device=dev)
    out = engine.kernel_replica("memento", keys, 2, tables, scalars, load, 1, **kw)
    assert torch.equal(out, engine.replica_plain("memento", keys, 2, tables, scalars, load, 1,
                                                 **kw))
    first = engine.kernel_lookup("memento", keys, tables, scalars, **kw)
    assert torch.equal(out, torch.stack([first, first], dim=1))


def _packed_memento(n: int, removed: float, width: int, dev, seed: int = 7):
    """A packed Memento image with ``width``-byte slots on the card, built
    as ``test_packed_kernels_match_plain_and_host`` builds it (int8 by
    narrowing a small image by hand), and its operands."""
    from repro_torch.core.packing import pack_image

    h = MementoHash(n, variant="32")
    for b in np.random.default_rng(seed).permutation(n)[: int(removed * n)].tolist():
        if h.working > 1:
            h.remove(int(b))
    dtype = {1: torch.int8, 2: torch.int16, 4: torch.int32}[width]
    img = _narrowed(pack_image(h.device_image()), dtype)
    img.arrays = {k: v.to(dev) for k, v in img.arrays.items()}
    return h, img, engine.image_operands(img)


def _walk_once(chain, probe, pending, operands, load, cap):
    """One ``memento_packed_walk`` launch, counted, against its plain
    version."""
    before = engine.LAUNCHES["memento_packed_walk"]
    got = engine.kernel_walk("memento", chain, probe, pending, *operands, load, cap,
                             table="packed")
    torch.cuda.synchronize()
    assert engine.LAUNCHES["memento_packed_walk"] == before + (chain.numel() > 0)
    want = engine.walk_plain("memento", chain, probe, pending, *operands, load, cap,
                             table="packed")
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    return got


@pytest.mark.parametrize("pending_share", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("width", [1, 2, 4])
def test_packed_walk_kernel_at_every_width(dev, width, pending_share):
    """``memento_packed_walk`` with no lane, half the lanes and every lane
    pending, probes in nonzero, at caps 1 and 2: equal to the plain
    version, twice over, one launch a call."""
    n = 100 if width == 1 else 3000
    _, img, operands = _packed_memento(n, 0.6, width, dev)
    rng = np.random.default_rng(width)
    keys = engine.key_tensor(KEYS[:8000], dev)
    probe = torch.from_numpy(rng.integers(0, 9, size=keys.numel()).astype(np.int32)).to(dev)
    pending = torch.from_numpy(rng.random(keys.numel()) < pending_share).to(dev)
    load = torch.from_numpy(_load(img, seed=width)).to(dev)
    for cap in (1, 2):
        first = _walk_once(keys, probe, pending, operands, load, cap)
        for g, w in zip(first, _walk_once(keys, probe, pending, operands, load, cap)):
            assert torch.equal(g, w)
        assert torch.equal(first[2][~pending], probe[~pending])


def test_packed_walk_kernel_at_key_count_edges(dev):
    """``memento_packed_walk`` at n = 10^6 (int32 slots) at key counts
    around a warp and a block, one past 1024 keys a SM, and at four times
    the threads the card keeps resident plus 7."""
    from repro_torch.core.packing import pack_image

    m = _churned(10**6, int(0.6 * 10**6), seed=14)
    img = pack_image(m.device_image())
    img.arrays = {k: v.to(dev) for k, v in img.arrays.items()}
    operands = engine.image_operands(img)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    counts = _edge_counts(dev) + [4 * sms * 2048 + 7]
    rng = np.random.default_rng(15)
    keys = engine.key_tensor(rng.integers(0, 2**32, size=max(counts), dtype=np.uint32), dev)
    probe = torch.from_numpy(rng.integers(0, 3, size=keys.numel()).astype(np.int32)).to(dev)
    pending = torch.from_numpy(rng.random(keys.numel()) < 0.5).to(dev)
    load = torch.from_numpy(_load(img, seed=16, high=16)).to(dev)
    for count in counts:
        _walk_once(keys[:count], probe[:count], pending[:count], operands, load, 14)


def test_packed_walk_kernel_stops_every_pending_lane_at_max_probe(dev):
    """Every bucket at the cap: each pending lane walks to max_probe and
    keeps the bucket of its last chain; a lane whose probe starts one below
    max_probe takes one step.  The state holds one bitmap word (n = 20), so
    the load has 32 words and max_probe is 64 * 32 + 64."""
    from repro_torch.core.bounded import walk_probe_bound

    _, img, (tables, scalars) = _packed_memento(20, 0.5, 2, dev)
    tables = [tables[0][:1].contiguous(), *tables[1:]]
    load = torch.full((32,), 3, dtype=torch.int32, device=dev)
    max_probe = walk_probe_bound(32)
    keys = engine.key_tensor(KEYS[:512], dev)
    probe = torch.zeros(keys.numel(), dtype=torch.int32, device=dev)
    probe[::3] = max_probe - 1
    pending = torch.from_numpy(np.arange(keys.numel()) % 4 != 1).to(dev)
    _, _, pr = _walk_once(keys, probe, pending, (tables, scalars), load, 3)
    assert (pr[pending] == max_probe).all() and torch.equal(pr[~pending], probe[~pending])


def _dx_state(ratio: int, seed: int):
    """DxHash of capacity a = 6400 with all but a / ratio buckets removed."""
    a = 6400
    h = make_hash("dx", a, capacity=a, variant="32")
    for b in np.random.default_rng(seed).permutation(a)[: a - a // ratio].tolist():
        h.remove(int(b))
    return h


@pytest.mark.parametrize("ratio", [1, 4, 8, 16, 32, 64, 128, 200])
def test_dx_diff_kernel_for_every_lane_group(dev, ratio):
    """``dx_diff`` between epochs at ⌈a/w⌉ = ``ratio`` and another ratio
    (each with its own probe bound and fallback): one thread a key, or G =
    2 .. 16 lanes a key from the larger bound, equal to its plain version at
    every key count around a group, a warp and a block."""
    other = {1: 4, 4: 1, 8: 1, 16: 8, 32: 8, 64: 16, 128: 2, 200: 64}[ratio]
    old, new = _dx_state(ratio, seed=ratio), _dx_state(other, seed=ratio + 1)
    operands = [_operands(h, dev) for h in (old, new)]
    assert engine.dx_diff_lane_group(operands[0][1][1], operands[1][1][1]) == {
        4: 1, 8: 1, 16: 2, 32: 4, 64: 8, 128: 16, 200: 16}[max(ratio, other)]
    counts = _edge_counts(dev)
    keys_np = np.random.default_rng(ratio).integers(0, 2**32, size=max(counts), dtype=np.uint32)
    keys_np[:5] = [0, 1, 2**31 - 1, 2**31, 2**32 - 1]
    keys = engine.key_tensor(keys_np, dev)
    want = engine.diff_plain("dx", keys, *operands)
    assert want[0][:200].cpu().tolist() == [old.lookup(int(k)) for k in keys_np[:200]]
    assert want[1][:200].cpu().tolist() == [new.lookup(int(k)) for k in keys_np[:200]]
    for count in counts:
        before = engine.LAUNCHES["dx_diff"]
        got = engine.kernel_diff("dx", keys[:count], *operands)
        torch.cuda.synchronize()
        assert engine.LAUNCHES["dx_diff"] == before + (count > 0)
        for g, w in zip(got, want):
            assert torch.equal(g, w[:count]), count


@pytest.mark.parametrize("removed", [0.0, 0.5, 0.9])
def test_compact_lookup_kernel_matches_plain_and_dense(dev, removed):
    m = _churned(20_000, int(removed * 20_000), seed=3)
    repl = m.device_image().arrays["repl"].to(dev)
    slot_b, slot_c = engine.build_compact_table(repl)
    keys = engine.key_tensor(KEYS, dev)
    before = engine.LAUNCHES["memento_compact_lookup"]
    out = engine.compact_lookup(keys, slot_b, slot_c, m.n)
    torch.cuda.synchronize()
    assert engine.LAUNCHES["memento_compact_lookup"] == before + 1
    assert torch.equal(out, engine.lookup_plain("memento", keys, [slot_b, slot_c], [m.n],
                                                table="compact"))
    assert torch.equal(out, engine.memento_lookup(keys, repl, m.n))


@pytest.mark.parametrize("removed", [0.0, 0.5, 0.9])
def test_compact_replica_kernel_matches_plain_and_dense(dev, removed):
    """``memento_compact_replica``, unbounded k = 2, 3 and bounded k = 2,
    against its plain version and the dense replica kernel, and through
    ``engine_lookup(table="compact")``."""
    m = _churned(20_000, int(removed * 20_000), seed=4)
    img = m.device_image()
    img.arrays = {k: v.to(dev) for k, v in img.arrays.items()}
    repl = img.arrays["repl"]
    compact = list(engine.build_compact_table(repl))
    keys = engine.key_tensor(KEYS[:8000], dev)
    load = torch.from_numpy(_load(img, seed=2)).to(dev)
    before = engine.LAUNCHES["memento_compact_replica"]
    for k, ld, cap in ((2, None, None), (3, None, None), (2, load, 3)):
        out = engine.kernel_replica("memento", keys, k, compact, [m.n], ld, cap, table="compact")
        torch.cuda.synchronize()
        assert torch.equal(out, engine.replica_plain("memento", keys, k, compact, [m.n], ld, cap,
                                                     table="compact"))
        assert torch.equal(out, engine.kernel_replica("memento", keys, k, [repl], [m.n], ld, cap))
    got = engine.engine_lookup(keys, img, k=3, table="compact")
    assert torch.equal(got, engine.engine_lookup(keys, img, k=3))
    torch.cuda.synchronize()
    assert engine.LAUNCHES["memento_compact_replica"] == before + 4


def _chain_state(n: int) -> MementoHash:
    """A state with one long chain: bucket 3 is removed first, then its
    replacement n - 1, that one's replacement n - 2 and so on down to
    n/2 + 1; then most of the rest, so that many walks rehash into 3 with
    a small w_b and follow the chain down to n/2."""
    m = MementoHash(n, variant="32")
    m.remove(3)
    for b in range(n - 1, n // 2, -1):
        m.remove(b)
    for b in range(4, n // 2 - 10):
        m.remove(b)
    return m


@pytest.mark.parametrize("state", ["none removed", "90% removed", "long chain"])
@pytest.mark.parametrize("width", [0, 1, 2, 4])
def test_memento_lookups_match_plain_at_block_edges(dev, width, state):
    """``memento_lookup`` (width 0, the dense table) and
    ``memento_packed_lookup`` (1-, 2- and 4-byte slots) against their
    plain versions at key counts around warp and block edges: 0, 1, 31,
    33, 256, 257 and 5000 (prefixes of one key batch, whose plain lookup
    is computed once)."""
    from repro_torch.core.packing import pack_image

    n = 100 if width == 1 else 3000
    m = {"none removed": lambda: MementoHash(n, variant="32"),
         "90% removed": lambda: _churned(n, int(0.9 * n), seed=n),
         "long chain": lambda: _chain_state(n)}[state]()
    if width:
        dtype = {1: torch.int8, 2: torch.int16, 4: torch.int32}[width]
        img = _narrowed(pack_image(m.device_image()), dtype)
        name, kw = "memento_packed_lookup", {"table": "packed"}
    else:
        img, name, kw = m.device_image(), "memento_lookup", {}
    tables, scalars = engine.image_operands(img)
    tables = [t.to(dev) for t in tables]
    counts = [0, 1, 31, 33, 256, 257, 5000]
    keys_np = np.random.default_rng(width).integers(0, 2**32, size=max(counts), dtype=np.uint32)
    keys = engine.key_tensor(keys_np, dev)
    want = engine.lookup_plain("memento", keys, tables, scalars, **kw)
    assert want[:200].cpu().tolist() == [m.lookup(int(k)) for k in keys_np[:200]]
    for count in counts:
        before = engine.LAUNCHES[name]
        out = engine.kernel_lookup("memento", keys[:count], tables, scalars, **kw)
        torch.cuda.synchronize()
        assert engine.LAUNCHES[name] == before + (count > 0)
        assert torch.equal(out, want[:count]), count


def test_packed_dx_jump_power_images_run_their_dense_kernels(dev):
    from repro_torch.core.packing import pack_image

    for algo in [a for a in ALGORITHMS if a not in engine.PACKED_KERNELS]:
        h = _algo_state(algo, 3000, 0.5, seed=4)
        img = pack_image(h.device_image())
        img.arrays = {k: v.to(dev) for k, v in img.arrays.items()}
        before = engine.LAUNCHES[f"{algo}_lookup"]
        out = engine.engine_lookup(KEYS, img, device=dev)
        assert engine.LAUNCHES[f"{algo}_lookup"] == before + 1
        assert out[:300].cpu().tolist() == [h.lookup(int(k)) for k in KEYS[:300]]


@pytest.mark.parametrize("dtype", [torch.int16, torch.int8])
def test_narrow_delta_apply_kernels_match_plain(dev, dtype):
    rng = np.random.default_rng(10)
    base = rng.integers(-2, 100, size=5000).astype(np.int16)
    idx = rng.integers(0, 5000, size=600)
    idx[-100:] = idx[:100]
    vals = rng.integers(-2, 100, size=600).astype(np.int32)
    table = torch.from_numpy(base).to(dtype).to(dev)
    name = da.KERNELS[dtype]
    before = da.LAUNCHES[name]
    out = da.scatter_update(table, idx, vals)
    torch.cuda.synchronize()
    assert da.LAUNCHES[name] == before + 1 and out.dtype == dtype
    want = base.astype(np.int64)
    for i, v in zip(idx.tolist(), vals.tolist()):
        want[i] = v
    assert (out.cpu().numpy() == want).all()
    uidx, uvals = da.dedup_last(idx, vals)
    pidx, pval, k = da._pad_updates(uidx, uvals, sentinel=-1)
    meta = torch.from_numpy(np.concatenate([pidx, pval])).to(dev)
    assert torch.equal(da.delta_apply(table, meta, k), da.delta_apply_plain(table, meta, k))


@pytest.mark.parametrize("sync_mode", ["block", "overlap"])
def test_router_with_compact_images_on_cuda_matches_host(dev, sync_mode):
    """Removals, then restores (tombstones), then removals that probe past
    them: every batch equals the host."""
    router = SessionRouter(2000, compact_images=True, sync_mode=sync_mode, replicas_k=2)
    ids = np.random.default_rng(2).integers(0, 2**63, size=4000, dtype=np.uint64)
    router.route_batch(ids)
    assert router.image_store().image().packed
    for victim in (3, 250, 1999, 17, 800):
        router.fail_replica(victim)
        router.image_store().flush()
    for _ in range(3):
        router.restore_replica()
    router.image_store().flush()
    router.mark_failed(42)
    assert router.route_batch(ids).tolist() == [router.route(int(s)) for s in ids]
    router.fail_replica(42)
    router.image_store().flush()
    assert router.route_batch(ids).tolist() == [router.route(int(s)) for s in ids]
    assert router.image_store().totals.snapshot_rebuilds == 0
    assert (router.image_store()._mirror["slot_b"] == -2).any()


@pytest.mark.parametrize("ratio", [1, 4, 8, 16, 32, 64, 128, 200])
def test_dx_replica_kernel_for_every_lane_group(dev, ratio):
    """``dx_replica`` takes one thread a key (⌈a/w⌉ = 1, 4) or runs a key's
    salted walk on G = 2 .. 32 lanes (⌈a/w⌉ = 8 .. 200), unbounded and
    bounded, k = 1, 2, 3 and 8: equal to its plain version at every key
    count around a group, a warp and a block, and to the host."""
    h = _dx_state(ratio, seed=ratio)
    tables, scalars = _operands(h, dev)
    lanes = {1: 1, 4: 1, 8: 2, 16: 4, 32: 8, 64: 16, 128: 32, 200: 32}[ratio]
    assert engine.dx_replica_lane_group(scalars[1]) == lanes
    counts = _edge_counts(dev)
    keys_np = np.random.default_rng(ratio).integers(0, 2**32, size=max(counts), dtype=np.uint32)
    keys_np[:5] = [0, 1, 2**31 - 1, 2**31, 2**32 - 1]
    keys = engine.key_tensor(keys_np, dev)
    load_np = _load(h.device_image(), seed=ratio)
    load = torch.from_numpy(load_np).to(dev)
    for k in (1, 2, 3, 8):
        for ld, cap in ((None, None), (load, 3)):
            want = engine.replica_plain("dx", keys, k, tables, scalars, ld, cap)
            host = (engine.bounded_replica_sets(h, keys_np[:50], k, load_np, cap).tolist()
                    if ld is not None else [h.lookup_k(int(x), k) for x in keys_np[:50]])
            assert want[:50].cpu().tolist() == host, (k, cap)
            for count in counts:
                before = engine.LAUNCHES["dx_replica"]
                out = engine.kernel_replica("dx", keys[:count], k, tables, scalars, ld, cap)
                torch.cuda.synchronize()
                assert engine.LAUNCHES["dx_replica"] == before + (count > 0)
                assert torch.equal(out, want[:count]), (k, cap, count)


@pytest.mark.parametrize("ratio", [64, 200])
def test_exhausted_dx_replica_group_walk_keeps_the_plain_lookup(dev, ratio):
    """``dx_replica`` on G = 16 and 32 lanes a key (⌈a/w⌉ = 64 and 200,
    w = 10) whose walks run out of salts, where the group fills the rest
    of the row with the key's plain lookup.  Unbounded at k = w + 3: the
    plain walk at k = w takes every working bucket long before the salt
    cap, and no later candidate is new, so the plain row at k = w + 3 is
    that row and then the plain lookup three times.  Bounded with every
    bucket at the cap: no candidate is taken, so the plain row is the
    plain lookup k times."""
    h = make_hash("dx", 10 * ratio, capacity=10 * ratio, variant="32")
    for b in np.random.default_rng(ratio).permutation(10 * ratio)[10:].tolist():
        h.remove(int(b))
    tables, scalars = _operands(h, dev)
    assert engine.dx_replica_lane_group(scalars[1]) == {64: 16, 200: 32}[ratio]
    w = h.working
    keys = engine.key_tensor(KEYS[:33], dev)
    first = engine.lookup_plain("dx", keys, tables, scalars)[:, None]
    full = engine.replica_plain("dx", keys, w, tables, scalars)
    every = torch.tensor(sorted(h.working_set()), dtype=torch.int32, device=dev)
    assert torch.equal(full.sort(dim=1).values, every.expand(len(keys), -1))
    before = engine.LAUNCHES["dx_replica"]
    out = engine.kernel_replica("dx", keys, w + 3, tables, scalars)
    torch.cuda.synchronize()
    assert torch.equal(out, torch.cat([full, first.expand(-1, 3)], dim=1))
    load = torch.ones(engine.bounded_load_len(h.device_image()), dtype=torch.int32,
                      device=dev)
    out = engine.kernel_replica("dx", keys, 3, tables, scalars, load, 1)
    torch.cuda.synchronize()
    assert engine.LAUNCHES["dx_replica"] == before + 2
    assert torch.equal(out, first.expand(-1, 3))


def _memento_pair(pair: str):
    """Two host states of one Memento cluster, old and new: one removal
    inside a churned state (n kept), the last bucket removed from an
    unchurned state (n - 1), a bucket added to an unchurned state (n + 1),
    and 12 working buckets against 4 (n kept), whose walks at k = 9 run out
    of salts in the new epoch only."""
    if pair == "exhausted":
        old = MementoHash(12, variant="32")
        new = MementoHash(12, variant="32")
        for b in (0, 2, 3, 5, 6, 8, 9, 10):
            new.remove(b)
        return old, new
    old = _churned(3000, 1000, seed=1) if pair == "one removal" else MementoHash(3000,
                                                                                  variant="32")
    new = _churned(3000, 1000, seed=1) if pair == "one removal" else MementoHash(3000,
                                                                                  variant="32")
    if pair == "one removal":
        new.remove(sorted(new.working_set())[7])
    elif pair == "last bucket":
        new.remove(new.n - 1)
    else:
        new.add()
    return old, new


@pytest.mark.parametrize("pair", ["one removal", "last bucket", "add", "exhausted"])
@pytest.mark.parametrize("table", ["dense", "packed"])
def test_memento_replica_diff_kernel_walks_both_epochs_on_one_salt_walk(dev, table, pair):
    """``memento_replica_diff`` and ``memento_packed_replica_diff`` for
    pairs of equal and of different n, k = 1, 2, 3 and 9, each way round:
    equal to the plain version and, where no walk runs out of salts, to the
    host.  Packed epochs differ in slot width (int32 against int16; int8
    against int16 for the 12-bucket pair)."""
    from repro_torch.core.packing import pack_image

    hosts = _memento_pair(pair)
    assert (hosts[0].n == hosts[1].n) == (pair in ("one removal", "exhausted"))
    epochs = []
    for h, dtype in zip(hosts, (torch.int8 if pair == "exhausted" else torch.int32,
                                torch.int16)):
        img = h.device_image()
        if table == "packed":
            img = _narrowed(pack_image(img), dtype)
        img.arrays = {k: v.to(dev) for k, v in img.arrays.items()}
        epochs.append(engine.image_operands(img))
    if table == "packed":
        assert [e[0][1].dtype for e in epochs] == [
            torch.int8 if pair == "exhausted" else torch.int32, torch.int16]
    name = engine.kernel_name("memento", "replica_diff", table)
    # the plain walk of an exhausted row runs all 4096 salts: fewer keys there
    keys = engine.key_tensor(KEYS[:1024] if pair == "exhausted" else KEYS, dev)
    for k in (1, 2, 3, 9):
        for (a, b), (ha, hb) in (((0, 1), hosts), ((1, 0), hosts[::-1])):
            before = engine.LAUNCHES[name]
            got = engine.kernel_replica_diff("memento", keys, k, epochs[a], epochs[b],
                                             table=table)
            torch.cuda.synchronize()
            assert engine.LAUNCHES[name] == before + 1
            want = engine.replica_diff_plain("memento", keys, k, epochs[a], epochs[b],
                                             table=table)
            for g, w in zip(got, want):
                assert torch.equal(g, w), (k, a)
            for h, rows in ((ha, got[0]), (hb, got[1])):
                if k <= h.working:
                    assert rows[:100].cpu().tolist() == [h.lookup_k(int(x), k)
                                                         for x in KEYS[:100]], (k, a)
            if pair == "exhausted" and k == 9:  # the 4-bucket epoch kept first past its 4
                few = got[0] if a == 1 else got[1]
                assert torch.equal(few[:, 4:], few[:, :1].expand(-1, 5))


def _host_walk(h, chain: int, probe: int, pending: bool, load, cap: int):
    """The host's chain-walk step of one lane."""
    from repro_torch.core.bounded import walk_probe_bound
    from repro_torch.core.hashing import hash2_32

    b = h.lookup(chain)
    while pending and load[b] >= cap and probe < walk_probe_bound(len(load)):
        probe += 1
        chain = hash2_32(chain, probe)
        b = h.lookup(chain)
    return b, chain, probe


@pytest.mark.parametrize("ratio", [1, 4, 8, 16, 32, 64, 128, 200])
def test_dx_walk_kernel_for_every_lane_group(dev, ratio):
    """``dx_walk`` takes one thread a walk lane (⌈a/w⌉ = 1, 4) or runs a
    lane's step on G = 2 .. 32 lanes (⌈a/w⌉ = 8 .. 200), with no lane, half
    the lanes and every lane pending: at a cap that three buckets in four
    reach, where pending lanes take several steps, and with every bucket at
    the cap, where each pending lane walks to max_probe (from a probe 0 to
    4 below it).  Equal to its plain version at every key count around a
    group, a warp and a block, and on 48 lanes to the host's walk."""
    from repro_torch.core.bounded import walk_probe_bound

    h = _dx_state(ratio, seed=ratio)
    tables, scalars = _operands(h, dev)
    lanes = {1: 1, 4: 1, 8: 2, 16: 4, 32: 8, 64: 16, 128: 32, 200: 32}[ratio]
    assert engine.dx_walk_lane_group(scalars[1]) == lanes
    counts = _edge_counts(dev)
    rng = np.random.default_rng(ratio)
    chain_np = rng.integers(0, 2**32, size=max(counts), dtype=np.uint32)
    chain_np[:5] = [0, 1, 2**31 - 1, 2**31, 2**32 - 1]
    chain = engine.key_tensor(chain_np, dev)
    steps_load = _load(h.device_image(), seed=ratio)
    max_probe = walk_probe_bound(len(steps_load))
    near = max_probe - rng.integers(0, 5, size=len(chain_np))
    for share in (0.0, 0.5, 1.0):
        pending_np = rng.random(len(chain_np)) < share
        for load_np, cap, probe_np in (
                (steps_load, 1, rng.integers(0, 9, size=len(chain_np))),
                (np.full_like(steps_load, 3), 3, near)):
            load = torch.from_numpy(load_np).to(dev)
            probe = torch.from_numpy(probe_np.astype(np.int32)).to(dev)
            pending = torch.from_numpy(pending_np).to(dev)
            want = engine.walk_plain("dx", chain, probe, pending, tables, scalars, load, cap)
            host = [_host_walk(h, int(chain_np[i]), int(probe_np[i]), bool(pending_np[i]),
                               load_np, cap) for i in range(48)]
            got = list(zip(*(w[:48].cpu().tolist() for w in want)))
            assert got == [(b, c - 2**32 if c >= 2**31 else c, p) for b, c, p in host]
            if cap == 3:
                assert (want[2][pending] == max_probe).all()
            elif share:
                assert int((want[2] - probe)[pending].max()) >= 4  # several steps
            for count in counts:
                before = engine.LAUNCHES["dx_walk"]
                out = engine.kernel_walk("dx", chain[:count], probe[:count], pending[:count],
                                         tables, scalars, load, cap)
                torch.cuda.synchronize()
                assert engine.LAUNCHES["dx_walk"] == before + (count > 0)
                for g, w in zip(out, want):
                    assert torch.equal(g, w[:count]), (share, cap, count)


MEMENTO_LAYOUTS = {"dense": None, "int32": torch.int32, "int16": torch.int16,
                   "int8": torch.int8, "compact": None}


def _memento_layout(h: MementoHash, layout: str, dev):
    """``h``'s image on the card in one of ``MEMENTO_LAYOUTS`` (packed with
    its slots cast to the layout's type, or the compact table built from
    the dense one): the image, its operands and the wrappers' ``table``."""
    from repro_torch.core.packing import pack_image

    img = h.device_image()
    if MEMENTO_LAYOUTS[layout] is not None:
        img = _narrowed(pack_image(img), MEMENTO_LAYOUTS[layout])
    img.arrays = {k: v.to(dev) for k, v in img.arrays.items()}
    table = layout if layout in ("dense", "compact") else "packed"
    return img, engine.image_operands(img, table), table


@pytest.mark.parametrize("layout", sorted(MEMENTO_LAYOUTS))
def test_memento_replica_kernel_at_every_layout(dev, layout):
    """``memento_replica``, ``memento_packed_replica`` (int32, int16 and
    int8 slots) and ``memento_compact_replica``, whose walk is one
    instance unbounded and another bounded: k = 1, 2, 3, 4 and 9,
    unbounded and bounded at a cap that half the buckets reach, so that
    salt 0 is rejected for some keys and later salts for most; equal to
    the plain version at every key count around a warp and a block, and
    to the host.  Then salt exhaustion on three working buckets: k = 4, 5
    and 9 keep the plain lookup past the three (the plain walk at k = 3
    takes all three long before the salt cap, and no later candidate is
    new), and with every bucket at the cap every slot keeps it."""
    n = 100 if layout == "int8" else 3000
    h = _churned(n, n // 2, seed=n + len(layout))
    img, (tables, scalars), table = _memento_layout(h, layout, dev)
    name = engine.kernel_name("memento", "replica", table)
    counts = _edge_counts(dev)
    keys_np = np.random.default_rng(n).integers(0, 2**32, size=max(counts), dtype=np.uint32)
    keys_np[:5] = [0, 1, 2**31 - 1, 2**31, 2**32 - 1]
    keys = engine.key_tensor(keys_np, dev)
    load_np = _load(img, seed=n)
    load = torch.from_numpy(load_np).to(dev)
    first_np = engine.lookup_plain("memento", keys, tables, scalars, table=table).cpu().numpy()
    assert 0 < int((load_np[first_np] >= 2).sum()) < len(keys_np)
    for k in (1, 2, 3, 4, 9):
        for ld, cap in ((None, None), (load, 2)):
            want = engine.replica_plain("memento", keys, k, tables, scalars, ld, cap, table=table)
            if ld is None:
                host = [h.lookup_k(int(x), k) for x in keys_np[:50]]
            else:
                host = engine.bounded_replica_sets(h, keys_np[:50], k, load_np, cap).tolist()
            assert want[:50].cpu().tolist() == host, (k, cap)
            for count in counts:
                before = engine.LAUNCHES[name]
                out = engine.kernel_replica("memento", keys[:count], k, tables, scalars, ld, cap,
                                            table=table)
                torch.cuda.synchronize()
                assert engine.LAUNCHES[name] == before + (count > 0)
                assert torch.equal(out, want[:count]), (k, cap, count)
    few = MementoHash(5, variant="32")
    few.remove(1)
    few.remove(3)
    img, (tables, scalars), table = _memento_layout(few, layout, dev)
    keys = engine.key_tensor(KEYS[:64], dev)
    first = engine.lookup_plain("memento", keys, tables, scalars, table=table)[:, None]
    every = engine.replica_plain("memento", keys, 3, tables, scalars, table=table)
    assert torch.equal(every.sort(dim=1).values,
                       torch.tensor([0, 2, 4], dtype=torch.int32, device=dev).expand(64, -1))
    for k in (4, 5, 9):
        out = engine.kernel_replica("memento", keys, k, tables, scalars, table=table)
        torch.cuda.synchronize()
        assert torch.equal(out, torch.cat([every, first.expand(-1, k - 3)], dim=1)), k
    full = torch.ones(engine.bounded_load_len(img), dtype=torch.int32, device=dev)
    for k in (1, 2, 3):
        out = engine.kernel_replica("memento", keys, k, tables, scalars, full, 1, table=table)
        torch.cuda.synchronize()
        assert torch.equal(out, first.expand(-1, k)), k


def _anchor_run(a: int, ratio: int, removal: str, seed: int):
    """AnchorHash of capacity ``a``, all working at first, brought down to
    ``a // ratio`` working buckets (at least three) by removals of random
    buckets, or by a LIFO run: the working list's head first, then each
    removal takes the bucket that replaced the last one removed (the list's
    tail), so that K chains grow as long as the run."""
    h = make_hash("anchor", a, capacity=a, variant="32")
    victims = np.random.default_rng(seed).permutation(a).tolist()
    b = None
    while h.working > max(3, a // ratio):
        if removal == "random":
            b = int(victims.pop())
        elif b is None or not h.is_working(h.K[b]):  # start a run
            b = int(h.W[0])
        else:
            b = int(h.K[b])
        h.remove(b)
    return h


ANCHOR_LAYOUTS = {"dense": None, "int32": torch.int32, "int16": torch.int16,
                  "int8": torch.int8}


def _anchor_layout(h, layout: str, dev):
    """``h``'s image on the card in one of ``ANCHOR_LAYOUTS`` (packed with
    A/K cast to the layout's type): its operands and the wrappers' table."""
    from repro_torch.core.packing import pack_image

    img = h.device_image()
    if ANCHOR_LAYOUTS[layout] is not None:
        img = _narrowed(pack_image(img), ANCHOR_LAYOUTS[layout])
    img.arrays = {k: v.to(dev) for k, v in img.arrays.items()}
    table = "dense" if layout == "dense" else "packed"
    return engine.image_operands(img, table), table


@pytest.mark.parametrize("removal", ["random", "LIFO run"])
@pytest.mark.parametrize("ratio", [1, 4, 40, 400])
@pytest.mark.parametrize("layout", sorted(ANCHOR_LAYOUTS))
def test_anchor_kernels_at_every_chain_length(dev, layout, ratio, removal):
    """``anchor_one``, the body of every AnchorHash entry, through
    ``anchor_lookup``, ``_diff`` both ways and ``_replica`` k = 3, dense and
    packed at every width, at a/w = 1, 4, 40 and 400 (a = 4000; a = 120 at int8, where a/w
    stops at 40, three buckets for the replica set), after random removals
    or a LIFO run (long K chains): equal to the plain versions, 100 keys to
    the host, one launch each.  The diff's other epoch is one removal
    later."""
    a = 120 if layout == "int8" else 4000
    h = _anchor_run(a, ratio, removal, seed=ratio)
    other = _anchor_run(a, ratio, removal, seed=ratio)
    other.remove(sorted(other.working_set())[0])
    (tables, scalars), table = _anchor_layout(h, layout, dev)
    epochs = (tables, scalars), _anchor_layout(other, layout, dev)[0]
    keys = engine.key_tensor(KEYS[:4000], dev)
    if removal == "LIFO run" and ratio >= 40:  # the run's chains are long
        work: dict = {}
        engine.lookup_plain("anchor", keys, tables, scalars, work, table=table)
        assert work["read"] > 5 * keys.numel()
    calls = {
        "lookup": (lambda: engine.kernel_lookup("anchor", keys, tables, scalars, table=table),
                   lambda: engine.lookup_plain("anchor", keys, tables, scalars, table=table)),
        "replica": (lambda: engine.kernel_replica("anchor", keys, 3, tables, scalars,
                                                  table=table),
                    lambda: engine.replica_plain("anchor", keys, 3, tables, scalars,
                                                 table=table)),
    }
    for mode, (kernel, plain) in calls.items():
        name = engine.kernel_name("anchor", mode, table)
        before = engine.LAUNCHES[name]
        out = kernel()
        torch.cuda.synchronize()
        assert engine.LAUNCHES[name] == before + 1
        assert torch.equal(out, plain()), mode
        if mode == "lookup":
            assert out[:100].cpu().tolist() == [h.lookup(int(k)) for k in KEYS[:100]]
        else:
            assert out[:100].cpu().tolist() == [h.lookup_k(int(k), 3) for k in KEYS[:100]]
    name = engine.kernel_name("anchor", "diff", table)
    for old, new in (epochs, epochs[::-1]):
        before = engine.LAUNCHES[name]
        got = engine.kernel_diff("anchor", keys, old, new, table=table)
        torch.cuda.synchronize()
        assert engine.LAUNCHES[name] == before + 1
        for g, w in zip(got, engine.diff_plain("anchor", keys, old, new, table=table)):
            assert torch.equal(g, w)


def _memento_diff_pair(pair: str, n: int):
    """Two host states of one Memento cluster of n buckets, old and new:
    one removal inside a churned state and a one-shot removal of 90 % (n
    kept: one jump32 serves both epochs), the last bucket removed (n - 1)
    and a bucket added (n + 1)."""
    if pair == "one-shot":
        return MementoHash(n, variant="32"), _churned(n, int(0.9 * n), seed=3)
    churned = pair == "one removal"
    old, new = ((_churned(n, n // 3, seed=1) if churned else MementoHash(n, variant="32"))
                for _ in range(2))
    if churned:
        new.remove(new.lookup(int(KEYS[0])))  # a key moves
    elif pair == "last bucket":
        new.remove(n - 1)
    else:
        new.add()
    return old, new


@pytest.mark.parametrize("pair", ["one removal", "one-shot", "last bucket", "add"])
@pytest.mark.parametrize("layout", ["dense", "int32 -> int16", "int8 -> int16"])
def test_memento_diff_kernels_of_equal_and_different_n(dev, layout, pair):
    """``memento_diff`` and ``memento_packed_diff``, whose epochs of one n
    share each key's jump32 (and of two n run one after the other), each way
    round, packed epochs of two slot widths: equal to the plain version at
    key counts 0, 1, 33 and 257 and over 4000 keys, 100 keys to the host,
    one launch a call with keys."""
    n = 100 if layout == "int8 -> int16" else 3000
    hosts = _memento_diff_pair(pair, n)
    assert (hosts[0].n == hosts[1].n) == (pair in ("one removal", "one-shot"))
    epochs = []
    for h, width in zip(hosts, layout.split(" -> ") if layout != "dense" else ("dense",) * 2):
        epochs.append(_memento_layout(h, width, dev)[1])
    table = "dense" if layout == "dense" else "packed"
    name = engine.kernel_name("memento", "diff", table)
    keys = engine.key_tensor(KEYS[:4000], dev)
    for (a, b), (ha, hb) in (((0, 1), hosts), ((1, 0), hosts[::-1])):
        want = engine.diff_plain("memento", keys, epochs[a], epochs[b], table=table)
        assert want[0][:100].cpu().tolist() == [ha.lookup(int(k)) for k in KEYS[:100]]
        assert want[1][:100].cpu().tolist() == [hb.lookup(int(k)) for k in KEYS[:100]]
        if pair in ("one removal", "one-shot"):
            assert want[2].any()
        for count in (0, 1, 33, 257, keys.numel()):
            before = engine.LAUNCHES[name]
            got = engine.kernel_diff("memento", keys[:count], epochs[a], epochs[b],
                                     table=table)
            torch.cuda.synchronize()
            assert engine.LAUNCHES[name] == before + (count > 0)
            for g, w in zip(got, want):
                assert torch.equal(g, w[:count]), (count, a)


def _clustered_compact(window: int, dev):
    """A Memento state of 3000 buckets whose compact table (128 slots) has
    one long cluster: 45 removed buckets whose probes start in slots
    ``window`` .. ``window + 5`` and 15 others.  The cluster runs far past 8
    slots and, from window 122, wraps past the last slot to slot 0.
    Returns the host state, its dense image on the card and the compact
    table."""
    from repro_torch.core.packing import _probe_start

    n = 3000
    near = [b for b in range(n) if window <= _probe_start(b, 127) < window + 6][:45]
    rest = [b for b in np.random.default_rng(window).permutation(n).tolist()
            if b not in near][:15]
    m = MementoHash(n, variant="32")
    for b in np.random.default_rng(window + 1).permutation(near + rest).tolist():
        m.remove(int(b))
    img = m.device_image()
    img.arrays = {k: v.to(dev) for k, v in img.arrays.items()}
    compact = list(engine.build_compact_table(img.arrays["repl"]))
    assert compact[0].numel() == 128
    return m, img, compact


@pytest.mark.parametrize("window", [0, 61, 122])
def test_compact_kernels_read_long_and_wrapping_clusters(dev, window):
    """``memento_compact_lookup`` and ``memento_compact_replica`` (k = 2, 3
    and bounded k = 2) on hand-built tables whose cluster runs past 8 slots
    and (window 122) wraps past the last slot to slot 0, so that probes
    cross every alignment of slots: equal to the plain version, the dense
    kernels and the host."""
    m, img, compact = _clustered_compact(window, dev)
    taken = (compact[0] >= 0).cpu().numpy()
    run, longest = 0, 0
    for s in range(window, window + 128):
        run = run + 1 if taken[s % 128] else 0
        longest = max(longest, run)
    assert longest > 8
    if window == 122:
        assert taken[127] and taken[0]
    repl = img.arrays["repl"]
    keys_np = np.random.default_rng(window).integers(0, 2**32, size=20_000, dtype=np.uint32)
    keys = engine.key_tensor(keys_np, dev)
    out = engine.compact_lookup(keys, *compact, m.n)
    torch.cuda.synchronize()
    assert torch.equal(out, engine.lookup_plain("memento", keys, compact, [m.n], table="compact"))
    assert torch.equal(out, engine.memento_lookup(keys, repl, m.n))
    assert out[:200].cpu().tolist() == [m.lookup(int(k)) for k in keys_np[:200]]
    load = torch.from_numpy(_load(img, seed=window)).to(dev)
    for k, ld, cap in ((2, None, None), (3, None, None), (2, load, 3)):
        got = engine.kernel_replica("memento", keys, k, compact, [m.n], ld, cap, table="compact")
        torch.cuda.synchronize()
        assert torch.equal(got, engine.replica_plain("memento", keys, k, compact, [m.n], ld, cap,
                                                     table="compact")), (k, cap)
        assert torch.equal(got, engine.kernel_replica("memento", keys, k, [repl], [m.n], ld, cap))
    assert got[:50].cpu().tolist() == engine.bounded_replica_sets(
        m, keys_np[:50], 2, load.cpu().numpy(), 3).tolist()


def _dx_pair(ratios, capacities=(6400, 6400), seed: int = 0):
    """Two DxHash states: of capacity ``capacities[e]`` with all but a /
    ``ratios[e]`` buckets removed."""
    hosts = []
    for e, (a, ratio) in enumerate(zip(capacities, ratios)):
        h = make_hash("dx", a, capacity=a, variant="32")
        for b in np.random.default_rng(seed + e).permutation(a)[: a - a // ratio].tolist():
            h.remove(int(b))
        hosts.append(h)
    return hosts


@pytest.mark.parametrize("pair", ["stable -> 4", "stable -> 8", "stable -> 40", "40 -> 128",
                                  "128 -> 8", "two capacities", "uneven bounds"])
def test_dx_replica_diff_kernel_at_every_lane_group(dev, pair):
    """``dx_replica_diff`` between epochs at ⌈a/w⌉ = 1, 4, 8, 40 and 128:
    one thread a key for both epochs while the epoch with more probes
    takes ``dx_replica`` fewer than 8 lanes, else each epoch's rows at its
    own G (1, 2, 8 or 32) and a pass that compares them; two images of
    different capacities, and probe bounds that are no multiple of G (2563
    and 37, G = 8 and 1): k = 2 and 3, each way round, equal to its plain
    version at every key count around a group, a warp and a block, and 50
    keys to the host."""
    ratios, caps = {"stable -> 4": ((1, 4), (6400, 6400)), "stable -> 8": ((1, 8), (6400, 6400)),
                    "stable -> 40": ((1, 40), (6400, 6400)), "40 -> 128": ((40, 128), (6400, 6400)),
                    "128 -> 8": ((128, 8), (6400, 6400)),
                    "two capacities": ((4, 40), (6400, 4000)),
                    "uneven bounds": ((40, 40), (6400, 6400))}[pair]
    hosts = _dx_pair(ratios, caps)
    epochs = [_operands(h, dev) for h in hosts]
    if pair == "uneven bounds":  # the plain version takes any bound; the fallback stays
        epochs = [(t, [sc[0], bound, sc[2]]) for (t, sc), bound in zip(epochs, (2563, 37))]
    lanes = {"stable -> 4": [1, 1], "stable -> 8": [1, 2], "stable -> 40": [1, 8],
             "40 -> 128": [8, 32], "128 -> 8": [32, 2], "two capacities": [1, 8],
             "uneven bounds": [8, 1]}[pair]
    assert [engine.dx_replica_lane_group(sc[1]) for _, sc in epochs] == lanes
    split = max(lanes) if max(lanes) >= 8 else 1
    assert engine.dx_replica_diff_lane_group(epochs[0][1][1], epochs[1][1][1]) == split
    counts = _edge_counts(dev)
    keys_np = np.random.default_rng(len(pair)).integers(0, 2**32, size=max(counts),
                                                         dtype=np.uint32)
    keys_np[:5] = [0, 1, 2**31 - 1, 2**31, 2**32 - 1]
    keys = engine.key_tensor(keys_np, dev)
    for (a, b) in ((0, 1), (1, 0)):
        for k in (2, 3):
            want = engine.replica_diff_plain("dx", keys, k, epochs[a], epochs[b])
            if pair != "uneven bounds":
                assert want[0][:50].cpu().tolist() == [hosts[a].lookup_k(int(x), k)
                                                       for x in keys_np[:50]]
                assert want[1][:50].cpu().tolist() == [hosts[b].lookup_k(int(x), k)
                                                       for x in keys_np[:50]]
            assert want[2].any()
            for count in counts:
                before = engine.LAUNCHES["dx_replica_diff"]
                got = engine.kernel_replica_diff("dx", keys[:count], k, epochs[a], epochs[b])
                torch.cuda.synchronize()
                assert engine.LAUNCHES["dx_replica_diff"] == before + (count > 0)
                for g, w in zip(got, want):
                    assert torch.equal(g, w[:count]), (a, k, count)


def test_exhausted_dx_replica_diff_group_walk_keeps_the_plain_lookup(dev):
    """``dx_replica_diff`` with each epoch's rows on G = 16 lanes a key
    (⌈a/w⌉ = 64, w = 10 and 9, one removal apart) at k = 13, whose rows run
    out of salts, where the group fills the rest of each row with the key's
    plain lookup.  The
    plain walk at k = w takes every working bucket long before the salt
    cap, and no later candidate is new, so each plain row at k = 13 is that
    row and then the plain lookup (a plain run to the salt cap would take
    hours on the card)."""
    h = make_hash("dx", 640, capacity=640, variant="32")
    for b in np.random.default_rng(64).permutation(640)[10:].tolist():
        h.remove(int(b))
    old, every_old = _operands(h, dev), sorted(h.working_set())
    h.remove(every_old[0])
    new, every_new = _operands(h, dev), sorted(h.working_set())
    assert engine.dx_replica_diff_lane_group(old[1][1], new[1][1]) == 16
    keys = engine.key_tensor(KEYS[:33], dev)
    rows = []
    for (tables, scalars), every in ((old, every_old), (new, every_new)):
        first = engine.lookup_plain("dx", keys, tables, scalars)[:, None]
        full = engine.replica_plain("dx", keys, len(every), tables, scalars)
        every = torch.tensor(every, dtype=torch.int32, device=dev)
        assert torch.equal(full.sort(dim=1).values, every.expand(len(keys), -1))
        rows.append(torch.cat([full, first.expand(-1, 13 - len(every))], dim=1))
    before = engine.LAUNCHES["dx_replica_diff"]
    got = engine.kernel_replica_diff("dx", keys, 13, old, new)
    torch.cuda.synchronize()
    assert engine.LAUNCHES["dx_replica_diff"] == before + 1
    assert torch.equal(got[0], rows[0]) and torch.equal(got[1], rows[1])
    assert torch.equal(got[2], (rows[0] != rows[1]).any(dim=1))


@pytest.mark.parametrize("pending", ["10 %", "60 %", "every lane", "one lane a warp"])
def test_memento_walk_kernel_at_every_pending_share_and_near_max_probe(dev, pending):
    """``memento_walk`` with 10 % or 60 % of the lanes pending, every lane,
    or one lane in each warp: at cap 1 on a load that 15 buckets in 16
    reach, where some lanes walk more than 32 steps, and with every bucket
    at the cap from probes 1 to 3 below max_probe, where every pending lane
    walks to the bound (one open lane a warp, or the whole warp).  Equal to
    its plain version at key counts 1, 31, 33 and 1000, one launch a call,
    and on 48 lanes to the host's walk."""
    from repro_torch.core.bounded import walk_probe_bound

    m = _churned(3000, 1500, seed=21)
    img = m.device_image()
    img.arrays = {k: v.to(dev) for k, v in img.arrays.items()}
    tables, scalars = engine.image_operands(img)
    rng = np.random.default_rng(22)
    chain_np = rng.integers(0, 2**32, size=1000, dtype=np.uint32)
    chain_np[:5] = [0, 1, 2**31 - 1, 2**31, 2**32 - 1]
    chain = engine.key_tensor(chain_np, dev)
    share = {"10 %": 0.1, "60 %": 0.6, "every lane": 1.0}
    pending_np = (rng.random(1000) < share[pending] if pending in share
                  else np.arange(1000) % 32 == 7)
    pending_t = torch.from_numpy(pending_np).to(dev)
    steps_load = _load(img, seed=23, high=16)
    max_probe = walk_probe_bound(len(steps_load))
    for load_np, cap, probe_np in (
            (steps_load, 1, rng.integers(0, 9, size=1000)),
            (np.full_like(steps_load, 3), 3, max_probe - rng.integers(1, 4, size=1000))):
        load = torch.from_numpy(load_np).to(dev)
        probe = torch.from_numpy(probe_np.astype(np.int32)).to(dev)
        want = engine.walk_plain("memento", chain, probe, pending_t, tables, scalars, load, cap)
        host = [_host_walk(m, int(chain_np[i]), int(probe_np[i]), bool(pending_np[i]),
                           load_np, cap) for i in range(48)]
        got = list(zip(*(w[:48].cpu().tolist() for w in want)))
        assert got == [(b, c - 2**32 if c >= 2**31 else c, p) for b, c, p in host]
        if cap == 3:
            assert (want[2][pending_t] == max_probe).all()
        else:
            assert int((want[2] - probe)[pending_t].max()) > 32
        for count in (1, 31, 33, 1000):
            before = engine.LAUNCHES["memento_walk"]
            out = engine.kernel_walk("memento", chain[:count], probe[:count],
                                     pending_t[:count], tables, scalars, load, cap)
            torch.cuda.synchronize()
            assert engine.LAUNCHES["memento_walk"] == before + 1
            for g, w in zip(out, want):
                assert torch.equal(g, w[:count]), (cap, count)


@pytest.mark.parametrize("bounded", [False, True])
@pytest.mark.parametrize("state", ["a/w = 40", "w = 3"])
def test_anchor_replica_kernel_at_every_k_and_few_buckets(dev, state, bounded):
    """``anchor_replica`` at k = 1 to 5, unbounded and bounded (a cap that
    half the buckets reach), at a/w = 40 (a = 4000) and with 3 of 400
    buckets working, where salts collide and rows run out of salts.  Equal
    to its plain version at key counts 1, 31 and 33 (and 2000 at a/w = 40),
    one launch a call, and 20 keys to the host where its salts do not run
    out."""
    h = _anchor_run(400, 400, "random", seed=3) if state == "w = 3" else \
        _anchor_run(4000, 40, "random", seed=40)
    img = h.device_image()
    img.arrays = {k: v.to(dev) for k, v in img.arrays.items()}
    tables, scalars = engine.image_operands(img)
    load = torch.from_numpy(_load(img, seed=24)).to(dev) if bounded else None
    cap = 2 if bounded else None
    counts = (1, 31, 33) if state == "w = 3" else (1, 31, 33, 2000)
    keys = engine.key_tensor(KEYS[:max(counts)], dev)
    for k in range(1, 6):
        want = engine.replica_plain("anchor", keys, k, tables, scalars, load, cap)
        if bounded and state == "a/w = 40":
            host = engine.bounded_replica_sets(h, KEYS[:20], k, load.cpu().numpy(), cap)
            assert want[:20].cpu().tolist() == host.tolist()
        elif not bounded and k <= h.working:  # the host raises where salts run out
            assert want[:20].cpu().tolist() == [h.lookup_k(int(x), k) for x in KEYS[:20]]
        for count in counts:
            before = engine.LAUNCHES["anchor_replica"]
            out = engine.kernel_replica("anchor", keys[:count], k, tables, scalars, load, cap)
            torch.cuda.synchronize()
            assert engine.LAUNCHES["anchor_replica"] == before + 1
            assert torch.equal(out, want[:count]), (k, count)


@pytest.mark.parametrize("pending", ["10 %", "60 %", "every lane", "one lane a warp"])
def test_jump_walk_kernel_at_every_pending_share_and_near_max_probe(dev, pending):
    """``jump_walk`` with 10 % or 60 % of the lanes pending, every lane, or
    one lane in each warp: at cap 1 on a load that 15 buckets in 16 reach,
    where some lanes walk more than 32 steps, and on that load from probes
    1 to 3 below max_probe, where some lanes stop at the bound and others
    below it, and with every bucket at the cap from there, where every
    pending lane walks to the bound.  Equal to its plain version at key
    counts 1, 31, 33 and 1000, one launch a call, and on 48 lanes to the
    host's walk."""
    from repro_torch.core.bounded import walk_probe_bound

    h = _algo_state("jump", 3000, 0.5, seed=25)
    img = h.device_image()
    img.arrays = {k: v.to(dev) for k, v in img.arrays.items()}
    tables, scalars = engine.image_operands(img)
    rng = np.random.default_rng(26)
    chain_np = rng.integers(0, 2**32, size=1000, dtype=np.uint32)
    chain_np[:5] = [0, 1, 2**31 - 1, 2**31, 2**32 - 1]
    chain = engine.key_tensor(chain_np, dev)
    share = {"10 %": 0.1, "60 %": 0.6, "every lane": 1.0}
    pending_np = (rng.random(1000) < share[pending] if pending in share
                  else np.arange(1000) % 32 == 7)
    pending_t = torch.from_numpy(pending_np).to(dev)
    steps_load = _load(img, seed=28, high=16)
    max_probe = walk_probe_bound(len(steps_load))
    for load_np, cap, probe_np in (
            (steps_load, 1, rng.integers(0, 9, size=1000)),
            (steps_load, 1, max_probe - rng.integers(1, 4, size=1000)),
            (np.full_like(steps_load, 3), 3, max_probe - rng.integers(1, 4, size=1000))):
        load = torch.from_numpy(load_np).to(dev)
        probe = torch.from_numpy(probe_np.astype(np.int32)).to(dev)
        want = engine.walk_plain("jump", chain, probe, pending_t, tables, scalars, load, cap)
        host = [_host_walk(h, int(chain_np[i]), int(probe_np[i]), bool(pending_np[i]),
                           load_np, cap) for i in range(48)]
        got = list(zip(*(w[:48].cpu().tolist() for w in want)))
        assert got == [(b, c - 2**32 if c >= 2**31 else c, p) for b, c, p in host]
        if cap == 3:
            assert (want[2][pending_t] == max_probe).all()
        elif int(probe.min()) > 8:
            assert (want[2][pending_t] == max_probe).any()
            assert (want[2][pending_t] < max_probe).any()
        else:
            assert int((want[2] - probe)[pending_t].max()) > 32
        for count in (1, 31, 33, 1000):
            before = engine.LAUNCHES["jump_walk"]
            out = engine.kernel_walk("jump", chain[:count], probe[:count],
                                     pending_t[:count], tables, scalars, load, cap)
            torch.cuda.synchronize()
            assert engine.LAUNCHES["jump_walk"] == before + 1
            for g, w in zip(out, want):
                assert torch.equal(g, w[:count]), (cap, count)


def _apply_lengths(dtype) -> list[int]:
    """Table lengths at either form's edges: 1, 127, 128 and one below, at
    and above the longest one-block table (and the path's 2·10^6 int32
    words)."""
    top = da.ONE_BLOCK_MAX[dtype]
    return [1, 127, 128, top - 1, top, top + 1] + ([2_000_000] if dtype == torch.int32 else [])


@pytest.mark.parametrize("dtype", [torch.int32, torch.int16, torch.int8])
def test_delta_apply_kernels_at_both_forms_edges(dev, dtype):
    """Each width's delta apply at lengths around the longest table it
    copies in one block (:func:`_apply_lengths`), and at the longest one
    starting one element into its buffer (not 16-byte aligned): no update,
    updates at the first and last index among random ones with -1 padding,
    and indices at and past the table's end, which never write.  Equal to
    the plain version and to an in-order host apply, the input left
    unchanged, one launch a call."""
    name = da.KERNELS[dtype]
    info = torch.iinfo(dtype)
    top = da.ONE_BLOCK_MAX[dtype]
    for length, offset in [(n, 0) for n in _apply_lengths(dtype)] + [(top, 1)]:
        rng = np.random.default_rng(length + offset)
        base = rng.integers(info.min, info.max, size=length, endpoint=True)
        table = torch.from_numpy(np.concatenate([base[:offset], base])).to(dtype).to(dev)[offset:]
        picks = rng.choice(length, size=min(length, 9), replace=False)
        idx = np.unique(np.concatenate([[0, length - 1], picks]))
        vals = rng.integers(info.min, info.max, size=len(idx), endpoint=True)
        for upd_idx, upd_vals in ((idx[:0], vals[:0]), (idx, vals),
                                  (np.append(idx, [length, length + 7]),
                                   np.append(vals, [1, 2]))):
            pidx, pval, count = da._pad_updates(upd_idx, upd_vals, sentinel=-1)
            assert (pidx[count:] == -1).all()
            meta = torch.from_numpy(np.concatenate([pidx, pval])).to(dev)
            before = da.LAUNCHES[name]
            out = da.delta_apply(table, meta, count)
            torch.cuda.synchronize()
            assert da.LAUNCHES[name] == before + 1
            want = base.copy()
            for i, v in zip(upd_idx.tolist(), upd_vals.tolist()):
                if i < length:
                    want[i] = v
            assert torch.equal(out, da.delta_apply_plain(table, meta, count)), (length, count)
            assert (out.cpu().numpy().astype(np.int64) == want).all(), (length, count)
            assert (table.cpu().numpy().astype(np.int64) == base).all()


POWER_KEYS = np.concatenate([
    np.asarray([0, 1, 2**31 - 1, 2**31, 2**32 - 1], np.uint32),
    np.random.default_rng(31).integers(0, 2**32, size=2**16, dtype=np.uint32)])
POWER_COUNTS = (1, 31, 33, 1000, 2**16 + 5)
#: n = 1, 2, 3 and each side of the top level's band edges 2^7, 2^16, 2^20
POWER_NS = [1, 2, 3] + [2**k + d for k in (7, 16, 20) for d in (-1, 0, 1)]
#: power_diff's epoch pairs: one top level (n_old = n_new among them), one
#: band edge crossed, and several
POWER_PAIRS = {
    "equal level": [(10**6, 10**6 - 1), (10**5, 10**5 - 1), (1000, 600), (600, 1000),
                    (1000, 1000), (2, 1), (1, 1), (2**20 + 1, 2**21)],
    "one band edge": [(2**17 + 1, 2**17), (2**16, 2**16 + 1), (3, 2)],
    "several band edges": [(10**6, 10**5), (2**20 + 1, 3), (5, 2**16 - 1)],
}


def _power_host(n: int, keys: torch.Tensor) -> torch.Tensor:
    """``power32`` of ``keys`` at ``n`` on the host (the plain version on
    CPU tensors)."""
    from repro_torch.kernels.primitives import as_u32, power32

    return power32(as_u32(keys.cpu()), n).to(torch.int32)


@pytest.mark.parametrize("n", POWER_NS)
def test_power_lookup_kernel_at_band_edges_and_key_counts(dev, n):
    """``power_lookup`` at n = 1, 2, 3 and on each side of the band edges
    2^7, 2^16, 2^20 (where the top level L changes), at key counts 1, 31, 33
    (a partial warp), 1000 and 2^16 + 5: one launch a call, equal to its
    plain version on the card, to ``power32`` on the host and, on 64 keys,
    to the host's lookup."""
    h = make_hash("power", n, variant="32")
    tables, scalars = _operands(h, dev)
    keys = engine.key_tensor(POWER_KEYS, dev)
    want = _power_host(n, keys)
    assert torch.equal(engine.lookup_plain("power", keys, tables, scalars).cpu(), want)
    assert want[:64].tolist() == [h.lookup(int(k)) for k in POWER_KEYS[:64]]
    for count in POWER_COUNTS:
        before = engine.LAUNCHES["power_lookup"]
        out = engine.kernel_lookup("power", keys[:count], tables, scalars)
        torch.cuda.synchronize()
        assert engine.LAUNCHES["power_lookup"] == before + 1
        assert torch.equal(out.cpu(), want[:count]), count


@pytest.mark.parametrize("kind, pair", [(kind, pair) for kind, pairs in POWER_PAIRS.items()
                                        for pair in pairs])
def test_power_diff_kernel_at_equal_and_crossing_levels(dev, kind, pair):
    """``power_diff`` of two epochs of one top level (the pair kernel: one
    draw sequence and one descent for both), across one band edge and
    across several, at key counts 1, 31, 33, 1000 and 2^16 + 5: one launch
    a call, equal to its plain version on the card and to each epoch's
    ``power32`` on the host."""
    n_old, n_new = pair
    old = _operands(make_hash("power", n_old, variant="32"), dev)
    new = _operands(make_hash("power", n_new, variant="32"), dev)
    keys = engine.key_tensor(POWER_KEYS, dev)
    o, w = _power_host(n_old, keys), _power_host(n_new, keys)
    plain = engine.diff_plain("power", keys, old, new)
    for got, want in zip(plain, (o, w, o != w)):
        assert torch.equal(got.cpu(), want)
    for count in POWER_COUNTS:
        before = engine.LAUNCHES["power_diff"]
        got = engine.kernel_diff("power", keys[:count], old, new)
        torch.cuda.synchronize()
        assert engine.LAUNCHES["power_diff"] == before + 1
        for g, want in zip(got, (o, w, o != w)):
            assert torch.equal(g.cpu(), want[:count]), (kind, count)
    if n_old == n_new:
        assert not (o != w).any()


def _anchor_nest_pair(a: int, w_shallow: int, w_deep: int, pair: str, seed: int):
    """Two epochs of one AnchorHash of capacity ``a`` on the host, (old,
    new): "remove", w_shallow working, then random removals down to w_deep;
    "restore", the same two states the other way round; "diverge", w_deep
    working with one more bucket x removed, then x restored and another
    bucket y removed (stacks that part after a common prefix)."""
    h = make_hash("anchor", a, capacity=a, variant="32")
    rng = np.random.default_rng(seed)
    victims = rng.permutation(a).tolist()

    def remove_to(w):
        while h.working > w:
            b = int(victims.pop())
            if h.is_working(b):
                h.remove(b)

    if pair == "diverge":
        remove_to(w_deep)
        h.remove(int(rng.choice(sorted(h.working_set()))))
        old = h.device_image()
        h.add()
        h.remove(int(rng.choice(sorted(h.working_set()))))
        return old, h.device_image()
    remove_to(w_shallow)
    shallow = h.device_image()
    remove_to(w_deep)
    deep = h.device_image()
    return (shallow, deep) if pair == "remove" else (deep, shallow)


@pytest.mark.parametrize("count", [1, 255, 257, 4001])
@pytest.mark.parametrize("pair", ["remove", "restore", "diverge"])
@pytest.mark.parametrize("ratio", [1, 4, 40, 400])
def test_anchor_replica_diff_takes_its_branch_and_matches_plain(dev, ratio, pair, count):
    """``anchor_replica_diff`` (its check, then the pair kernel) at a/w = 1,
    4, 40 and 400 (a = 4000, a/w of the deeper epoch, one removal at a/w = 1;
    the shallower epoch at twice its working count, at most a): epochs that
    nest take one walk
    through the deeper epoch's tables, the older one the shallower
    ("remove") or the newer ("restore"); stacks that part ("diverge") take
    each epoch's replica_row.  The check's verdict equals the plain check,
    the result ``replica_diff_plain``, at k = 1, 3 and 5 and at key counts
    that are not a multiple of a block; one launch each."""
    a = 4000
    w = max(3, a // ratio) if ratio > 1 else a - 1
    old, new = (_operands_of(img, dev) for img in _anchor_nest_pair(
        a, min(a, 2 * w), w, pair, seed=ratio))
    want_branch = engine.anchor_nest_plain(
        *[([t.cpu() for t in e[0]], e[1]) for e in (old, new)])
    assert want_branch[0] == {"remove": engine.NEST_OLD_SHALLOW,
                              "restore": engine.NEST_NEW_SHALLOW,
                              "diverge": engine.NEST_NONE}[pair]
    keys = engine.key_tensor(KEYS[:count], dev)
    for k in (1, 3, 5):
        before = engine.LAUNCHES["anchor_replica_diff"]
        *got, branch = engine.kernel_replica_diff("anchor", keys, k, old, new,
                                                  with_nest=True)
        assert tuple(branch.tolist()) == want_branch
        assert engine.LAUNCHES["anchor_replica_diff"] == before + 1
        for g, w_ in zip(got, engine.replica_diff_plain("anchor", keys, k, old, new)):
            assert torch.equal(g, w_), k
    assert tuple(engine.anchor_nest_check(old, new).tolist()) == want_branch


def _diffs_in_flight(dev, streams: int, pairs, calls) -> None:
    """Two host threads, each over its own epoch pair of ``pairs`` (one that
    nests, one whose stacks part), run each of ``calls`` (``call(pair)`` →
    outputs and the branch, ``plain(pair)`` → the outputs) 16 times at
    once: on one stream, or each on a stream of its own (on the card).
    Every call takes its pair's branch and equals its plain version."""
    reps = 16
    wants = [[plain(p) for _, plain in calls] for p in pairs]
    branches = [engine.NEST_OLD_SHALLOW, engine.NEST_NONE]
    on_card = dev.type == "cuda"
    queues = [torch.cuda.Stream(dev) if on_card and streams == 2 else None for _ in pairs]
    barrier = threading.Barrier(len(pairs))
    results: list[list] = [[] for _ in pairs]

    def run(i: int) -> None:
        ctx = torch.cuda.stream(queues[i]) if queues[i] is not None else contextlib.nullcontext()
        with ctx:
            barrier.wait()
            for _ in range(reps):
                for call, _ in calls:
                    results[i].append(call(pairs[i]))
            if on_card:
                torch.cuda.current_stream().synchronize()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(pairs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for want, branch, got in zip(wants, branches, results):
        assert len(got) == reps * len(calls)
        for j, (*out, nest) in enumerate(got):
            assert int(nest[0]) == branch
            for g, w_ in zip(out, want[j % len(calls)]):
                assert torch.equal(g, w_)


@pytest.mark.parametrize("streams", [1, 2])
def test_anchor_replica_diffs_in_flight_at_once_keep_their_own_branch(dev, streams):
    """Two host threads each run ``anchor_replica_diff`` over its own epoch
    pair, one that nests and one whose stacks part, at once: on one stream,
    or each on a stream of its own (on the card).  Every call's check keeps
    its sums and verdict in the call's own workspace, so every call takes
    its pair's branch and equals ``replica_diff_plain``."""
    pairs = [[_operands_of(img, dev) for img in _anchor_nest_pair(4000, 200, 100, pair, seed=5)]
             for pair in ("remove", "diverge")]
    keys = engine.key_tensor(KEYS[:1000], dev)
    _diffs_in_flight(dev, streams, pairs, [
        (lambda p: engine.kernel_replica_diff("anchor", keys, 3, *p, with_nest=True),
         lambda p: engine.replica_diff_plain("anchor", keys, 3, *p))])


#: packed AnchorHash epoch pairs of the card tests: a, each epoch's dtype
PACKED_NEST_WIDTHS = {"int16": (4000, torch.int16, torch.int16),
                      "int8": (120, torch.int8, torch.int8),
                      "int8 -> int16": (120, torch.int8, torch.int16)}


def _packed_nest_pair(width: str, pair: str, dev, w_shallow=None, w_deep=None):
    """An epoch pair of :func:`_anchor_nest_pair` (by default a/2 working in
    the shallower epoch, a/20 in the deeper) packed, with A and K of each
    epoch cast to its dtype of ``PACKED_NEST_WIDTHS[width]`` (int8 by hand):
    each epoch's packed operands on ``dev``."""
    from repro_torch.core.packing import pack_image

    a, *dtypes = PACKED_NEST_WIDTHS[width]
    imgs = _anchor_nest_pair(a, w_shallow or a // 2, w_deep or a // 20, pair, seed=a + len(pair))
    out = []
    for img, dtype in zip(imgs, dtypes):
        img = _narrowed(pack_image(img), dtype)
        img.arrays = {k: v.to(dev) for k, v in img.arrays.items()}
        out.append(engine.image_operands(img, "packed"))
    return out


@pytest.mark.parametrize("count", [1, 255, 257, 4001])
@pytest.mark.parametrize("pair", ["remove", "restore", "diverge"])
@pytest.mark.parametrize("width", sorted(PACKED_NEST_WIDTHS))
def test_anchor_packed_diffs_take_their_branch_and_match_plain(dev, width, pair, count):
    """``anchor_packed_diff`` (k = 1) and ``anchor_packed_replica_diff`` (k = 3
    and 5), each its check and then its pair kernel, on packed epochs at
    int16, int8 and one epoch of each (old int8, new int16): epochs that
    nest take one walk through the deeper epoch's narrow tables, the older
    the shallower ("remove") or the newer ("restore"); stacks that part
    ("diverge") take each epoch's walk.  Each call's verdict equals the
    plain check's, and the check's alone; its outputs equal the plain
    versions', at key counts that are not a multiple of a block; one launch
    each."""
    old, new = _packed_nest_pair(width, pair, dev)
    want_branch = engine.anchor_nest_plain(
        *[([t.cpu() for t in e[0]], e[1]) for e in (old, new)])
    assert want_branch[0] == {"remove": engine.NEST_OLD_SHALLOW,
                              "restore": engine.NEST_NEW_SHALLOW,
                              "diverge": engine.NEST_NONE}[pair]
    keys = engine.key_tensor(KEYS[:count], dev)
    for k in (1, 3, 5):
        name = engine.kernel_name("anchor", "diff" if k == 1 else "replica_diff", "packed")
        before = engine.LAUNCHES[name]
        if k == 1:
            *got, branch = engine.kernel_diff("anchor", keys, old, new, table="packed",
                                              with_nest=True)
            want = engine.diff_plain("anchor", keys, old, new, table="packed")
        else:
            *got, branch = engine.kernel_replica_diff("anchor", keys, k, old, new,
                                                      table="packed", with_nest=True)
            want = engine.replica_diff_plain("anchor", keys, k, old, new, table="packed")
        assert tuple(branch.tolist()) == want_branch, k
        assert engine.LAUNCHES[name] == before + 1
        for g, w_ in zip(got, want):
            assert torch.equal(g, w_), k
    assert tuple(engine.anchor_nest_check(old, new, table="packed").tolist()) == want_branch


@pytest.mark.parametrize("streams", [1, 2])
def test_anchor_packed_diffs_in_flight_at_once_keep_their_own_branch(dev, streams):
    """As the dense test above, for ``anchor_packed_diff`` and
    ``anchor_packed_replica_diff`` (k = 3) in turns, on an int16 pair that
    nests beside an int16 pair whose stacks part."""
    pairs = [_packed_nest_pair("int16", pair, dev, 200, 100) for pair in ("remove", "diverge")]
    keys = engine.key_tensor(KEYS[:1000], dev)
    kw = {"table": "packed"}
    _diffs_in_flight(dev, streams, pairs, [
        (lambda p: engine.kernel_diff("anchor", keys, *p, **kw, with_nest=True),
         lambda p: engine.diff_plain("anchor", keys, *p, **kw)),
        (lambda p: engine.kernel_replica_diff("anchor", keys, 3, *p, **kw, with_nest=True),
         lambda p: engine.replica_diff_plain("anchor", keys, 3, *p, **kw))])


def _operands_of(img, dev):
    img.arrays = {k: v.to(dev) for k, v in img.arrays.items()}
    return engine.image_operands(img)


@pytest.mark.parametrize("layout", ["dense", "int16", "int8"])
@pytest.mark.parametrize("pending_share", [0.0, 0.5, 1.0])
def test_anchor_walk_at_every_pending_share_matches_plain(dev, pending_share, layout):
    """``anchor_walk`` (and ``anchor_packed_walk`` at int16 and int8) with
    no lane pending, half and every lane, at caps from five buckets of six
    full to none, on key counts that are not a multiple of a block: equal
    to the plain walk, one launch each."""
    a = 120 if layout == "int8" else 4000
    h = _anchor_run(a, 10, "random", seed=11)
    (tables, scalars), table = _anchor_layout(h, layout, dev)
    name = engine.kernel_name("anchor", "walk", table)
    rng = np.random.default_rng(12)
    load = torch.from_numpy(rng.integers(0, 6, size=tables[0].numel()).astype(np.int32)).to(dev)
    for count in (1, 255, 257, 5003):
        chain = engine.key_tensor(KEYS[:count], dev)
        probe = torch.from_numpy(rng.integers(0, 9, size=count).astype(np.int32)).to(dev)
        pending = torch.from_numpy(rng.random(count) < pending_share).to(dev)
        for cap in (1, 3, 6):
            before = engine.LAUNCHES[name]
            got = engine.kernel_walk("anchor", chain, probe, pending, tables, scalars, load,
                                     cap, table=table)
            assert engine.LAUNCHES[name] == before + 1
            want = engine.walk_plain("anchor", chain, probe, pending, tables, scalars, load,
                                     cap, table=table)
            for g, w in zip(got, want):
                assert torch.equal(g, w), (count, cap)


def test_anchor_walk_stops_every_lane_at_max_probe(dev):
    """Every bucket at the cap: each pending lane of ``anchor_walk`` steps
    until max_probe (up to 41 steps), the others keep their chain and
    probe; equal to the plain walk."""
    from repro_torch.core.bounded import walk_probe_bound

    h = _anchor_run(400, 40, "random", seed=13)
    tables, scalars = _operands(h, dev)
    load = torch.ones(tables[0].numel(), dtype=torch.int32, device=dev)
    max_probe = walk_probe_bound(load.numel())
    count = 700
    chain = engine.key_tensor(KEYS[:count], dev)
    rng = np.random.default_rng(14)
    probe = torch.from_numpy(rng.integers(max_probe - 40, max_probe + 2,
                                          size=count).astype(np.int32)).to(dev)
    pending = torch.from_numpy(rng.random(count) < 0.7).to(dev)
    got = engine.kernel_walk("anchor", chain, probe, pending, tables, scalars, load, 1)
    want = engine.walk_plain("anchor", chain, probe, pending, tables, scalars, load, 1)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    stepped = pending & (probe < max_probe)
    assert (got[2][stepped] == max_probe).all()
    assert torch.equal(got[2][~stepped], probe[~stepped])


# ---------------------------------------------------------------------------
# the sharded plane: two entries on one card (two streams), pipelined
# ---------------------------------------------------------------------------

def _plane_store(algo: str, dev, compact: bool):
    from repro_torch.core.image_store import DeviceImageStore

    h = make_hash(algo, 3000, capacity=12000, variant="32")
    rng = np.random.default_rng(31)
    for _ in range(400):
        if ALGORITHM_REGISTRY[algo].lifo_only:
            h.remove(h.size - 1)
        else:
            ws = sorted(h.working_set())
            h.remove(ws[int(rng.integers(len(ws)))])
    return h, DeviceImageStore(h, device=dev, compact=compact)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("algo,compact", [(a, False) for a in ALGORITHMS]
                         + [(a, True) for a in ALGORITHMS if a in engine.PACKED_KERNELS])
def test_sharded_plane_on_one_card_twice_matches_store(dev, algo, compact, k):
    """``[cuda, cuda]``: each entry's chunk on its own stream, equal to the
    store's single lookup, batch after batch of a stream (a staging or
    stream race would show as a wrong batch)."""
    from repro_torch.serve.plane import ShardedLookupPlane

    _, store = _plane_store(algo, dev, compact)
    plane = ShardedLookupPlane(store, devices=[dev, dev], k=k)
    rng = np.random.default_rng(32)
    batches = [rng.integers(0, 2**32, size=int(s), dtype=np.uint32)
               for s in rng.integers(1, 70_000, size=24)]
    want = [store.lookup(b, k=k).cpu().numpy() for b in batches]
    np.testing.assert_array_equal(plane.lookup(batches[0]), want[0])
    got = list(plane.route_stream(iter(batches)))
    assert len(got) == len(want) and plane.copies == 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("replicas_k", [1, 2])
@pytest.mark.parametrize("sync_mode", ["block", "overlap"])
def test_route_stream_across_flips_on_one_card_twice(dev, sync_mode, replicas_k):
    """Every streamed batch equals ``route_batch`` of its ids at the epoch
    it was served at: taken before the batch is fed, after the event's
    device work is done (so the next poll point lands an overlapped flip)."""
    r = SessionRouter(2000, device=dev, sync_mode=sync_mode, replicas_k=replicas_k)
    r.image_store()
    rng = np.random.default_rng(33)
    batches = [rng.integers(0, 2**63, size=(1 << 16) + 77, dtype=np.uint64) for _ in range(12)]
    victim = 5
    want = []

    def feed():
        for i, ids in enumerate(batches):
            if i == 3:
                r.mark_failed(victim)
            if i == 4:
                r.fail_replica(victim)
            if i in (6, 7):
                r.fail_replica(sorted(r.replicas)[100 + i])
            if i == 9:
                r.restore_replica()
            torch.cuda.synchronize(dev)
            want.append(r.route_batch(ids))
            yield ids

    got = list(r.route_stream(feed(), devices=[dev, dev]))
    assert len(got) == len(want) == len(batches)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert r.image_store().epoch == r.ch.epoch
    if replicas_k > 1:
        assert victim not in set(got[3].tolist())


def _storm(m, rng, removals: int, restores: int) -> None:
    """``removals`` removals of random working buckets, then ``restores``
    adds."""
    for b in rng.permutation(m.n).tolist()[:removals]:
        if m.is_working(b) and m.working > 1:
            m.remove(b)
    for _ in range(restores):
        m.add()


@pytest.mark.parametrize("layout", ["dense", "int16"])
def test_follower_on_the_card_matches_a_cpu_follower_and_the_leader(dev, layout):
    """A follower on the card replays the publisher's frames through the
    delta apply kernels (int16 slot tables when packed at n = 10^4) to the
    fingerprint of a follower on the CPU and of the leader's host state,
    and its lookups at k = 1 and 3 equal both and the leader's store."""
    from repro_torch.core.image_store import DeviceImageStore
    from repro_torch.core.protocol import image_fingerprint
    from repro_torch.launch.replicate import DeltaPublisher, FollowerImageStore

    packed = layout != "dense"
    m = MementoHash(10_000, variant="32")
    store = DeviceImageStore(m, device=dev, compact=packed)
    pub = DeltaPublisher(m, packed=packed)
    card = FollowerImageStore(device=dev, compact=packed)
    cpu = FollowerImageStore(device="cpu", compact=packed)
    rng = np.random.default_rng(3)
    before = dict(da.LAUNCHES)
    for storm in range(5):
        if storm:
            _storm(m, rng, 300, 150)
            store.sync()
        frames = pub.frames()
        card.apply_frames(frames)
        cpu.apply_frames(frames)
        want = image_fingerprint(m.device_image())  # the store's may be packed
        assert card.epoch == cpu.epoch == store.epoch
        assert card.fingerprint() == cpu.fingerprint() == want
    assert card.deltas > 0 and card.image().packed == packed
    assert all(t.device == dev for t in card.image().arrays.values())
    if packed:
        assert card.image().arrays["slot_b"].dtype == torch.int16
    name = "delta_apply_int16" if packed else "delta_apply"
    assert da.LAUNCHES[name] > before[name]
    for k in (1, 3):
        got = card.lookup(KEYS, k=k)
        np.testing.assert_array_equal(got, cpu.lookup(KEYS, k=k))
        np.testing.assert_array_equal(got, store.lookup(KEYS, k=k).cpu().numpy())


@pytest.mark.parametrize("algo", ALGORITHMS)
def test_two_followers_on_one_card_converge(dev, algo):
    """A replication group with two followers on the card (a tree of
    arity 1: the second relays through the first) through storms and an
    offline round repaired by catch-up."""
    from repro_torch.core.image_store import DeviceImageStore
    from repro_torch.launch.replicate import ReplicationGroup

    info = ALGORITHM_REGISTRY[algo]
    h = make_hash(algo, 2000, capacity=8000, variant="32")
    store = DeviceImageStore(h, device=dev)
    g = ReplicationGroup(h, 2, device=dev, topology="tree", arity=1)
    g.publish()
    rng = np.random.default_rng(4)
    for storm in range(4):
        g.set_online(1, storm != 1)
        for _ in range(40):
            if info.lifo_only:
                h.remove(h.size - 1)
            else:
                ws = sorted(h.working_set())
                h.remove(ws[int(rng.integers(len(ws)))])
        for _ in range(20):
            h.add()
        store.sync()
        g.publish()
    assert g.converged(store.image()) and g.stats.catchup_frames >= 1
    a, b = g.followers
    assert a.image() is not b.image()
    for k in (1, 3):
        want = store.lookup(KEYS, k=k).cpu().numpy()
        np.testing.assert_array_equal(a.lookup(KEYS, k=k), want)
        np.testing.assert_array_equal(b.lookup(KEYS, k=k), want)


@pytest.mark.parametrize("replicas_k", [1, 3])
def test_route_batch_with_telemetry_equals_off(dev, replicas_k):
    """Telemetry never changes a placement on the card: one router with a
    live registry (also the process default while it routes, where the
    engine records) and one without route the same batches through a marked replica, equal, and
    the registry counts the batches and keys."""
    from repro_torch import obs

    ids = np.random.default_rng(6).integers(0, 2**63, size=(4, 50_000), dtype=np.uint64)
    off = SessionRouter(5000, device=dev, replicas_k=replicas_k)
    reg = obs.MetricRegistry()
    on = SessionRouter(0, algo=off.ch, device=dev, replicas_k=replicas_k, registry=reg)
    for i, batch in enumerate(ids):
        if i == 2:
            off.mark_failed(7)
            on.mark_failed(7)
        want = off.route_batch(batch)
        prev = obs.set_default_registry(reg)
        try:
            got = on.route_batch(batch)
        finally:
            obs.set_default_registry(prev)
        np.testing.assert_array_equal(got, want)
    c = reg.snapshot()["counters"]
    assert c["router.batch_keys"] == ids.size and c["store.lookups"] == len(ids)
    assert c["engine.dispatches"] == len(ids) and c["engine.keys"] == ids.size


@pytest.mark.parametrize("algo", ALGORITHMS)
def test_replay_with_telemetry_equals_off(dev, algo):
    trace = make_trace("churn_storm", 3, w=200, storms=2, burst=8, n_keys=4096)
    on = replay(trace, algo=algo, device=dev, followers=2, telemetry=True)
    off = replay(trace, algo=algo, device=dev, followers=2)
    assert on.ok and off.ok and on.fingerprint == off.fingerprint
    c = on.summary()["telemetry"]["counters"]
    assert c["sim.events"] == len(trace.events) and c["engine.diffs"] > 0
    assert c["store.syncs"] == c["sim.delta_applies"] + c["sim.snapshot_rebuilds"]


def test_spans_push_and_pop_nvtx_ranges_on_a_cuda_build(dev, monkeypatch):
    """On a CUDA build the tracer opens an NVTX range a span and closes it,
    also when the body raises; the ranges are real calls into NVTX."""
    from repro_torch import obs

    assert torch.version.cuda is not None
    reg = obs.MetricRegistry()
    with reg.span("store.sync"):  # the real NVTX calls: they must not raise
        with reg.span("store.sync.flip"):
            torch.ones(4, device=dev).sum()
    push, pop = torch.cuda.nvtx.range_push, torch.cuda.nvtx.range_pop
    calls = []
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", lambda n: calls.append(n) or push(n))
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop", lambda: calls.append(None) or pop())
    with pytest.raises(ValueError):
        with reg.span("repl.publish"):
            with reg.span("repl.relay"):
                raise ValueError("body failed")
    assert calls == ["repl.publish", "repl.relay", None, None]
    assert [n for _, n, _ in reg.tracer.tree()] == [
        "store.sync.flip", "store.sync", "repl.relay", "repl.publish"]
