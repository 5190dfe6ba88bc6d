"""The port's training substrates (on the CPU) against the reference's:
shard placement plans and assignments, the synthetic corpus and pipeline,
the elastic cluster's events, state and replica movements, the straggler
monitor, and checkpoints (one layout: each package restores the other's),
exactly."""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from repro.ckpt import AsyncCheckpointer as RefCheckpointer
from repro.ckpt import restore_checkpoint as ref_restore
from repro.ckpt import save_checkpoint as ref_save
from repro.core import ALGORITHMS
from repro.core import MementoHash as RefMemento
from repro.data import DataPipeline as RefPipeline
from repro.data import ShardPlacement as RefPlacement
from repro.data import synthetic_shard_tokens as ref_tokens
from repro.runtime import ElasticCluster as RefCluster
from repro.runtime import StragglerMonitor as RefMonitor
from repro_torch.ckpt import AsyncCheckpointer, latest_step, restore_checkpoint, save_checkpoint
from repro_torch.core.memento import MementoHash
from repro_torch.core.protocol import ALGORITHM_REGISTRY
from repro_torch.data import DataPipeline, ShardPlacement, synthetic_shard_tokens
from repro_torch.runtime import ElasticCluster, StragglerMonitor

from conformance import state
from test_torch_algorithms import _from_state

NUM_SHARDS = 300
HOSTS = 16
CAPACITY = 64


def _lifo(algo: str) -> bool:
    return ALGORITHM_REGISTRY[algo].lifo_only


def _victims(algo: str, ch, rng, count: int) -> list[int]:
    """``count`` removal victims in turn: random working hosts, or the
    last host for LIFO-only algorithms."""
    out = []
    for _ in range(count):
        if _lifo(algo):
            out.append(ch.size - 1 - len(out))
        else:
            ws = sorted(set(ch.working_set()) - set(out))
            out.append(ws[int(rng.integers(len(ws)))])
    return out


def _same_plan_sequence(port, ref, algo: str, victims: list[int], joins: int):
    for host in victims:
        assert port.fail_host(host) == ref.fail_host(host)
        assert port.assignment() == ref.assignment()
    for _ in range(joins):
        assert port.add_host() == ref.add_host()
        assert port.assignment() == ref.assignment()


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["32", "64"])
@pytest.mark.parametrize("algo", ALGORITHMS)
def test_placement_plans_match_reference(algo, variant):
    port = ShardPlacement(NUM_SHARDS, HOSTS, variant=variant, algo=algo,
                          capacity=CAPACITY, device="cpu")
    ref = RefPlacement(NUM_SHARDS, HOSTS, variant=variant, algo=algo, capacity=CAPACITY)
    assert port.assignment() == ref.assignment()
    victims = _victims(algo, ref.ch, np.random.default_rng(3), 4)
    _same_plan_sequence(port, ref, algo, victims, joins=3)
    if variant == "32":  # plans came from the store: one delta sync an event
        assert port.image_store().totals.delta_applies == 7
    else:
        assert port._store is None


@pytest.mark.parametrize("algo", ALGORITHMS)
def test_placement_on_a_converted_state(algo):
    """``algo`` may be a port host state, carried across from the
    reference's with ``repro_torch.convert``."""
    ref_h = state(algo, 40, 9, seed=4)
    port = ShardPlacement(NUM_SHARDS, 0, algo=_from_state(algo, ref_h), device="cpu")
    ref = RefPlacement(NUM_SHARDS, 0, algo=ref_h)
    assert port.assignment() == ref.assignment()
    victims = _victims(algo, ref_h, np.random.default_rng(5), 2)
    _same_plan_sequence(port, ref, algo, victims, joins=2)


@pytest.mark.parametrize("algo", [a for a in ALGORITHMS if _lifo(a)])
def test_lifo_only_placement_refuses_other_hosts(algo):
    port = ShardPlacement(64, 8, algo=algo, device="cpu")
    ref = RefPlacement(64, 8, algo=algo)
    with pytest.raises(ValueError) as want:
        ref.fail_host(2)
    with pytest.raises(type(want.value)):
        port.fail_host(2)
    assert port.fail_host(7) == ref.fail_host(7)


@pytest.mark.parametrize("shard,length,vocab,offset", [
    (0, 64, 1000, 0), (7, 100, 500, 32), (2**31 + 5, 33, 50257, 2**32 - 7),
    (123456, 1, 2, 10**9)])
def test_synthetic_tokens_match_reference(shard, length, vocab, offset):
    got = synthetic_shard_tokens(shard, length, vocab, offset=offset)
    want = ref_tokens(shard, length, vocab, offset=offset)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("algo", ALGORITHMS)
def test_pipeline_batches_and_resume_match_reference(algo):
    port_p = ShardPlacement(64, 4, algo=algo, capacity=16, device="cpu")
    ref_p = RefPlacement(64, 4, algo=algo, capacity=16)
    kw = dict(host=1, batch=4, seq_len=32, vocab_size=1000, shard_tokens=1 << 8)
    port, ref = DataPipeline(port_p, **kw), RefPipeline(ref_p, **kw)
    for _ in range(3):
        got, want = port.next_batch(), ref.next_batch()
        for name in ("tokens", "labels"):
            np.testing.assert_array_equal(got[name], want[name])
    st = port.state()
    assert st == ref.state()
    again = DataPipeline(port_p, **kw)
    again.load_state(st)
    want = ref.next_batch()["tokens"]
    np.testing.assert_array_equal(again.next_batch()["tokens"], want)
    np.testing.assert_array_equal(port.next_batch()["tokens"], want)
    victim = 3  # the last host: legal for every algorithm
    assert port_p.fail_host(victim) == ref_p.fail_host(victim)
    for _ in range(2):
        np.testing.assert_array_equal(port.next_batch()["tokens"], ref.next_batch()["tokens"])


# ---------------------------------------------------------------------------
# runtime
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algo", ALGORITHMS)
def test_elastic_cluster_matches_reference(algo):
    kw = dict(num_shards=200, algo=algo, capacity=48, replica_k=2)
    port, ref = ElasticCluster(12, device="cpu", **kw), RefCluster(12, **kw)
    assert port.state() == ref.state()
    victims = _victims(algo, ref.placement.ch, np.random.default_rng(7), 3)
    for host in victims:
        assert port.fail(host) == ref.fail(host)
        for k in (1, 2, 3):
            assert port.replica_movement(k) == ref.replica_movement(k)
        assert port.replica_movement() == ref.replica_movement()
        assert port.state() == ref.state() and port.hosts == ref.hosts
    for _ in range(2):
        assert port.join() == ref.join()
        for k in (1, 2, 3):
            assert port.replica_movement(k) == ref.replica_movement(k)
        assert port.state() == ref.state()
    assert port.movement_total() == ref.movement_total()
    assert [vars(e) for e in port.events] == [vars(e) for e in ref.events]
    assert port.ckpt_ch.name == ref.ckpt_ch.name == algo


def test_replica_movement_before_any_event_is_empty():
    assert ElasticCluster(8, num_shards=32, replica_k=2, device="cpu").replica_movement() == {}


@pytest.mark.parametrize("algo", ALGORITHMS)
def test_replica_placement_with_domains_matches_reference(algo):
    kw = dict(num_shards=60, algo=algo, capacity=48, replica_k=3, num_domains=4)
    port, ref = ElasticCluster(12, device="cpu", **kw), RefCluster(12, **kw)
    assert port.replica_placement() == ref.replica_placement()
    assert port.replica_placement(2) == ref.replica_placement(2)
    for s in (0, 17, 59):
        hosts = port.replica_hosts(s)
        assert len({h % 4 for h in hosts}) == 3
    with pytest.raises(ValueError, match="failure domains"):
        ref.replica_hosts(0, 5)
    with pytest.raises(ValueError, match="failure domains"):
        port.replica_hosts(0, 5)


def test_straggler_monitor_matches_reference():
    port, ref = StragglerMonitor(k_sigma=2.5, window=30), RefMonitor(k_sigma=2.5, window=30)
    rng = np.random.default_rng(11)
    for step in range(60):
        lat = {h: float(1.0 + 0.05 * rng.normal() + (3.0 if rng.random() < 0.1 else 0.0))
               for h in range(8)}
        got, want = port.filter_step(lat), ref.filter_step(lat)
        assert got == want, step
    assert port.deadline() == ref.deadline()


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _numpy_state():
    rng = np.random.default_rng(0)
    return {"params": {"w": rng.normal(size=(8, 8)).astype(np.float32),
                       "b": rng.normal(size=(8,)).astype(np.float32),
                       "emb": rng.integers(-9, 9, size=(5, 3)).astype(np.int32)},
            "opt": {"m": {"w": np.zeros((8, 8), np.float32),
                          "b": np.ones((8,), np.float32)},
                    "step": np.int32(7), "count": np.int64(2**40)}}


def _torch_state():
    """The numpy state with every array leaf as a torch tensor."""
    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        return torch.from_numpy(np.array(tree))
    return conv(_numpy_state())


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _assert_bit_equal(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    for path, a in got.items():
        b = np.asarray(want[path])
        assert isinstance(a, np.ndarray), path
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path


@pytest.mark.parametrize("buckets,removals", [(1, 0), (3, 0), (5, 2)])
@pytest.mark.parametrize("leaves", ["numpy", "torch"])
def test_checkpoint_manifest_matches_reference(tmp_path, leaves, buckets, removals):
    port_m, ref_m = MementoHash(buckets), RefMemento(buckets)
    for b in (1, 3)[:removals]:
        port_m.remove(b)
        ref_m.remove(b)
    st = _numpy_state() if leaves == "numpy" else _torch_state()
    got = save_checkpoint(st, 12, tmp_path / "port", num_buckets=buckets, memento=port_m)
    want = ref_save(_numpy_state(), 12, tmp_path / "ref", num_buckets=buckets, memento=ref_m)
    assert (json.loads((got / "manifest.json").read_text())
            == json.loads((want / "manifest.json").read_text()))
    assert sorted(p.name for p in got.iterdir()) == sorted(p.name for p in want.iterdir())
    manifest = json.loads((got / "manifest.json").read_text())
    for path, info in manifest["shards"].items():
        assert info["bucket"] == ref_m.lookup(ref_key(path))


def ref_key(path: str) -> int:
    from repro.core.hashing import key_to_u64
    return key_to_u64(path)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoints_restore_across_packages(tmp_path, writer):
    if writer == "port":
        save_checkpoint(_torch_state(), 3, tmp_path, num_buckets=3)
        got, manifest = ref_restore(tmp_path)
    else:
        ref_save(_numpy_state(), 3, tmp_path, num_buckets=3)
        got, manifest = restore_checkpoint(tmp_path)
    assert manifest["step"] == 3 and latest_step(tmp_path) == 3
    _assert_bit_equal(got, _numpy_state())


def test_torch_leaves_save_as_their_numpy_values(tmp_path):
    st = {"a": torch.arange(6, dtype=torch.int16).reshape(2, 3),
          "b": {"c": torch.tensor(2.5, dtype=torch.float64),
                "d": torch.ones(4, requires_grad=True)}}
    save_checkpoint(st, 1, tmp_path)
    got, manifest = restore_checkpoint(tmp_path, 1)
    _assert_bit_equal(got, {"a": st["a"].numpy(),
                            "b": {"c": st["b"]["c"].numpy(),
                                  "d": st["b"]["d"].detach().numpy()}})
    assert manifest["shards"]["b/c"] == {"bucket": manifest["shards"]["b/c"]["bucket"],
                                         "shape": [], "dtype": "float64"}


def test_bfloat16_leaf_raises_naming_it(tmp_path):
    st = {"params": {"w": torch.zeros(4, dtype=torch.bfloat16), "b": torch.zeros(4)}}
    with pytest.raises(TypeError, match="params/w"):
        save_checkpoint(st, 1, tmp_path)
    ck = AsyncCheckpointer(tmp_path)
    with pytest.raises(TypeError, match="params/w"):
        ck.save(st, 2)  # raised on the caller's thread, before the writer
    assert latest_step(tmp_path) is None


def test_async_checkpointer_gc_matches_reference(tmp_path):
    port = AsyncCheckpointer(tmp_path / "port", num_buckets=2, keep=2)
    ref = RefCheckpointer(tmp_path / "ref", num_buckets=2, keep=2)
    for step in (1, 2, 3, 4):
        port.save(_torch_state(), step)
        ref.save(_numpy_state(), step)
    port.wait()
    ref.wait()
    names = [sorted(p.name for p in (tmp_path / d).glob("step_*")) for d in ("port", "ref")]
    assert names[0] == names[1] == ["step_00000003", "step_00000004"]
    assert latest_step(tmp_path / "port") == 4
    got, _ = restore_checkpoint(tmp_path / "port")
    _assert_bit_equal(got, _numpy_state())


def test_async_checkpointer_keeps_the_state_of_its_save_call(tmp_path):
    """A CPU tensor updated in place right after ``save`` returns: the
    checkpoint holds the values at the call."""
    st = {"w": torch.arange(1 << 16, dtype=torch.float32)}
    want = st["w"].numpy().copy()
    ck = AsyncCheckpointer(tmp_path)
    ck.save(st, 1)
    st["w"].add_(1)
    ck.wait()
    got, _ = restore_checkpoint(tmp_path)
    assert got["w"].tobytes() == want.tobytes()


def test_async_checkpointer_surfaces_a_writer_error_on_wait(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    ck = AsyncCheckpointer(blocker, keep=2)
    ck.save(_numpy_state(), 1)  # the writer thread fails to make its directory
    with pytest.raises(OSError):
        ck.wait()
    ck.wait()  # reported once
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(tmp_path / "empty")
