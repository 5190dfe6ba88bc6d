"""The port's replication (``repro_torch.launch.replicate``) against the
reference's, on the CPU: the same seeded churn drives a reference and a
port host state (``variant="32"``), and the two packages must encode the
same frames word for word (dense and packed, every ``batch_epochs``),
land each other's followers on equal epochs and fingerprints, refuse or
skip the same faulty drains, count the same wire traffic in their
replication groups, and replay ``followers=`` scenarios to equal
summaries.  The last tests run real processes over gloo
(``torch.distributed``) and hold them to an in-process reference leader.

The port runs with ``device="cpu"`` (the plain versions of the kernels),
the reference on its jnp plane."""
from __future__ import annotations

import os
import socket
import subprocess
import sys
import textwrap
import zlib
from dataclasses import asdict
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from repro.core import ALGORITHM_REGISTRY
from repro.core import DeviceImageStore as RefStore
from repro.core import image_fingerprint as ref_fingerprint
from repro.core import make_hash as ref_make_hash
from repro.core.packing import pack_image as ref_pack_image
from repro.launch import replicate as R
from repro.sim import make_trace as ref_make_trace
from repro.sim import replay as ref_replay
from repro_torch.core.packing import pack_image
from repro_torch.core.protocol import make_hash
from repro_torch.launch import replicate as P
from repro_torch.sim import make_trace, replay

from conformance import ALGORITHMS, lifo_only

ROOT = Path(__file__).resolve().parent.parent
KEYS = np.random.default_rng(5).integers(0, 2**32, size=512, dtype=np.uint32)
GROWABLE = [a for a in ALGORITHMS if not ALGORITHM_REGISTRY[a].fixed_capacity]

#: the two packages behind one interface
REF = SimpleNamespace(
    rep=R, make_hash=ref_make_hash,
    follower=lambda **kw: R.FollowerImageStore(plane="jnp", **kw),
    group=lambda h, n=1, **kw: R.ReplicationGroup(h, n, plane="jnp", **kw))
PORT = SimpleNamespace(
    rep=P, make_hash=make_hash,
    follower=lambda **kw: P.FollowerImageStore(device="cpu", **kw),
    group=lambda h, n=1, **kw: P.ReplicationGroup(h, n, device="cpu", **kw))


def _mk(pkg, algo: str, n0: int = 64):
    return pkg.make_hash(algo, n0, capacity=4 * n0, variant="32")


def _victim(h, rng):
    return h.size - 1 if lifo_only(h.name) else h.lookup(int(rng.integers(1 << 30)))


def _churn_once(h, rng):
    if h.working > 1 and rng.random() < 0.55:
        h.remove(_victim(h, rng))
    else:
        try:
            h.add()
        except ValueError:
            h.remove(_victim(h, rng))


def _churn(h, seed, events: int = 6):
    """``events`` seeded churn events: the same on either package's state."""
    rng = np.random.default_rng([97, *np.atleast_1d(seed)])
    for _ in range(events):
        _churn_once(h, rng)


def _twins(algo: str, n0: int = 64):
    return _mk(REF, algo, n0), _mk(PORT, algo, n0)


def _frames_equal(a: list, b: list) -> None:
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert np.asarray(x).dtype == np.asarray(y).dtype == np.int32
        np.testing.assert_array_equal(x, y)


def _decoded(f) -> tuple:
    """A decoded frame as plain values (arrays as their dtype and bytes)."""
    return (f.kind, f.algo, f.base_epoch, f.epoch, f.n, f.scalars, f.packed,
            {k: (np.asarray(i).tolist(), np.asarray(v).tolist()) for k, (i, v) in f.updates.items()},
            {k: (a.dtype.str, a.tobytes()) for k, a in f.arrays.items()})


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
@pytest.mark.parametrize("algo", ALGORITHMS)
def test_snapshot_frames_equal_word_for_word(algo, packed):
    """DxHash's words and a packed Memento state ride the uint32 tag in
    both packages; narrow packed tables their own."""
    r, p = _twins(algo)
    _churn(r, 1, 10)
    _churn(p, 1, 10)
    ri, pi = r.device_image(), p.device_image()
    if packed:
        ri, pi = ref_pack_image(ri, slot_headroom=2), pack_image(pi, slot_headroom=2)
    want, got = R.encode_snapshot(ri), P.encode_snapshot(pi)
    _frames_equal([want], [got])
    assert _decoded(P.decode_frame(want)) == _decoded(R.decode_frame(want))
    for name, arr in P.decode_frame(got).arrays.items():  # dtypes survive the wire
        assert arr.dtype == np.asarray(ri.arrays[name]).dtype


@pytest.mark.parametrize("algo", ALGORITHMS)
def test_delta_frames_equal_word_for_word(algo):
    r, p = _twins(algo)
    bases = []
    for step in range(8):
        bases.append(r.epoch)
        _churn(r, step, 3)
        _churn(p, step, 3)
        for e0 in bases:  # one-event and composed deltas
            want = R.encode_delta(r.device_delta(e0))
            got = P.encode_delta(p.device_delta(e0))
            _frames_equal([want], [got])
            assert _decoded(P.decode_frame(want)) == _decoded(R.decode_frame(want))


def _delta_values(d) -> tuple | None:
    if d is None:
        return None
    return (d.algo, d.base_epoch, d.epoch, d.n, dict(d.scalars),
            {k: (np.asarray(i).tolist(), np.asarray(v).tolist())
             for k, (i, v) in sorted(d.updates.items())})


@pytest.mark.parametrize("algo", ALGORITHMS)
def test_device_delta_range_equal_to_the_reference(algo):
    """Random ranges, empty ranges and the window's edges (``None`` where
    the bounded log no longer covers the range)."""
    r, p = _twins(algo)
    for h in (r, p):
        h._DELTA_LOG_CAP = 16
    _churn(r, 3, 40)
    _churn(p, 3, 40)
    cur, window = r.epoch, len(r._delta_log)
    assert p.epoch == cur and len(p._delta_log) == window
    edge = cur - window
    rng = np.random.default_rng(11)
    ranges = [(edge, edge), (edge, edge + 1), (edge - 1, cur), (edge, cur), (cur, cur),
              (cur - 1, cur), (edge + 3, edge + 3)]
    for _ in range(40):
        since = int(rng.integers(edge - 3, cur + 1))
        ranges.append((since, int(rng.integers(since, cur + 1))))
    results = []
    for since, until in ranges:
        want = _delta_values(r.device_delta_range(since, until))
        assert _delta_values(p.device_delta_range(since, until)) == want
        results.append(want is None)
    assert any(results) and not all(results)
    for bad in ((cur, cur + 1), (cur, cur - 1)):
        for h in (r, p):
            with pytest.raises(ValueError):
                h.device_delta_range(*bad)


def _stream(pkg, algo: str, packed: bool, batch_epochs: int) -> list:
    """Every publish of a churned leader, a growth or a log overflow
    between publishes, and catch-up pulls: the frame lists in order."""
    h = _mk(pkg, algo)
    pub = pkg.rep.DeltaPublisher(h, batch_epochs=batch_epochs, packed=packed)
    out = [pub.frames()]
    for burst in range(6):
        _churn(h, burst, 6)
        out.append(pub.frames())
        out.append(pub.frames())  # nothing pending: no frames
    early = pub.published_epoch
    if algo in GROWABLE:  # outgrow the announced capacity: a snapshot
        for _ in range(200):
            h.add()
        out.append(pub.frames())
    h._DELTA_LOG_CAP = 8
    _churn(h, 50, 30)  # far past the host's log: a snapshot
    out.append(pub.frames())
    for burst in range(3):
        _churn(h, 60 + burst, 5)
        out.append(pub.frames())
    out.append(pub.catchup_frames(pub.published_epoch - 5))  # a composed delta
    out.append(pub.catchup_frames(early))  # before the snapshot: a snapshot
    out.append(pub.catchup_frames(-1))
    return out


@pytest.mark.parametrize("batch_epochs", [0, 1, 3])
@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
@pytest.mark.parametrize("algo", ALGORITHMS)
def test_publisher_frames_equal_word_for_word(algo, packed, batch_epochs):
    want = _stream(REF, algo, packed, batch_epochs)
    got = _stream(PORT, algo, packed, batch_epochs)
    assert len(got) == len(want)
    for a, b in zip(want, got):
        _frames_equal(a, b)
    kinds = [R._peek_kind(f) for frames in want for f in frames]
    snapshot = R.KIND_SNAPSHOT_PACKED if packed else R.KIND_SNAPSHOT
    assert kinds.count(snapshot) >= 3 + (algo in GROWABLE)
    delta = R.KIND_DELTA if batch_epochs == 1 else R.KIND_DELTA_BATCH
    assert delta in kinds


@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
@pytest.mark.parametrize("algo", ALGORITHMS)
def test_frames_cross_between_the_packages(algo, packed):
    """The reference's frames land a port follower, the port's a reference
    follower, on the leader's epoch and fingerprint; their lookups agree
    at k = 1 and 3."""
    r, p = _twins(algo)
    rpub = R.DeltaPublisher(r, packed=packed)
    ppub = P.DeltaPublisher(p, packed=packed)
    pfol, rfol = PORT.follower(compact=packed), REF.follower(compact=packed)
    for burst in range(8):
        pfol.apply_frames(rpub.frames())
        rfol.apply_frames(ppub.frames())
        want = ref_fingerprint(r.device_image())
        assert pfol.epoch == rfol.epoch == r.epoch == p.epoch
        assert pfol.fingerprint() == rfol.fingerprint() == want
        _churn(r, burst, 6)
        _churn(p, burst, 6)
    assert pfol.image().packed == packed and pfol.deltas > 0
    for k in (1, 3):
        np.testing.assert_array_equal(pfol.lookup(KEYS, k=k),
                                      np.asarray(rfol.lookup(KEYS, k=k)))


# ---------------------------------------------------------------------------
# faulty drains: each package raises or skips alike
# ---------------------------------------------------------------------------

def _outcome(fn):
    try:
        return ("ok", fn())
    except ValueError as e:
        return ("raise", str(e))


def _state(fol) -> tuple:
    return (fol.epoch, fol.fingerprint(), fol.snapshots, fol.deltas, fol.batches,
            fol.stale_skipped, fol.frames_applied)


def _snapshot_frame(pkg):
    h = _mk(pkg, "memento")
    h.remove(h.lookup(42))
    return h, pkg.rep.encode_snapshot(h.device_image())


def _tampered(pkg, edit, restamp: bool = True):
    def run():
        frame = np.array(_snapshot_frame(pkg)[1])
        frame = edit(frame)
        if restamp:
            pkg.rep.stamp_crc(frame)
        return _decoded(pkg.rep.decode_frame(frame))
    return [_outcome(run)]


def _flip(frame):
    frame[len(frame) // 2] ^= 1
    return frame


def _set(i, v):
    def edit(frame):
        frame[i] = v
        return frame
    return edit


def _per_epoch(pkg, algo: str = "memento", seed: int = 14):
    h = _mk(pkg, algo)
    pub = pkg.rep.DeltaPublisher(h, batch_epochs=1)
    fol = pkg.follower()
    fol.apply_frames(pub.frames())
    _churn(h, seed, 6)
    return h, pub, fol, pub.frames()


def _mischain(pkg):
    h = _mk(pkg, "dx")
    pub = pkg.rep.DeltaPublisher(h)
    fol = pkg.follower()
    e0 = h.epoch
    h.remove(h.lookup(7))
    out = [_outcome(lambda: fol.apply_frame(pkg.rep.encode_delta(h.device_delta(e0))))]
    fol.apply_frames(pub.frames())
    e1 = h.epoch
    h.remove(h.lookup(99))
    h.remove(h.lookup(100))
    out.append(_outcome(lambda: fol.apply_frame(pkg.rep.encode_delta(h.device_delta(h.epoch - 1)))))
    out.append(_outcome(lambda: fol.apply_frame(pkg.rep.encode_delta(h.device_delta(e1)))))
    return out + [_state(fol)]


def _reorder_and_gap(pkg):
    h, pub, fol, frames = _per_epoch(pkg)
    out = [_outcome(lambda: fol.apply_frames([frames[i] for i in (4, 0, 5, 2, 1, 3)])),
           _state(fol)]
    _churn(h, 15, 3)
    frames = pub.frames()
    out.append(_outcome(lambda: fol.apply_frames(frames[1:])))  # a real gap
    out.append(_outcome(lambda: fol.apply_frames(frames)))
    return out + [_state(fol)]


def _stale(pkg):
    _h, _pub, fol, frames = _per_epoch(pkg, "anchor", 15)
    fol.apply_frames(frames)
    return [_state(fol), _outcome(lambda: fol.apply_frames(frames)), _state(fol),
            _outcome(lambda: fol.apply_frames(frames[2:] + frames[:3])), _state(fol)]


def _stale_snapshots(pkg):
    h, pub, fol, frames = _per_epoch(pkg)
    old = pkg.rep.encode_snapshot(h.device_image())
    fol.apply_frames(frames)
    _churn(h, 16, 2)
    new = pub.frames()
    return [_outcome(lambda: fol.apply_frames([old] + new + [old])), _state(fol)]


def _overlap(pkg):
    """A composed catch-up delta overlapping per-epoch frames already held."""
    _h, pub, fol, frames = _per_epoch(pkg)
    fol.apply_frames(frames[:3])
    over = pub.catchup_frames(fol.epoch - 2)
    return [_outcome(lambda: fol.apply_frames(over + frames[4:])), _state(fol)]


def _chunks_need_snapshot(pkg):
    h = _mk(pkg, "memento")
    pub = pkg.rep.DeltaPublisher(h, batch_epochs=3)
    pub.frames()
    for i in range(7):
        h.remove(h.lookup(1000 + i))
    frames = pub.frames()
    fol = pkg.follower()
    return [[pkg.rep._peek_kind(f) for f in frames], _outcome(lambda: fol.apply_frames(frames)),
            _outcome(lambda: fol.apply_frames(pub.catchup_frames(-1) + frames)), _state(fol)]


def _layout(pkg, follower_kw: dict, packed: bool, delta_packed: bool | None = None):
    h = _mk(pkg, "anchor")
    pub = pkg.rep.DeltaPublisher(h, packed=packed)
    fol = pkg.follower(**follower_kw)
    out = [_outcome(lambda: fol.apply_frames(pub.frames()))]
    if delta_packed is not None:
        e0 = h.epoch
        h.remove(h.lookup(3))
        out.append(_outcome(lambda: fol.apply_frame(
            pkg.rep.encode_delta(h.device_delta(e0), packed=delta_packed))))
    return out


def _algo_mismatch(pkg):
    h, pub, fol, _frames = _per_epoch(pkg)
    other = _mk(pkg, "anchor")
    for _ in range(fol.epoch + 1):
        other.remove(other.lookup(int(other.epoch) * 7 + 1))
    return [_outcome(lambda: fol.apply_frame(
        pkg.rep.encode_delta(other.device_delta(fol.epoch))))]


def _catchup_refusals(pkg):
    h = _mk(pkg, "jump")
    pub = pkg.rep.DeltaPublisher(h)
    out = [_outcome(lambda: pub.catchup_frames(0))]
    pub.frames()
    h.add()
    out.append(_outcome(lambda: pub.catchup_frames(0)))
    pub.frames()
    out += [_outcome(lambda: [f.tolist() for f in pub.catchup_frames(h.epoch)]),
            _outcome(lambda: pub.catchup_frames(h.epoch + 1))]
    return out


FAULTS = {
    "garbage": lambda pkg: [_outcome(lambda: pkg.rep.decode_frame(np.zeros(16, np.int32)))],
    "short": lambda pkg: [_outcome(lambda: pkg.rep.decode_frame(np.zeros(4, np.int32)))],
    "trailing words": lambda pkg: _tampered(
        pkg, lambda f: np.concatenate([f, np.zeros(3, np.int32)])),
    "future algo id": lambda pkg: _tampered(pkg, _set(2, len(ALGORITHMS))),
    "unknown kind": lambda pkg: _tampered(pkg, _set(1, 9)),
    "flipped payload bit": lambda pkg: _tampered(pkg, _flip, restamp=False),
    "tampered epoch": lambda pkg: _tampered(pkg, _set(4, 99), restamp=False),
    "truncated": lambda pkg: _tampered(pkg, lambda f: f[:-2], restamp=False),
    "mischained delta": _mischain,
    "reorder, then a real gap": _reorder_and_gap,
    "stale redelivery": _stale,
    "stale snapshots": _stale_snapshots,
    "overlapping catch-up": _overlap,
    "chunks without a snapshot": _chunks_need_snapshot,
    "compact follower, dense snapshot": lambda pkg: _layout(pkg, dict(compact=True), False),
    "dense follower, packed snapshot": lambda pkg: _layout(pkg, dict(compact=False), True),
    "packed delta on a dense image": lambda pkg: _layout(pkg, {}, False, True),
    "dense delta on a packed image": lambda pkg: _layout(pkg, {}, True, False),
    "another algorithm's delta": _algo_mismatch,
    "catch-up refusals": _catchup_refusals,
}


@pytest.mark.parametrize("case", sorted(FAULTS))
def test_faulty_drains_raise_or_skip_as_the_reference(case):
    want = FAULTS[case](REF)
    assert FAULTS[case](PORT) == want
    flat = str(want)
    if case not in ("stale redelivery", "stale snapshots", "overlapping catch-up"):
        assert "'raise'" in flat  # the case reaches its check


# ---------------------------------------------------------------------------
# replication groups: lags, wire accounting, catch-up
# ---------------------------------------------------------------------------

def _group_view(g) -> tuple:
    return (asdict(g.stats), dict(g.last_publish), g.depth,
            [(f.epoch, f.fingerprint(), f.snapshots, f.deltas, f.batches, f.stale_skipped,
              f.frames_applied) for f in g.followers])


def _rounds(pkg, h, g, rounds: int, seed: int, events: int = 4) -> list:
    out = [g.publish(), _group_view(g)]
    for i in range(rounds):
        _churn(h, (seed, i), events)
        out += [g.publish(), _group_view(g), g.converged(h.device_image())]
    return out


def _group_plain(pkg, algo, **kw):
    h = _mk(pkg, algo)
    g = pkg.group(h, kw.pop("followers", 2), **kw)
    return _rounds(pkg, h, g, 10, 1)


def _offline_interior(pkg, algo, **kw):
    h = _mk(pkg, algo)
    g = pkg.group(h, 3, topology="tree", arity=2, **kw)
    out = [g.publish()]
    g.set_online(0, False)  # interior node 1; its subtree is node 3
    _churn(h, 17, 4)
    out += [g.publish(), _group_view(g)]
    g.set_online(0, True)
    return out + _rounds(pkg, h, g, 2, 18, 3)


def _lagging(pkg, algo, **kw):
    h = _mk(pkg, algo)
    g = pkg.group(h, 2, **kw)
    out = [g.publish()]
    g.set_online(1, False)
    for i in range(2):
        _churn(h, (5, i), 4)
        out += [g.publish(), _group_view(g)]
    g.set_online(1, True)
    return out + _rounds(pkg, h, g, 2, 6)


def _lagging_past_a_snapshot(pkg, algo, **kw):
    """Offline across a log overflow: the catch-up is a snapshot at the
    announced capacities (packed: the mirror as it is)."""
    h = _mk(pkg, algo)
    g = pkg.group(h, 2, **kw)
    out = [g.publish()]
    _churn(h, 7, 4)
    out.append(g.publish())
    g.set_online(0, False)
    _churn(h, 8, 4)
    out.append(g.publish())
    h._DELTA_LOG_CAP = 8
    _churn(h, 9, 30)
    out += [g.publish(), _group_view(g)]
    _churn(h, 10, 4)
    out.append(g.publish())
    g.set_online(0, True)
    return out + _rounds(pkg, h, g, 2, 11)


def _catch_up_and_attach(pkg, algo, **kw):
    h = _mk(pkg, algo)
    g = pkg.group(h, 1, **kw)
    out = [g.publish()]
    _churn(h, 12, 5)
    g.set_online(0, False)
    out.append(g.publish())
    g.set_online(0, True)
    out += [g.catch_up(0), g.catch_up(0), _group_view(g)]
    _churn(h, 13, 3)
    fol = g.attach_follower()
    out += [(fol.epoch, fol.fingerprint()), _group_view(g), g.converged(h.device_image())]
    return out + _rounds(pkg, h, g, 2, 14)


GROUPS = {
    "flat": lambda pkg, algo: _group_plain(pkg, algo),
    "flat, batch_epochs 1": lambda pkg, algo: _group_plain(pkg, algo, batch_epochs=1),
    "tree arity 2": lambda pkg, algo: _group_plain(pkg, algo, followers=7, topology="tree"),
    "tree arity 4": lambda pkg, algo: _group_plain(pkg, algo, followers=7, topology="tree",
                                                   arity=4),
    "tree arity 2, packed, batch_epochs 3": lambda pkg, algo: _group_plain(
        pkg, algo, followers=3, topology="tree", packed=True, batch_epochs=3),
    "offline interior node": lambda pkg, algo: _offline_interior(pkg, algo),
    "catch-up by delta": lambda pkg, algo: _lagging(pkg, algo),
    "catch-up by snapshot": lambda pkg, algo: _lagging_past_a_snapshot(pkg, algo),
    "catch-up by packed snapshot": lambda pkg, algo: _lagging_past_a_snapshot(
        pkg, algo, packed=True),
    "catch_up and attach_follower": lambda pkg, algo: _catch_up_and_attach(pkg, algo),
}


@pytest.mark.parametrize("algo", ALGORITHMS)
@pytest.mark.parametrize("case", list(GROUPS))
def test_group_counts_as_the_reference(case, algo):
    """Lags, ``stats``, ``last_publish``, depth and every follower's epoch,
    fingerprint and counters after every round."""
    want = GROUPS[case](REF, algo)
    got = GROUPS[case](PORT, algo)
    assert got == want
    assert want[-1] is True  # converged in the end


def test_tree_leader_pays_arity_and_relays_the_same_bytes():
    hf, ht = _mk(PORT, "memento"), _mk(PORT, "memento")
    gf = PORT.group(hf, 7)
    gt = PORT.group(ht, 7, topology="tree", arity=2)
    gf.publish()
    gt.publish()
    for burst in range(5):
        _churn(hf, burst, 4)
        _churn(ht, burst, 4)
        gf.publish()
        gt.publish()
    assert gt.followers[-1].fingerprint() == gf.followers[-1].fingerprint()
    assert gf.stats.leader_sends == 7 * gf.stats.frames
    assert gt.stats.leader_sends == 2 * gt.stats.frames
    assert gt.stats.total_bytes == gf.stats.total_bytes
    assert (gt.depth, gf.depth) == (3, 1)
    topo = P.TreeTopology(6, arity=2)
    assert (topo.children(0), topo.children(2), topo.parent(5), topo.interior(),
            topo.depth) == ([1, 2], [5, 6], 2, [0, 1, 2], 2)
    with pytest.raises(ValueError):
        P.TreeTopology(3, arity=0)
    with pytest.raises(ValueError):
        PORT.group(hf, 1, topology="ring")
    ch = P.LoopbackChannel()
    ch.publish([np.ones(4, np.int32), np.full(2, 7, np.int32)])
    assert [g.tolist() for g in ch.drain()] == [[1, 1, 1, 1], [7, 7]] and ch.drain() == []


# ---------------------------------------------------------------------------
# the scenario driver's followers
# ---------------------------------------------------------------------------

#: summary keys that hold host-clock times or name the plane
UNTIMED = ("plane", "us_per_key", "us_mean")
FOLLOWER_KEYS = ("followers", "follower_lag_max", "follower_lag_mean", "fanout_depth",
                 "wire_frames_total", "wire_bytes_total", "leader_sends_total")
REPL_CONFIGS = {
    "2 flat": (2, None, "block"),
    "3 tree arity 2": (3, {"topology": "tree", "arity": 2, "batch_epochs": 0}, "overlap"),
    "3 tree arity 4, packed, batch 1": (3, {"topology": "tree", "arity": 4, "batch_epochs": 1,
                                            "packed": True}, "block"),
}


def _untimed(summary: dict) -> dict:
    return {k: v for k, v in summary.items() if not any(t in k for t in UNTIMED)}


@pytest.mark.parametrize("config", list(REPL_CONFIGS))
@pytest.mark.parametrize("algo", ALGORITHMS)
def test_replay_with_followers_matches_the_reference(algo, config):
    followers, repl_config, sync_mode = REPL_CONFIGS[config]
    kw = dict(algo=algo, sync_mode=sync_mode, followers=followers, repl_config=repl_config)
    trace = dict(seed=2, w=64, storms=2, burst=8, n_keys=256)
    want = ref_replay(ref_make_trace("churn_storm", **trace), plane="jnp", **kw)
    got = replay(make_trace("churn_storm", **trace), device="cpu", **kw)
    alone = replay(make_trace("churn_storm", **trace), device="cpu", algo=algo)
    assert want.ok and got.ok, got.violations
    assert _untimed(got.summary()) == _untimed(want.summary())
    assert all(k in got.summary() for k in FOLLOWER_KEYS)
    assert got.fingerprint == alone.fingerprint
    s = got.summary()
    assert s["followers"] == followers and s["wire_frames_total"] > 0
    assert s["follower_lag_max"] >= 1


# ---------------------------------------------------------------------------
# real processes over gloo
# ---------------------------------------------------------------------------

#: leader and follower workers of the port (rank 0 leads); each prints its
#: epoch, its image fingerprint and a CRC of a lookup of LOOKUP_KEYS
_WORKER = textwrap.dedent("""
    import os, zlib
    import numpy as np
    from repro_torch.launch.mesh import init_distributed
    pid, nproc = int(os.environ["REPL_PID"]), int(os.environ["REPL_NPROC"])
    init_distributed("127.0.0.1:" + os.environ["REPL_PORT"], nproc, pid)
    from repro_torch.core.image_store import DeviceImageStore
    from repro_torch.core.protocol import ALGORITHM_REGISTRY, image_fingerprint, make_hash
    from repro_torch.launch.replicate import (DeltaPublisher, DistributedBroadcast,
                                              FollowerImageStore, TreeBroadcast)
    algo, rounds, burst = os.environ["REPL_ALGO"], int(os.environ["REPL_ROUNDS"]), \\
        int(os.environ["REPL_BURST"])
    tree = os.environ["REPL_TREE"] == "1"
    chan = TreeBroadcast(arity=2) if tree else DistributedBroadcast()
    keys = np.random.default_rng(7).integers(0, 2**32, size=4096, dtype=np.uint32)
    if pid == 0:
        rng = np.random.default_rng(0)
        lifo = ALGORITHM_REGISTRY[algo].lifo_only
        h = make_hash(algo, 64, variant="32")
        store = DeviceImageStore(h, device="cpu")
        pub = DeltaPublisher(h)
        chan.exchange(pub.frames())
        for _ in range(rounds):
            for _ in range(burst):
                if rng.random() < 0.45 and h.working > 8:
                    h.remove(h.size - 1 if lifo else h.lookup(int(rng.integers(1 << 30))))
                else:
                    h.add()
            store.sync()
            chan.exchange(pub.frames())
        out = store.lookup(keys).cpu().numpy()
        print("RESULT", store.epoch, image_fingerprint(store.image()),
              zlib.crc32(out.astype(np.int64).tobytes()), flush=True)
    else:
        fol = FollowerImageStore(device="cpu")
        for _ in range(rounds + 1):
            fol.apply_frames(chan.exchange())
        out = fol.lookup(keys)
        print("RESULT", fol.epoch, fol.fingerprint(),
              zlib.crc32(out.astype(np.int64).tobytes()), flush=True)
""")


def _reference_leader(algo: str, rounds: int, burst: int) -> tuple:
    """The workers' leader, in process, on the reference."""
    rng = np.random.default_rng(0)
    h = ref_make_hash(algo, 64, variant="32")
    store = RefStore(h)
    for _ in range(rounds):
        for _ in range(burst):
            if rng.random() < 0.45 and h.working > 8:
                h.remove(h.size - 1 if lifo_only(algo) else h.lookup(int(rng.integers(1 << 30))))
            else:
                h.add()
        store.sync()
    keys = np.random.default_rng(7).integers(0, 2**32, size=4096, dtype=np.uint32)
    out = np.asarray(store.lookup(keys))
    return (str(store.epoch), ref_fingerprint(store.image()),
            str(zlib.crc32(out.astype(np.int64).tobytes())))


def _run_workers(nproc: int, algo: str, rounds: int, burst: int, tree: bool) -> list:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for pid in range(nproc):
        env = dict(os.environ, REPL_PID=str(pid), REPL_NPROC=str(nproc), REPL_PORT=str(port),
                   REPL_ALGO=algo, REPL_ROUNDS=str(rounds), REPL_BURST=str(burst),
                   REPL_TREE="1" if tree else "0",
                   PYTHONPATH=str(ROOT / "src") + os.pathsep + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen([sys.executable, "-c", _WORKER], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
            line = [ln for ln in out.splitlines() if ln.startswith("RESULT")][-1]
            results.append(tuple(line.split()[1:]))
    finally:
        for p in procs:
            p.kill()
    return results


@pytest.mark.parametrize("algo", [a for a in ALGORITHMS if a in ("memento", "power")])
def test_two_processes_over_gloo_converge(algo):
    """``DistributedBroadcast``: a port leader and a port follower in two
    processes reach one epoch, fingerprint and lookup, the reference
    leader's."""
    results = _run_workers(2, algo, rounds=20, burst=1, tree=False)
    assert results[0] == results[1] == _reference_leader(algo, 20, 1)


def test_four_processes_relay_over_a_gloo_tree():
    """``TreeBroadcast(arity=2)``: rank 1 relays to rank 3, rank 2 is a
    leaf; every rank agrees with the reference leader."""
    results = _run_workers(4, "memento", rounds=12, burst=3, tree=True)
    assert len(set(results)) == 1 and results[0] == _reference_leader("memento", 12, 3)
