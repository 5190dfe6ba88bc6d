"""The port's telemetry plane (``repro_torch.obs``) against the reference's
``repro.obs`` and its instrumented stack: bucket math, quantiles, merges
and exports byte for byte; the null registry, the default's scoping,
thread safety under racing epoch flips; span nesting, the ring, sink
events, ``torch.profiler`` events and NVTX ranges; the ``RouterStats``
view; engine dispatch counts; and replays of every algorithm whose
counters, gauges, histogram counts, span trees and sync/publish events
equal the reference's on the same resolved trace.  The port runs with
``device="cpu"`` (the kernels' plain versions)."""
from __future__ import annotations

import dataclasses
import importlib
import inspect
import math
import sys
import threading
import types

import numpy as np
import pytest
import torch

import repro.obs as ref_obs
from repro.core import ALGORITHMS
from repro.core import DeviceImageStore as RefStore
from repro.core import make_hash as ref_make_hash
from repro.kernels import engine as ref_engine
from repro.serve.router import RouterStats as RefRouterStats
from repro.sim import make_trace as ref_make_trace
from repro.sim import replay as ref_replay
from repro.sim.traces import Trace as RefTrace
from repro_torch import obs
from repro_torch.core.image_store import DeviceImageStore
from repro_torch.core.protocol import make_hash
from repro_torch.kernels import engine
from repro_torch.obs.metrics import BUCKETS_PER_OCTAVE, MAX_EXP, MIN_EXP
from repro_torch.serve.plane import ShardedLookupPlane
from repro_torch.serve.router import RouterStats, SessionRouter
from repro_torch.sim import Trace, TraceEvent, make_trace, replay

# ---------------------------------------------------------------------------
# primitives, held against the reference's

GRID = sorted({0.0, -1.0, 1e-30, 2.0 ** -17, 2.0 ** -16, 1e-3, 0.5, 1.0, 3.7, 1024.0,
               1e6, 2.0 ** 48, 1e80}
              | {2.0 ** (i / 4) for i in range(-70, 200, 3)}
              | {2.0 ** (i / 4) * (1 + 1e-12) for i in range(-70, 200, 5)})


def test_bucket_math_equals_reference():
    assert (BUCKETS_PER_OCTAVE, MIN_EXP, MAX_EXP) == (
        ref_obs.metrics.BUCKETS_PER_OCTAVE, ref_obs.metrics.MIN_EXP, ref_obs.metrics.MAX_EXP)
    assert [obs.bucket_index(v) for v in GRID] == [ref_obs.bucket_index(v) for v in GRID]
    idx = range(MIN_EXP - 2, MAX_EXP + 2)
    assert [obs.bucket_upper(i) for i in idx] == [ref_obs.bucket_upper(i) for i in idx]
    for e in (0, 1, 4, 10):  # exact powers of two on their boundary
        assert obs.bucket_upper(obs.bucket_index(2.0 ** e)) == 2.0 ** e
    assert obs.bucket_index(0.0) == obs.bucket_index(-5.0) == MIN_EXP
    assert obs.bucket_index(1e80) == MAX_EXP


def _feed(h, vals):
    for v in vals:
        h.observe(float(v))
    return h


@pytest.mark.parametrize("dist", ["lognormal", "exponential", "ints"])
def test_histogram_quantiles_and_merge_equal_reference(dist):
    rng = np.random.default_rng(7)
    vals = {"lognormal": lambda: rng.lognormal(3.0, 2.0, 3000),
            "exponential": lambda: rng.exponential(50, 3000),
            "ints": lambda: rng.integers(0, 5000, 3000).astype(float)}[dist]()
    got, want = _feed(obs.Histogram("t"), vals), _feed(ref_obs.Histogram("t"), vals)
    assert got.buckets == want.buckets and got.count == want.count
    qs = (0.0, 0.01, 0.5, 0.95, 0.99, 1.0)
    assert [got.quantile(q) for q in qs] == [want.quantile(q) for q in qs]
    assert got.percentiles() == want.percentiles() and got.mean == want.mean
    for q in (0.5, 0.95, 0.99):  # within one bucket above the true quantile
        true = float(np.quantile(vals, q, method="inverted_cdf"))
        assert true <= got.quantile(q) <= max(true, 2 ** -16) * 2 ** 0.25 * 1.0001
    parts = np.array_split(vals, 3)
    merged = obs.Histogram("m")
    for p in parts:
        merged.merge(_feed(obs.Histogram("p"), p))
    ref_merged = ref_obs.Histogram("m")
    for p in parts:
        ref_merged.merge(_feed(ref_obs.Histogram("p"), p))
    assert merged.buckets == ref_merged.buckets == got.buckets
    assert (merged.count, merged.min, merged.max) == (got.count, got.min, got.max)
    assert merged.sum == pytest.approx(got.sum)
    with pytest.raises(ValueError):
        got.quantile(1.5)


def _fill(mod):
    reg = mod.MetricRegistry()
    reg.counter("eng.hits", op="lookup").inc(7)
    reg.counter("eng.hits", op="diff").inc(2)
    reg.counter("store.syncs").inc(3)
    reg.gauge("lag", follower="0").set(4)
    reg.gauge("ratio").set(0.25)
    h = reg.histogram("lat.us", op="memento.lookup.k1.dense")
    for v in (1.0, 2.0, 2.0, 100.0, 1e-9, 3e7):
        h.observe(v)
    reg.histogram("empty.us")
    return reg


def test_exports_are_byte_equal_to_reference():
    got, want = _fill(obs), _fill(ref_obs)
    assert obs.render_prometheus(got) == ref_obs.render_prometheus(want)
    assert obs.snapshot_text(got) == ref_obs.snapshot_text(want)
    assert got.snapshot() == want.snapshot()
    lines = obs.render_prometheus(got).splitlines()
    assert '# TYPE repro_eng_hits counter' in lines and 'repro_lag{follower="0"} 4' in lines
    assert obs.render_prometheus(obs.NullRegistry()) == ""


def test_sink_jsonl_round_trip_and_bound():
    sink = obs.TelemetrySink(max_events=4)
    for i in range(7):
        sink.emit("tick", i=i, tag="x")
    sink.emit("other", i=7)
    assert sink.emitted == 8 and sink.dropped == 4
    assert [e["i"] for e in sink.events()] == [4, 5, 6, 7]
    assert [e["i"] for e in sink.events("tick")] == [4, 5, 6]
    assert obs.TelemetrySink.parse_jsonl(sink.to_jsonl()) == sink.events()
    ref_sink = ref_obs.TelemetrySink(max_events=4)
    for e in sink.events():
        ref_sink.emit(**e)
    assert ref_sink.to_jsonl() == sink.to_jsonl()


def test_null_registry_is_stateless_and_shared():
    null = obs.NullRegistry()
    assert not null.active
    c = null.counter("anything", label="x")
    assert c is null.histogram("other") is null.gauge("g") is obs.NullRegistry().counter("y")
    c.inc(5)
    c.observe(3.0)
    c.set(2)
    assert c.value == 0 and c.count == 0
    assert null.snapshot() == {"counters": {}, "gauges": {}, "histograms": {}}
    assert null.sink.to_jsonl() == "" and null.metrics() == {}
    with null.span("noop", a=1) as s:
        assert s.name == ""
    assert null.tracer.completed() == [] and null.tracer.tree() == []


def test_default_registry_starts_null_and_is_restored():
    assert not obs.default_registry().active
    reg = obs.MetricRegistry()
    prev = obs.set_default_registry(reg)
    try:
        assert obs.default_registry() is reg
    finally:
        obs.set_default_registry(prev)
    assert not obs.default_registry().active
    on = obs.enable()
    try:
        assert obs.default_registry() is on and on.active
    finally:
        obs.disable()
    assert not obs.default_registry().active


def test_ensure_real():
    assert obs.ensure_real(None).active
    live = obs.MetricRegistry()
    assert obs.ensure_real(live) is live
    assert obs.ensure_real(obs.NullRegistry()).active
    assert obs.ensure_real(obs.NullRegistry()) is not obs.ensure_real(obs.NullRegistry())


def test_registry_labels_and_kind_mismatch():
    reg = obs.MetricRegistry()
    c1 = reg.counter("x.hits", op="lookup")
    assert c1 is reg.counter("x.hits", op="lookup") and c1 is not reg.counter("x.hits", op="diff")
    with pytest.raises(TypeError):
        reg.histogram("x.hits", op="lookup")
    with pytest.raises(ValueError):
        c1.inc(-1)


@pytest.mark.parametrize("kind", ["counter", "gauge", "histogram"])
def test_instruments_exact_under_thread_contention(kind):
    reg = obs.MetricRegistry()
    n, per = 8, 4000

    def worker():
        for _ in range(per):
            if kind == "counter":
                reg.counter("contended").inc()
            elif kind == "gauge":
                reg.gauge("contended").add(1)
            else:
                reg.histogram("contended").observe(3.0)

    ts = [threading.Thread(target=worker) for _ in range(n)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads often: a lost update would show
    try:
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in ts)
    m = reg.metrics()["contended"]
    assert (m.count if kind == "histogram" else m.value) == n * per


def test_registry_survives_racing_epoch_flips():
    """A thread hammers the instrumented ``store.lookup`` while the main
    thread races epoch flips through ``sync_async``: every counter lands."""
    reg = obs.MetricRegistry()
    h = make_hash("memento", 32, variant="32")
    store = DeviceImageStore(h, device="cpu", registry=reg)
    keys = np.arange(64, dtype=np.uint32)
    stop = threading.Event()
    errors: list[Exception] = []
    done = [0]

    def hammer():
        try:
            while not stop.is_set():
                store.lookup(keys)
                done[0] += 1
        except Exception as e:  # surfaced in the main thread
            errors.append(e)

    t = threading.Thread(target=hammer)
    t.start()
    try:
        rng = np.random.default_rng(3)
        for _ in range(12):
            h.remove(int(rng.choice(sorted(h.working_set())[1:])))
            handle = store.sync_async()
            while not handle.poll():
                pass
    finally:
        stop.set()
        t.join(timeout=60)
    assert not t.is_alive() and not errors, errors
    assert done[0] > 0
    assert reg.counter("store.lookups").value == done[0]
    assert reg.counter("store.lookup_keys").value == done[0] * len(keys)
    assert reg.counter("store.syncs").value == reg.counter("store.delta_applies").value == 12
    assert reg.gauge("store.pending").value == 0
    assert len(reg.sink.events("sync")) == 12


# ---------------------------------------------------------------------------
# spans


def test_span_nesting_parent_child_and_order():
    reg = obs.MetricRegistry()
    with reg.span("outer", mode="x") as outer:
        with reg.span("mid") as mid:
            with reg.span("inner"):
                pass
        with reg.span("mid2"):
            pass
    tr = reg.tracer
    assert [s.name for s in tr.completed()] == ["inner", "mid", "mid2", "outer"]
    spans = {s.name: s for s in tr.completed()}
    assert spans["outer"].parent == 0 and spans["outer"].depth == 1
    assert spans["mid"].parent == spans["outer"].id
    assert spans["inner"].parent == spans["mid"].id and spans["inner"].depth == 3
    assert spans["outer"].attrs == {"mode": "x"}
    assert {s.name for s in tr.children_of(outer)} == {"mid", "mid2"}
    assert outer.dur_us >= mid.dur_us >= 0.0
    assert [d for d, _, _ in tr.tree()] == [3, 2, 2, 1]


def test_span_ring_is_bounded_and_spans_emit_sink_events():
    tr = obs.Tracer(max_spans=8)
    for i in range(20):
        with tr.span(f"s{i}"):
            pass
    assert len(tr.completed()) == 8 and tr.dropped == 12
    assert tr.completed()[-1].name == "s19"
    reg = obs.MetricRegistry()
    with reg.span("a", epoch=3):
        pass
    (ev,) = reg.sink.events("span")
    assert ev["name"] == "a" and ev["epoch"] == 3 and ev["depth"] == 1 and ev["dur_us"] >= 0.0


def test_spans_are_profiler_events_on_the_cpu():
    from torch.profiler import ProfilerActivity, profile

    reg = obs.MetricRegistry()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with reg.span("store.sync", mode="block"):
            with reg.span("store.sync.flip"):
                torch.ones(4).sum()
    names = {e.name for e in prof.events()}
    assert {"store.sync", "store.sync.flip"} <= names


@pytest.mark.parametrize("raises", [False, True])
def test_nvtx_ranges_pair_up_on_a_cuda_build(monkeypatch, raises):
    """The tracer pushes an NVTX range a span on a CUDA build of torch and
    pops it on exit, also when the body raises; a CPU build pushes none."""
    calls = []
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", lambda name: calls.append(("push", name)))
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop", lambda: calls.append(("pop",)))
    monkeypatch.setattr(torch.version, "cuda", None)
    with obs.MetricRegistry().span("cpu.build"):
        pass
    assert calls == []
    monkeypatch.setattr(torch.version, "cuda", "12.4")
    reg = obs.MetricRegistry()
    with pytest.raises(RuntimeError) if raises else _nothing():
        with reg.span("store.sync"):
            with reg.span("store.sync.flip"):
                if raises:
                    raise RuntimeError("body failed")
    assert calls == [("push", "store.sync"), ("push", "store.sync.flip"), ("pop",), ("pop",)]
    assert [n for _, n, _ in reg.tracer.tree()] == ["store.sync.flip", "store.sync"]


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


# ---------------------------------------------------------------------------
# the RouterStats view


def test_router_stats_view_keeps_the_reference_dict_api():
    got, want = RouterStats(obs.MetricRegistry()), RefRouterStats(ref_obs.MetricRegistry())
    for s in (got, want):
        s.routed += 5
        s.failovers += 1
        s.affinity_hits += 2
        s.routed = 2  # a smaller value cannot rewind a counter
    assert got.as_dict() == want.as_dict() == {
        "routed": 5, "moved_on_failure": 0, "affinity_hits": 2, "failovers": 1}
    assert repr(got) == repr(want)
    reg = obs.MetricRegistry()
    RouterStats(reg).moved_on_failure += 3
    assert reg.counter("router.moved_on_failure").value == 3
    off = RouterStats(obs.NullRegistry())  # a private registry: never goes dark
    off.routed += 4
    assert off.routed == 4
    with pytest.raises(AttributeError):
        off.nothing


# ---------------------------------------------------------------------------
# engine dispatch counts


def _snap(reg) -> tuple[dict, dict, dict]:
    s = reg.snapshot()
    return s["counters"], s["gauges"], {k: v["count"] for k, v in s["histograms"].items()}


@pytest.mark.parametrize("algo", ALGORITHMS)
def test_engine_counts_equal_reference(algo):
    """Lookups (k = 1, 3, bounded k = 2), epoch diffs (k = 1, 3), a
    cross-algorithm diff, a walk step and a bounded assignment count the
    reference's dispatches, keys, walk steps, rounds and moved keys."""
    w = 40
    keys = np.random.default_rng(1).integers(0, 2**32, size=300, dtype=np.uint32)
    other = "anchor" if algo != "anchor" else "memento"
    regs = []
    for pkg, mk, store_of, e, kw in (
            ("ref", ref_make_hash, lambda h: RefStore(h), ref_engine, {"plane": "jnp"}),
            ("port", make_hash, lambda h: DeviceImageStore(h, device="cpu"), engine,
             {"device": "cpu"})):
        h = mk(algo, w, capacity=4 * w, variant="32")
        store = store_of(h)
        oh = store_of(mk(other, w, capacity=4 * w, variant="32"))
        for b in ([w - 1, w - 2] if algo in ("jump", "power") else [3, 17]):
            h.remove(b)
        store.sync()
        reg = (ref_obs if pkg == "ref" else obs).MetricRegistry()
        prev = (ref_obs if pkg == "ref" else obs).set_default_registry(reg)
        try:
            img = store.image()
            load = np.zeros(e.bounded_load_len(img), np.int32)
            e.engine_lookup(keys, img, **kw)
            e.engine_lookup(keys, img, k=3, **kw)
            e.engine_lookup(keys, img, k=2, load=load, cap=50, **kw)
            e.engine_diff(keys, store.previous_image(), img, **kw)
            e.engine_diff(keys, store.previous_image(), img, k=3, **kw)
            e.engine_diff(keys, oh.image(), img, **kw)
            e.engine_chain_walk(keys, np.zeros(len(keys), np.int32), np.ones(len(keys), bool),
                                img, load, 4, **kw)
            e.bounded_assign(keys, img, load, int(math.ceil(1.25 * len(keys) / (w - 2))), **kw)
        finally:
            (ref_obs if pkg == "ref" else obs).set_default_registry(prev)
        regs.append(reg)
    want, got = (_snap(r) for r in regs)
    assert got == want
    c = got[0]
    assert c["engine.lookups"] == 3 and c["engine.diffs"] == 3 and c["engine.bounded_assigns"] == 1
    assert c["engine.walk_steps"] == 1 + c["engine.bounded_rounds"]
    assert c["engine.dispatches"] == 7 + c["engine.bounded_rounds"]


def test_telemetry_off_reads_no_clock(monkeypatch):
    """With the default NullRegistry no instrumented path reads the
    clock: a replay with followers, route events and a sharded plane runs
    with the instrumented modules' ``perf_counter_ns`` raising."""
    from repro_torch.core import image_store
    from repro_torch.serve import plane, router

    def boom():
        raise AssertionError("a clock read with telemetry off")

    for mod in (engine, image_store, router, plane):
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(perf_counter_ns=boom))
    assert not obs.default_registry().active
    res = replay(make_trace("churn_storm", 1, w=40, storms=2, burst=4, n_keys=128),
                 device="cpu", followers=2, sharded=True)
    assert res.ok and "telemetry" not in res.summary()
    res = replay(make_trace("session_affinity", 0), device="cpu", sync_mode="overlap")
    assert res.ok


# ---------------------------------------------------------------------------
# replays against the reference


def _assign_trace() -> Trace:
    """A hand-built trace with ``assign`` events at c = 1.25 (no generator
    emits one), across a removal and a join."""
    ev = [TraceEvent("assign", n_keys=400, cap_c=1.25),
          TraceEvent("remove", count=4),
          TraceEvent("lookup", n_keys=200, k=2),
          TraceEvent("assign", n_keys=300, cap_c=1.25),
          TraceEvent("add", count=2),
          TraceEvent("assign", n_keys=250, cap_c=1.25)]
    return Trace("assign", 4, 40, ev)


CASES = {
    "churn_storm": (lambda: make_trace("churn_storm", 0, w=32, storms=2, burst=4, n_keys=128), {}),
    "incremental_k2": (lambda: make_trace("incremental", 0, w=40, n_keys=256),
                       dict(replica_k=2, probe_keys=256)),
    "churn_storm_tree": (lambda: make_trace("churn_storm", 2, w=32, storms=2, burst=4, n_keys=128),
                         dict(followers=2, repl_config={"topology": "tree", "arity": 1})),
    "session_affinity": (lambda: make_trace("session_affinity", 0), {}),
    "serving_failure": (lambda: make_trace("serving_failure", 0), dict(followers=1)),
    "assign": (_assign_trace, dict(sync_mode="overlap")),
}

#: sink fields stamped by the host clock
TIMED = ("start_us", "dur_us")


def _events(reg, kind: str) -> list[dict]:
    return [{k: v for k, v in e.items() if k not in TIMED} for e in reg.sink.events(kind)]


def _telemetry(reg) -> dict:
    counters, gauges, hists = _snap(reg)
    return {"counters": counters, "gauges": gauges, "histograms": hists,
            "tree": [(d, n) for d, n, _ in reg.tracer.tree()],
            "sync": _events(reg, "sync"), "publish": _events(reg, "publish"),
            "spans": [e["name"] for e in reg.sink.events("span")]}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("algo", ALGORITHMS)
def test_replay_telemetry_equals_reference(algo, case):
    make, kw = CASES[case]
    resolved = ref_replay(RefTrace.from_json(make().to_json()), algo=algo, plane="jnp",
                          **kw).resolved
    want = ref_replay(resolved, algo=algo, plane="jnp", telemetry=True, **kw)
    trace = Trace.from_json(resolved.to_json())
    got = replay(trace, algo=algo, device="cpu", telemetry=True, **kw)
    off = replay(trace, algo=algo, device="cpu", **kw)
    assert not obs.default_registry().active and not ref_obs.default_registry().active
    assert want.ok and got.ok and off.ok, got.violations
    assert got.fingerprint == off.fingerprint == want.fingerprint
    t_got, t_want = _telemetry(got.metrics.obs), _telemetry(want.metrics.obs)
    for key in t_want:
        assert t_got[key] == t_want[key], key
    assert t_got["counters"]["sim.events"] == len(trace.events)
    assert "telemetry" in got.summary() and "telemetry" not in off.summary()
    assert got.summary()["telemetry"]["counters"] == want.summary()["telemetry"]["counters"]


def test_replay_accepts_an_external_registry_and_scopes_the_default():
    reg = obs.MetricRegistry()
    res = replay(make_trace("churn_storm", 0, w=32, storms=1, burst=4, n_keys=64),
                 device="cpu", telemetry=reg)
    assert res.metrics.obs is reg and not obs.default_registry().active
    assert reg.counter("sim.events").value == len(res.metrics.records)
    assert reg.counter("sim.delta_words").value == reg.counter("store.delta_words").value > 0
    text = obs.render_prometheus(reg)
    parsed = {}
    for line in text.splitlines():
        if not line.startswith("#"):
            name, value = line.rsplit(" ", 1)
            parsed[name] = value
    for key, value in reg.snapshot()["counters"].items():
        name, _, labels = key.partition("{")
        assert parsed[obs.export.prom_name(name) + ("{" + labels if labels else "")] == str(value)


@pytest.mark.parametrize("k", [1, 2])
def test_sharded_replay_counts_its_batches(k):
    """``sharded=True``: the plane counts every lookup batch and its keys,
    its repins follow the store's flips, the engine counts none of the
    plane's chunks, and the fingerprint is the unsharded replay's."""
    trace = make_trace("incremental", 0, w=40, n_keys=300)
    trace.events = [dataclasses.replace(ev, k=k) if ev.op == "lookup" else ev
                    for ev in trace.events]
    plain = replay(trace, device="cpu", telemetry=True)
    got = replay(trace, device="cpu", telemetry=True, sharded=True)
    assert got.ok and got.fingerprint == plain.fingerprint
    lookups = [ev for ev in trace.events if ev.op == "lookup"]
    c, _, hists = _snap(got.metrics.obs)
    assert c["plane.batches"] == hists["plane.shard_keys"] == hists["plane.dispatch.us"] \
        == len(lookups)
    assert c["plane.keys"] == sum(ev.n_keys for ev in lookups)
    assert c["plane.repins"] == 1 + sum(ev.op == "remove" for ev in trace.events)
    assert "store.lookups" not in c
    pc = _snap(plain.metrics.obs)[0]
    assert c["engine.dispatches"] == pc["engine.dispatches"] - pc["store.lookups"]


def test_plane_counts_on_a_device_list():
    reg = obs.MetricRegistry()
    h = make_hash("memento", 50, variant="32")
    store = DeviceImageStore(h, device="cpu")
    plane = ShardedLookupPlane(store, devices=["cpu", "cpu", "cpu"], registry=reg)
    batches = [np.arange(n, dtype=np.uint32) for n in (100, 1000, 7)]
    prev = obs.set_default_registry(reg)
    try:
        plane.lookup(batches[0])
        h.remove(4)
        store.sync()
        outs = list(plane.route_stream(batches))
    finally:
        obs.set_default_registry(prev)
    assert [len(o) for o in outs] == [100, 1000, 7]
    c, _, hists = _snap(reg)
    assert c["plane.batches"] == 4 and c["plane.keys"] == 1207 and c["plane.repins"] == 2
    assert "engine.dispatches" not in c
    assert reg.histogram("plane.shard_keys").buckets == {
        obs.bucket_index(128): 3, obs.bucket_index(384): 1}


def test_router_counts_its_batches_and_streams():
    reg = obs.MetricRegistry()
    r = SessionRouter(64, device="cpu", replicas_k=2, registry=reg)
    ids = np.arange(500, dtype=np.uint64)
    prev = obs.set_default_registry(reg)
    try:
        r.route_batch(ids)
        r.mark_failed(3)
        r.route_batch(ids)
        r.fail_replica(3)
        r.restore_replica()
        list(r.route_stream([ids, ids[:100]], devices=["cpu"]))
        r.route(7)
    finally:
        obs.set_default_registry(prev)
    c, _, hists = _snap(reg)
    assert c["router.batch_keys"] == 1000 and c["router.stream_batches"] == 2
    assert c["router.routed"] == 601 and c["router.failover_marks"] == 2
    assert c['router.membership_events{op="fail"}'] == c['router.membership_events{op="restore"}'] == 1
    assert hists["router.route_batch.us"] == 2 and hists['router.replica_set.us{k="2"}'] == 1
    assert c["store.lookups"] == 2 and c["store.syncs"] == 2
    assert [n for _, n, _ in reg.tracer.tree()][-2:] == ["store.sync", "router.restore_replica"]


# ---------------------------------------------------------------------------
# coverage: every public method of a serving surface records or says why not

SURFACES = [
    ("repro_torch.core.image_store", ("DeviceImageStore", "SyncHandle")),
    ("repro_torch.serve.router", ("SessionRouter",)),
    ("repro_torch.serve.plane", ("ShardedLookupPlane",)),
    ("repro_torch.launch.replicate", ("DeltaPublisher", "FollowerImageStore",
                                      "ReplicationGroup")),
]

#: source fragments that show a method (or its delegate) records
INSTRUMENTED = ("_obs(", "self.telemetry", "_record_batch(", "_account(",
                "registry", "ensure_real(", ".span(", ".counter(",
                ".histogram(", ".gauge(")


def _public_methods(cls):
    for name, member in vars(cls).items():
        if name.startswith("_"):
            continue
        fn = member.fget if isinstance(member, property) else member
        if callable(fn):
            yield name, fn


@pytest.mark.parametrize("modname,classes", SURFACES, ids=[m for m, _ in SURFACES])
def test_serving_surfaces_fully_instrumented(modname, classes):
    mod = importlib.import_module(modname)
    missing, exempt = [], []
    for clsname in classes:
        for name, fn in _public_methods(getattr(mod, clsname)):
            src = inspect.getsource(fn)
            if "obs-exempt" in src:
                exempt.append(name)
                continue
            if not any(tok in src for tok in INSTRUMENTED):
                missing.append(f"{clsname}.{name}")
    assert not missing, (f"uninstrumented public methods on {modname}: {missing}: record "
                         "telemetry or mark the def with `# obs-exempt: <why>`")


def test_the_coverage_scan_catches_a_bare_method():
    class Bare:
        def lookup(self, keys):
            return keys

    assert [n for n, fn in _public_methods(Bare)
            if not any(t in inspect.getsource(fn) for t in INSTRUMENTED)] == ["lookup"]
