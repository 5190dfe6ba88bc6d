#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

1. Prints the card, its power limit, the torch and CUDA versions, and
   builds every kernel of ``src/repro_torch/kernels/csrc`` with ``nvcc``
   (time, and the ``ptxas -v`` register and spill lines).
2. Holds each kernel against its plain torch version on the card, at the
   paper's largest size (10^6 working buckets, 2^20 keys), exactly, and
   times kernel, plain version and (for the delta apply)
   ``Tensor.index_put``, beside the least time the card could take for
   the same work: the Memento kernels and the delta apply, then the
   lookup and diff kernels of AnchorHash, DxHash, JumpHash and PowerHash
   on a stable state and after a one-shot removal of 90 % (capacity
   factor 4 for the fixed-capacity ones); for ``dx_lookup`` it also logs
   its lane group G, the probes a key and the warp rounds a key (a model),
   for ``dx_diff`` its lane group G, for ``anchor_lookup`` the passes
   and successor reads a key and the round trips and distinct words a key
   (a model) of ``anchor_one`` and of a loop that loads K[h] with A[h], and
   for ``power_lookup`` its draws and levels a key and warp issue slots a
   key (a model, ``power_rounds``); ``power_diff`` also across one
   removal (n = 10^6 -> 10^6 - 1, one top level: the pair kernel).
3. Drives the first slice's path, ``SessionRouter.route_batch`` on 2^20
   session ids at n = 10^6, through the paper's scenarios (stable,
   one-shot 90 % removal, incremental removals) and failover in overlap
   mode, checking every batch against the plain version, and asserts that
   every Memento kernel and the delta apply were launched on that path.
4. Drives the second slice's path, ``repro_torch.sim.replay(plane="device")``,
   for all five algorithms over the stable, one-shot and incremental
   scenarios at w = 10^6 with 2^20 keys per lookup and probe batch: no
   checker may report a violation, a sample of every lookup batch must
   equal the host, and every lookup and diff kernel must be launched;
   then one ``replica_k = 2`` replay of incremental (Memento, the
   replica-stability checker on, 2^12 probe keys: cut from 2^14 when
   phases 8 and 9 were added, to keep the run well inside its time
   limit).  4b replays every
   scenario at its default size for every algorithm on the card and on
   the host: equal fingerprints (``session_affinity`` launches every
   ``{algo}_replica``).
5. Drives the third slice's path: ``route_batch`` with ``replicas_k = 3``
   over 10^6 replicas and 2^20 session ids through a marked replica, its
   removal and its restore; ``bounded_assign`` of 2^20 keys at c = 1.25;
   and for every algorithm, on phase 2's stable and one-shot states, the
   k = 3 replica lookup, the bounded k = 2 lookup, the k = 3 epoch diff
   and a chain-walk step.  Every ``{algo}_replica``, ``{algo}_replica_diff``
   and ``{algo}_walk`` kernel must be launched on that path; then each
   result is held against its plain version on the card and 2048 keys
   against the host, and each kernel is timed beside its bound;
   ``dx_replica``'s and ``dx_walk``'s lane groups are logged from the
   library; ``memento_walk``'s lookup rounds and lane lookups a warp (a
   model over the plain walk's steps) at one step a round and with a
   look-ahead of 2, 4 and 32 steps, and ``jump_walk``'s the same;
   ``anchor_replica_diff`` on both of its branches, stable -> one-shot
   (epochs that nest: one walk through the one-shot epoch's tables) and
   a pair whose removal stacks part (remove x, restore it, remove y: two
   walks), each with the branch its check took and the check's own time;
   ``anchor_walk`` also with every lane pending, beside its warp and slot
   model (``walk_slots``: one thread a lane); then
   the card's random-word rate
   (``torch.index_select`` of 2^24 random int32 words from tables of 4 to
   128 MB, a yardstick no entry calls) beside each AnchorHash entry's words
   a key, G words/s and gather-rate ms (its words at that rate).
6. Drives the fourth slice's path, the packed and compact layouts:
   ``SessionRouter(10^6, compact_images=True).route_batch`` on 2^20 ids
   through stable, 1024 removals (one sync), 128 single removals (one
   packed delta each), 64 restores (tombstones) and a one-shot 90 %
   removal (a snapshot), each batch equal over the whole batch to a dense
   store on the same state and 4096 ids to the host; ``migration_diff``
   between packed epochs; ``replicas_k = 3`` failover on a packed store;
   ``bounded_assign`` of 2^20 keys, the bounded k = 2 lookup, the k = 3
   diff and a walk step on the packed one-shot state;
   ``ops.memento_lookup(table="compact")``; Memento at n = 10^4 and
   AnchorHash at a = 32000 (int16 tables) through their own packed
   routers; hand-built int8 images through a packed delta and every
   mode.  Every ``{memento,anchor}_packed_*`` kernel,
   ``memento_compact_lookup`` and the int16 and int8 delta applies must
   be launched on that path; then each is held against its plain version
   on the card at every width and timed beside its bound (each delta
   apply in the form its length takes, ``delta_apply.apply_form``, beside
   a launch floor: one ``add_`` of a one-element tensor, a yardstick);
   ``memento_packed_replica`` on every state of the path (stable, 1024
   removals, one-shot, int16, int8), logging the table sectors a key it
   loads (a model over the plain reader's counters) and the rate that
   gives at its time; ``memento_packed_walk`` on every width, logging the
   round trips a lane (a model, checked against the plain walk's
   counters), the lane use one thread a lane leaves over warps of 32 and
   the round trips a second at its time; each packed AnchorHash entry's
   words a key, G words/s and gather-rate ms.
7. Drives the fifth slice's path on phase 6's one-shot state: Memento's
   compact table at k = 3 and bounded k = 2 (c = 1.25) through
   ``engine_lookup(table="compact")``, and a cross-algorithm
   ``engine_diff`` (AnchorHash one-shot -> packed Memento one-shot, k = 1
   and k = 3).  ``memento_compact_replica`` must be launched on that path;
   then it is held against its plain version and the dense replica sets of
   the same host state, the diff against each image's plain lookup and
   the host, and each is timed.  Then ``memento_lookup`` and
   ``memento_packed_lookup`` are timed on their stable and one-shot
   states warm and cold (L2 flushed by a 128 MiB write before each
   launch).
8. Drives the training substrates: for every algorithm an
   ``ElasticCluster`` of 10^4 hosts and 2^20 data shards (capacity 4 x 10^4
   for the fixed-capacity ones) through 64 single host failures (random
   hosts; the last host for JumpHash and PowerHash) and 32 joins, each
   followed by ``replica_movement()`` at k = 3: every plan minimal or
   monotone, every moved shard and replica set equal to the host, 4096
   shards of the front epoch equal to the host, and on the first failure
   and the first join the whole diff (k = 1 and 3) equal to the plain
   versions on the card.  Every ``{algo}_diff``, ``{algo}_replica_diff``
   and ``delta_apply`` must be launched on that path.  Then
   ``AsyncCheckpointer(keep=2)`` saves three steps of 64 tensors on the
   card (256 MiB, float32 and int32), restored bit-equal, each leaf in the
   host MementoHash's bucket, with the device->host and write ms; and a
   ``DataPipeline`` over 4096 shards on 64 hosts through batches, a
   resume and a host failure.
9. Drives the sharded streaming plane: ``SessionRouter(10^6).route_stream``
   of 16 batches of 2^20 session ids on every GPU and on two entries of
   one card (two streams), in block and overlap mode, a replica failed
   before batch 5 and restored before batch 11; every batch equal to
   ``route_batch`` of its ids at the epoch it was served at.  Then a
   ``replicas_k = 3`` stream with one replica marked (none routed to it),
   a ``compact_images=True`` stream, and ``repro_torch.sim.replay(sharded=
   True)`` of every scenario x every algorithm at its default size (equal
   to 4b's fingerprints) and of Memento's one-shot at w = 10^6 with 2^20
   keys (equal to phase 4's).  ``memento_lookup``, ``memento_replica``,
   ``memento_packed_lookup``, ``delta_apply`` and every ``{algo}_lookup``
   must be launched on that path.  Logs the stream's keys/s beside a loop
   of ``route_batch`` on the same batches, and the card's lookup busy
   share during the stream (CUDA events), a record: one card cannot show
   fan-out.  Each of phases 8 and 9 logs its wall time.
10. Drives replication on the card: for every algorithm
   ``ScenarioDriver(make_trace("churn_storm_xl", w=10^6), followers=3,
   repl_config={"topology": "tree", "arity": 2})`` (AnchorHash at w = 10^5,
   a = 4 x 10^5: its constructor's Python removals at a = 4 x 10^6 took
   most of the phase) in overlap mode (the
   convergence checker after every synced event, no violation, the
   fingerprint of a replay without followers), and packed: Memento at w =
   10^6 and at 10^4 (int16 slots, random victims) and AnchorHash on
   ``churn_storm`` at a = 32000 (int16 A/K); after each, every follower's
   lookups of 2^20 keys at k = 1 and 3 equal the leader store's.  Then on
   Memento at w = 10^6 through random storms: a follower offline across a
   storm repaired by a delta catch-up, one attached mid-stream (a snapshot
   catch-up), ``batch_epochs`` 0, 1 and 3 to one fingerprint, flat against
   tree fan-out (arity 2 and 4, 7 followers: frames, bytes, leader sends),
   the dense and packed snapshot bytes and a follower's drain ms.
   ``delta_apply``, ``delta_apply_int16``, every ``{algo}_lookup``,
   ``{algo}_replica`` and ``{algo}_diff``, ``memento_packed_lookup`` and
   ``anchor_packed_lookup`` must be launched on that path (the leader's
   comparand lookups and the replays without followers are not counted).
   Then real processes over gloo, all on this card (its compute mode must
   be ``Default``): a 4-process ``TreeBroadcast(arity=2)`` led at Memento
   w = 10^6 and a 2-process ``DistributedBroadcast`` over PowerHash, 12
   rounds of 3-event bursts; every rank's epoch, fingerprint and 2^20-key
   lookup CRC agree, each rank launched the lookup entry (and
   ``delta_apply`` where the image has a table; PowerHash has none) in its
   own process; the snapshot and burst round ms are logged.
11. Drives the telemetry plane (``repro_torch.obs``): two
   ``SessionRouter``s over one host state, one with a ``MetricRegistry``
   injected (and installed as the process default), route the same 10
   batches of 2^20 ids in turns on a stable n = 10^6 state and on phase 2's
   one-shot state: equal outputs, ``router.batch_keys``, ``store.lookups``,
   ``engine.dispatches`` and ``engine.keys`` equal to the batches and keys
   routed, and the p50 batch ms on and off (a record).  A telemetered
   Memento one-shot replay at w = 10^6 with 2^20 keys to phase 4's
   fingerprint, ``sim.delta_words == store.delta_words``.  For every
   algorithm ``churn_storm`` with two followers replayed twice with
   ``telemetry=True`` and once without: one fingerprint, equal counters,
   gauges and histogram counts, and each Prometheus exposition parsing
   back to its snapshot's counters.  One telemetered Memento storm under
   ``torch.profiler`` (CPU and CUDA activities): every span of the
   tracer's ring is a CPU event of the profile; the device events it holds
   are logged by name (the spans' ranges on the device, copies, kernels:
   count, device us, share of the wall), nothing asserted of them, beside
   the card's busy share (the union of the kernel and copy intervals).  ``memento_lookup``,
   ``memento_diff``, ``delta_apply`` and every ``{algo}_lookup`` and
   ``{algo}_diff`` must be launched on that path.
12. Prints one ``{"kernels": [...]}`` line, then ``{"ok": true, ...}`` last.

Any mismatch or error exits non-zero.  Without a GPU, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"

N = 10**6                 # buckets: the paper's largest size (§VIII)
KEYS = 2**20              # keys per batch
CAPACITY_FACTOR = 4       # a/w of the fixed-capacity algorithms (the traces' default)
HOST_SAMPLE = 4096        # keys of each replayed lookup batch checked on the host
KERNEL_SAMPLE = 2048      # keys of each phase-5 kernel result checked on the host
REPLICAS_K = 3            # phase 5: replica slots of the router and the lookups
BOUNDED_K = 2             # phase 5: slots of the bounded lookup
CAP_C = 1.25              # phase 5: bounded-load factor
ASSIGN_HOST_KEYS = 2**14  # phase 5: keys of the bounded assignment held against the host
REPLICA_PROBE_KEYS = 2**12  # phase 4: probe keys of the replica_k = 2 replay
REPLAYED = ("stable", "oneshot", "incremental")  # the paper's §VIII scenarios
ONESHOT_FRACTION = 0.9    # one-shot scenario: 90 % of the nodes removed
INCREMENTAL_STAGES = (0.1, 0.3, 0.5)  # growing removal fraction (phase 2)
INCREMENTAL_EVENTS = 128  # single removals on the main path, one delta each
DELTA_TABLE = 2_000_000   # store capacity at n = 10^6 (headroom 2)
DELTA_UPDATES = 4096
SEED = 0
SLEEP_CYCLES = 200_000_000  # ~0.1 s of GPU clock: covers issuing a timed run

# Peak rates of one H100 SXM (NVIDIA data sheet): 3.35 TB/s of HBM,
# 67 TFLOP/s float32 outside
# the tensor cores.  The float32 rate counts an FMA as 2 operations on 128
# lanes per SM; Hopper has 64 INT32 lanes per SM (architecture white
# paper), so its INT32 issue rate is 67e12 / 2 / 2 operations per second.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 2 / 2

# 32-bit operations of the lookup, counted from csrc/engine.cu, each at
# one issue slot (a lower bound: a correctly rounded divide or an integer
# modulo takes several):
#   per key:            index, key load, bucket store, final repl read + test
#   per jump32 step:    step hash (mul-add, xor, fmix32 = 8, shift) 11,
#                       float part (2 converts, 2 adds, mul, divide, floor,
#                       min, compare, convert) 10, loop counter 1
#   per Alg. 4 pass:    hash2 (mul-add, 2 x fmix32, xor) 18, modulo 1, first
#                       chain read + test 2 (the chain's last read is the
#                       next pass's repl read: memento_one does not read it
#                       again)
#   per chain read:     move, read, test
# The plain version reads repl(d) again at each pass, as the reference
# does, but leaves that read out of its counters (the readers' below too).
OPS_PER_KEY, OPS_PER_STEP, OPS_PER_OUTER, OPS_PER_READ = 6, 22, 21, 3
# The other bodies of engine.cu, counted the same way.  Each algorithm:
# (ops per key, {plain-version work counter: ops per lane-iteration}).
#   anchor: per key index, key load, store, fmix32 8, modulo, A read + test
#           = 14; per removed bucket met (outer): hash2 18, modulo, A[h]
#           read + compare 2, move, A[b] read + test 2 = 24; per successor
#           read: K read, A read, compare = 3
#   dx:     per key index, key load, store, return = 4; per probe: hash2
#           18, modulo, shift, word read, shift, and, test, loop 2 = 26
#   jump:   per key 4; per step as above, 22
#   power:  per key index, key load, store 3, masks and salt index 4 (the
#           top level L and its mask are the launch's, made once), first
#           draw: its salt's inner mix loaded from the compiler's table,
#           xor, fmix32 8 = 10 (hash2 is 18: the inner mix is the salt's
#           alone), and, compare, accept test 3 = 23; per extra draw: the
#           mix 10, add, and, compare 2, counter 2 = 16; per level
#           descended: the mix 10, salt index 2, mask 3, compare 2, loop 2
#           = 19
ALGO_OPS = {
    "anchor": (14, {"outer": 24, "read": 3}),
    "dx": (4, {"probe": 26}),
    "jump": (4, {"step": OPS_PER_STEP}),
    "power": (23, {"draw": 16, "level": 19}),
}
# The phase-5 kernels, counted the same way over the plain versions'
# counters ("lookups", "try", "compare", "walk"):
#   per salted try:         salt test and increment, loop 3, hash2 18 = 21;
#                           bounded adds the salt-0 test and the load read
#                           and compare, 3
#   per duplicate compare:  read of the earlier slot, compare = 2
#   per lookup beyond a key's first: the body's per-key ops less the key's
#                           index, load and store (3)
#   per slot:               its store, 1
#   per walk step:          probe increment, bound compare, hash2 18, load
#                           read and compare 2, loop = 23; per walk lane:
#                           chain, probe and pending loads, three stores,
#                           first load read and compare = 8
#   per DxHash probe two epochs of one a share: probe i of a salted key
#                           draws the same candidate hash2(key', i) % a in
#                           both; hash2 18, modulo, word-index shift = 20
#                           are made once (the word read, bit test and loop
#                           stay each epoch's)
#   per key two PowerHash epochs of one top level share: index and key
#                           load 2, masks and salt index 4, the first draw's
#                           mix 10 and its mask = 17 (each epoch keeps its
#                           accept test, and the diff its stores)
OPS_PER_TRY, OPS_PER_BOUNDED_TRY, OPS_PER_COMPARE = 21, 3, 2
OPS_PER_POWER_SHARED_KEY = 17
OPS_PER_SHARED_PROBE = 20
OPS_PER_WALK_STEP, OPS_PER_WALK_LANE = 23, 8
# The packed and compact readers (phase 6), over the plain readers'
# counters ("bit", "start", "slot"), on top of the dense read's load and
# test counted above:
#   per bitmap read:   word index shift, bit index and, shift, and = 4
#   per probe started: multiply-add, fmix32 8, mask = 11 (Memento packed:
#                      only a removed bucket's read probes; compact: all)
#   per slot read:     slot load, compare with the bucket, sentinel test,
#                      advance, mask, loop test = 6
OPS_PER_BIT, OPS_PER_START, OPS_PER_SLOT = 4, 11, 6
PACKED_REMOVALS = 1024    # phase 6: the removals of the bench_compact state
PACKED_RESTORES = 64      # phase 6: restores after the single removals (tombstones)
SMALL_N = 10**4           # phase 6: Memento with int16 slots
ANCHOR_A, ANCHOR_W = 32000, 8000  # phase 6: AnchorHash with int16 A/K
TINY_N = 100              # phase 6: the hand-built int8 images
SMALL_EVENTS = (20, 5)    # phase 6: removals, then restores, on the small routers
BREAKDOWN_REPS = 5        # phase 6: iterations of each state's breakdown
BATCH_EVERY = 8           # phase 6: a batch after every 8th single removal or restore
FLUSH_BYTES = 128 << 20   # phase 7: written before each cold launch (the L2 is 50 MB)
GATHER_WORDS = 2**24      # phase 5: random int32 words of each gather-rate probe
GATHER_TABLE_MB = (4, 16, 32, 48, 64, 128)  # phase 5: the probe's table sizes (10^6 bytes)
# phase 5: steps a round of the memento_walk and jump_walk look-ahead that
# engine.cu's header lists among the designs that lost, for the walks' warp
# models
WALK_LOOKAHEAD_STEPS = (2, 4, 32)
# phase 5: walk_kernel's lanes a block (engine.cu's kThreads), for anchor_walk's model
WALK_BLOCK = 256
# the AnchorHash diffs' check (anchor_nest_kernel, anchor_nest_part_kernel),
# per bucket: the two A loads 2, their tests and the least and largest 4,
# the K test 2 = 8
OPS_PER_NEST_BUCKET = 8
# PowerHash's warp model (power_rounds): ALGO_OPS["power"] with every draw
# hashed in full (hash2 18 where the kept kernel loads the salt's mix, 10),
# as PR 24's kernel and the top level made once a launch ran them
POWER_HASH2_OPS = (31, 24, 27)
COLD_REPS = 15            # phase 7: cold launches a median is taken over
CLUSTER_HOSTS = 10**4     # phase 8: the data-loading fleet
CLUSTER_SHARDS = 2**20    # phase 8: data-file shards placed on it
CLUSTER_FAILS, CLUSTER_JOINS = 64, 32  # phase 8: single host failures, then joins
CLUSTER_K = 3             # phase 8: replica sets of the movement plans
CKPT_LEAVES = 64          # phase 8: tensors of the checkpointed state
CKPT_BYTES = 256 << 20    # phase 8: the state's bytes, float32 and int32 halves
CKPT_STEPS = 3            # phase 8: saves, two kept
PIPE_SHARDS, PIPE_HOSTS = 4096, 64  # phase 8: the DataPipeline's placement
STREAM_BATCHES = 16       # phase 9: session-id batches of each route_stream
STREAM_FAIL_AT, STREAM_RESTORE_AT = 4, 10  # phase 9: events before these batches
STREAM_SIDE_BATCHES = 4   # phase 9: batches of the failover and packed streams
REPL_FOLLOWERS = 3        # phase 10: followers of each replay (a tree of arity 2)
REPL_ANCHOR_BURST = 500   # phase 10: removals a storm of the packed AnchorHash replay
REPL_SMALL_W = 10**4      # phase 10: the packed Memento replay with int16 slots
# phase 10: AnchorHash's dense storm fleet, churn_storm_xl's default (a = 4 x 10^5).
# Its constructor replays a - w removals in Python: at w = 10^6 the replay and
# its comparand took 185 s of a 1192 s run, too close to the run's time limit
REPL_ANCHOR_W = 10**5
REPL_STORMS = 3           # phase 10: storms of the pull paths on Memento w = N
REPL_PULL_REMOVALS = 256  # phase 10: random removals a storm (then half as many adds)
REPL_FANOUT = 7           # phase 10: followers of the flat and tree groups
GLOO_ROUNDS, GLOO_BURST = 12, 3  # phase 10: the gloo leader's rounds, events a round
GLOO_TIMEOUT = 300        # phase 10: seconds every process of a gloo run has
TELEMETRY_BATCHES = 10    # phase 11: route_batch batches with telemetry off, and on
# phase 10: code run first in each gloo worker (the CPU rehearsal routes the
# kernels there); empty on the card
WORKER_PRELUDE = ""
# phase 10: a rank of a gloo run on the card.  Rank 0 leads: a DeviceImageStore
# and a DeltaPublisher over the host state, bursts of churn between rounds;
# the others replay its frames in a FollowerImageStore.  Each prints its
# epoch, fingerprint, a CRC of a lookup, its round times and its launches
# as one JSON line, and fails if the lookup entry (and, where the image has
# a table, delta_apply) did not launch in its own process.
GLOO_WORKER = r"""
import json, os, time, zlib
import numpy as np
import torch
from repro_torch.launch.mesh import init_distributed
pid, nproc = int(os.environ["REPL_PID"]), int(os.environ["REPL_NPROC"])
init_distributed("127.0.0.1:" + os.environ["REPL_PORT"], nproc, pid)
from repro_torch.core.image_store import DeviceImageStore
from repro_torch.core.protocol import ALGORITHM_REGISTRY, image_fingerprint, make_hash
from repro_torch.kernels import delta_apply, engine
from repro_torch.launch.replicate import (DeltaPublisher, DistributedBroadcast,
                                          FollowerImageStore, TreeBroadcast)
algo, n, seed = os.environ["REPL_ALGO"], int(os.environ["REPL_N"]), int(os.environ["REPL_SEED"])
rounds, burst = int(os.environ["REPL_ROUNDS"]), int(os.environ["REPL_BURST"])
chan = TreeBroadcast(arity=2) if os.environ["REPL_TREE"] == "1" else DistributedBroadcast()
dev = torch.device("cuda", 0)
keys = np.random.default_rng([seed, 10]).integers(0, 2**32, size=int(os.environ["REPL_KEYS"]),
                                                  dtype=np.uint32)
round_ms, received = [], []

def exchange(frames=None):
    t0 = time.perf_counter()
    got = chan.exchange(frames)
    round_ms.append((time.perf_counter() - t0) * 1e3)
    received.append(got)
    return got

if pid == 0:
    rng = np.random.default_rng([seed, 11])
    lifo = ALGORITHM_REGISTRY[algo].lifo_only
    h = make_hash(algo, n, variant="32")
    store = DeviceImageStore(h, device=dev)
    pub = DeltaPublisher(h)
    exchange(pub.frames())
    for _ in range(rounds):
        for _ in range(burst):
            if rng.random() < 0.45 and h.working > 8:
                h.remove(h.size - 1 if lifo else h.lookup(int(rng.integers(1 << 30))))
            else:
                h.add()
        store.sync()
        exchange(pub.frames())
    image, out = store.image(), store.lookup(keys).cpu().numpy()
    epoch, fp = store.epoch, image_fingerprint(image)
else:
    fol = FollowerImageStore(device=dev)
    for _ in range(rounds + 1):
        fol.apply_frames(exchange())
    image, out = fol.image(), fol.lookup(keys)
    epoch, fp = fol.epoch, fol.fingerprint()
torch.cuda.synchronize()
launches = {k: v for c in (engine.LAUNCHES, delta_apply.LAUNCHES) for k, v in c.items() if v}
missing = [k for k in [algo + "_lookup"] + (["delta_apply"] if image.arrays else [])
           if not launches.get(k)]
if missing:
    raise SystemExit(f"rank {pid}: {missing} not launched in this process")
print(json.dumps({"epoch": epoch, "fingerprint": fp, "round_ms": round_ms,
                  "lookup_crc": zlib.crc32(out.astype(np.int64).tobytes()),
                  "snapshot_bytes": 4 * sum(len(f) for f in received[0]),  # 0 on rank 0 of a tree
                  "launches": launches}), flush=True)
"""


def log(msg: str) -> None:
    print(msg, flush=True)


def prom_counters(text: str) -> dict:
    """Counter samples of a Prometheus text exposition: name with labels
    → value (the lines under each ``# TYPE ... counter`` header)."""
    out, counter = {}, False
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            counter = line.endswith(" counter")
        elif counter:
            name, value = line.rsplit(" ", 1)
            out[name] = int(value)
    return out


def replica_sectors(work: dict, keys: int, bounded: bool) -> float:
    """32-byte L2 sectors a key that a packed Memento replica set loads from
    its tables, one a load, from the plain reader's counters ("bit" reads,
    "start" probes of removed buckets, "slot" slots read), as the kernel's
    reader (``PackedRepl``) loads them: every read its bitmap word and its
    first probe slot's two words, each later slot two more.  A bounded set
    adds one load word a try.  A model over the counters, not a device
    count."""
    bit, start, slot = (work.get(c, 0) for c in ("bit", "start", "slot"))
    load = work.get("try", 0) if bounded else 0
    return (3 * bit + 2 * (slot - start) + load) / keys


def dx_probes(keys, words, a: int, max_probes: int, fallback: int):
    """Each key's DxHash lookup: its bucket, and the probes it makes: the
    index of its first hit plus one, or max_probes (int64, on the keys'
    device)."""
    import torch

    from repro_torch.kernels.primitives import as_u32, gather1d, hash2

    k = as_u32(keys)
    b = torch.full(k.shape, fallback, dtype=torch.int64, device=k.device)
    probes = torch.full(k.shape, max_probes, dtype=torch.int64, device=k.device)
    lanes = torch.arange(k.numel(), device=k.device)
    for i in range(max_probes):
        if not lanes.numel():
            break
        c = hash2(k[lanes], i) % a
        hit = ((gather1d(words, c >> 5) >> (c & 31)) & 1) == 1
        b[lanes[hit]], probes[lanes[hit]] = c[hit], i + 1
        lanes = lanes[~hit]
    return b, probes


def packed_read_trips(idx, state, slot_b, slot_c):
    """Each packed Memento read of ``idx``: its value (repl, -1 working)
    and the dependent round trips ``PackedRepl`` waits for: one for the
    bitmap word and the first probe slot, one for each later slot."""
    import torch

    from repro_torch.core.hashing import GOLDEN32, MASK32
    from repro_torch.core.packing import EMPTY
    from repro_torch.kernels.primitives import fmix32, gather1d

    val = torch.full_like(idx, -1)
    trips = torch.ones_like(idx)
    word = gather1d(state, idx >> 5) & MASK32
    lanes = torch.nonzero(((word >> (idx & 31)) & 1) == 0).reshape(-1)
    mask = slot_b.numel() - 1
    want = idx[lanes]
    pos = fmix32(want * GOLDEN32 + 5) & mask
    for s in range(mask + 1):
        if not lanes.numel():
            break
        sb = gather1d(slot_b, pos)
        hit = sb == want
        val[lanes[hit]] = gather1d(slot_c, pos[hit])
        go = ~(hit | (sb == EMPTY)) & (s < mask)
        lanes, want, pos = lanes[go], want[go], (pos[go] + 1) & mask
        trips[lanes] += 1
    return val, trips


def lookup_trips(keys, tables, n: int):
    """Each key's packed Memento lookup as ``memento_one`` runs it: its
    bucket and the round trips it waits for (the inner loop's last read of
    repl(d) is the next outer read, not read again)."""
    import torch

    from repro_torch.kernels.primitives import hash2, jump32

    b = jump32(keys, n)
    c, trips = packed_read_trips(b, *tables)
    act = torch.nonzero(c >= 0).reshape(-1)
    wb = c[act].clamp_min(1)
    while act.numel():
        d = hash2(keys[act], b[act]) % wb
        u, t = packed_read_trips(d, *tables)
        follow = torch.nonzero(u >= wb).reshape(-1)
        while follow.numel():
            d[follow] = u[follow]
            u[follow], more = packed_read_trips(d[follow], *tables)
            t[follow] += more
            follow = follow[u[follow] >= wb[follow]]
        b[act] = d
        trips[act] += t
        keep = u >= 0
        act, wb = act[keep], u[keep].clamp_min(1)
    return b, trips


def pair_salt_walk(keys, k: int, lookups):
    """The unbounded k-slot replica rows of two epochs on one salt walk, as
    ``replica_pair_row`` walks them: salt 0 is the key itself, whose
    lookup is each row's slot 0; each later salt that either epoch's row
    still needs is drawn once for both, and each row fills as
    ``replica_body``'s does: salt s at its s-th try, a bucket of an
    earlier slot rejected.  ``lookups`` are the two epochs' lookups of
    int64-carried keys, each returning (buckets, cost).  Yields (salt,
    candidates, tried): the keys drawn at that salt and, for each epoch,
    the mask of those its row tries and its lookup's cost there.  A model
    over the plain lookups, not a device count."""
    import torch

    from repro_torch.core.protocol import REPLICA_SALT_CAP
    from repro_torch.kernels.primitives import hash2

    firsts = [lookup(keys) for lookup in lookups]
    yield 0, keys, [(torch.ones_like(keys, dtype=torch.bool), c) for _, c in firsts]
    rows = [b[:, None].repeat(1, k) for b, _ in firsts]
    filled = [torch.ones_like(keys) for _ in lookups]
    slots = torch.arange(k, device=keys.device)
    for salt in range(1, REPLICA_SALT_CAP + 1):
        wants = [f < k for f in filled]
        idx = torch.nonzero(wants[0] | wants[1]).reshape(-1)
        if not idx.numel():
            break
        cand = hash2(keys[idx], salt)
        tried = []
        for e, lookup in enumerate(lookups):
            sub = wants[e][idx]
            b, cost = lookup(cand[sub])
            tried.append((sub, cost))
            lanes = idx[sub]
            j = filled[e][lanes]
            taken = ((rows[e][lanes] == b[:, None]) & (slots < j[:, None])).any(dim=1)
            lanes, j, b = lanes[~taken], j[~taken], b[~taken]
            rows[e][lanes, j] = b
            filled[e][lanes] += 1
        yield salt, cand, tried


def pair_walk_work(keys, k: int, lookups, n: int) -> dict:
    """The salted tries and jump32 steps of ``replica_pair_row``, the
    unbounded k-slot replica walk of two Memento epochs of one n on one
    salt walk (:func:`pair_salt_walk`): each salt drawn is hashed and its
    jump32 run once for both epochs (salt 0, the key itself, too).
    ``lookups`` are the two epochs' plain lookups of int64-carried keys.
    Returns {"try": salted tries, "step": jump32 steps, "tries": each
    epoch's own salted tries}."""
    from repro_torch.kernels.primitives import jump32

    work = {"try": 0, "tries": [0, 0]}
    for salt, cand, tried in pair_salt_walk(
            keys, k, [lambda kk, f=f: (f(kk), None) for f in lookups]):
        jump32(cand, n, work)
        if salt:
            work["try"] += cand.numel()
            for e, (sub, _) in enumerate(tried):
                work["tries"][e] += int(sub.sum())
    return work


def dx_pair_walk_work(keys, k: int, epochs) -> dict:
    """The salted tries and probes of the unbounded k-slot replica rows of
    two DxHash epochs of one capacity a on one salt walk
    (:func:`pair_salt_walk`).  Probe i of a salted key draws the candidate
    hash2(key', i) % a in both epochs, so on a salt that both rows try the
    lesser of the two epochs' probe counts is drawn once for both.
    ``epochs`` are the two epochs' (words, a, max_probes, fallback).
    Returns {"try": salts drawn, "tries": each epoch's own salted tries,
    "probe": each epoch's probes, "shared": the probes drawn once for
    both}."""
    import torch

    work = {"try": 0, "tries": [0, 0], "probe": [0, 0], "shared": 0}
    for salt, cand, tried in pair_salt_walk(
            keys, k, [lambda kk, e=e: dx_probes(kk, *e) for e in epochs]):
        probes = []
        for e, (sub, p) in enumerate(tried):
            work["probe"][e] += int(p.sum())
            work["tries"][e] += int(sub.sum()) if salt else 0
            probes.append(torch.zeros_like(cand).masked_scatter_(sub, p))
        work["try"] += cand.numel() if salt else 0
        work["shared"] += int(torch.minimum(*probes).sum())
    return work


def walk_trips(chain, probe, pending, tables, n: int, load, cap: int):
    """The dependent round trips each lane of a packed Memento walk step
    waits for as ``walk_kernel`` issues them (its lookups, and a load[b]
    read at every test of a pending lane).  A model over the tables, not a
    device count.  Returns an int64 per-lane tensor."""
    import torch

    from repro_torch.core.bounded import walk_probe_bound
    from repro_torch.kernels.primitives import as_u32, gather1d, hash2

    max_probe = walk_probe_bound(load.numel())
    keys = as_u32(chain)
    b, trips = lookup_trips(keys, tables, n)
    lanes = torch.nonzero(pending).reshape(-1)
    ch, pr, bb = keys[lanes], probe[lanes].long(), b[lanes]
    while lanes.numel():
        trips[lanes] += 1
        go = (gather1d(load, bb) >= cap) & (pr < max_probe)
        lanes, pr = lanes[go], pr[go] + 1
        ch = hash2(ch[go], pr)
        bb, t = lookup_trips(ch, tables, n)
        trips[lanes] += t
    return trips


def lane_use(trips) -> float:
    """The share of a warp's lane slots with a round trip outstanding when
    each thread runs one lane to its end (32 consecutive lanes a warp, each
    warp waiting for its slowest): a model over per-lane counts."""
    import torch

    p = torch.nn.functional.pad(trips, (0, -trips.numel() % 32))
    return float(trips.sum()) / float(32 * p.reshape(-1, 32).amax(dim=1).sum())


def warp_rounds(probes, g: int) -> float:
    """Rounds a warp runs, a key, when each key's probes are spread over g
    lanes (32 / g keys a warp, each round g probes a key): a warp runs
    until its slowest key is done.  A model over the probe counts, not a
    device count."""
    import torch

    per = 32 // g
    p = torch.nn.functional.pad(probes, (0, -probes.numel() % per))
    rounds = (p.reshape(-1, per) + g - 1).div(g, rounding_mode="floor").amax(dim=1)
    return float(rounds.sum()) / probes.numel()


def walk_rounds(steps, probe, max_probe: int, s_max: int) -> tuple[float, float]:
    """Lookup rounds a warp and lane lookups a warp of a walk step whose
    lanes take ``steps`` steps from ``probe`` (int64, one a lane; 32
    consecutive lanes a warp) when a round looks up at most ``s_max`` steps
    of each open lane on the warp's lanes (the look-ahead among engine.cu's
    designs that lost: with w lanes open, min(s_max, 32 // w) steps each,
    none past max_probe); at s_max = 1, one step a lane a round
    (``walk_kernel``).  The first round
    looks up every lane's chain.  A model over the step counts, not a device
    count."""
    import torch

    live = torch.nn.functional.pad(torch.ones_like(steps), (0, -steps.numel() % 32))
    rem = torch.nn.functional.pad(steps, (0, -steps.numel() % 32)).reshape(-1, 32)
    p = torch.nn.functional.pad(probe, (0, -probe.numel() % 32)).reshape(-1, 32)
    rounds, lookups = rem.shape[0], int(live.sum())
    while bool((rem > 0).any()):
        open_ = rem > 0
        w = open_.sum(dim=1, keepdim=True)
        s = torch.clamp(32 // w.clamp_min(1), max=s_max)
        lookups += int((torch.minimum(s, max_probe - p) * open_).sum())
        adv = torch.minimum(rem, s) * open_
        rem, p = rem - adv, p + adv
        rounds += int((w > 0).sum())
    return rounds / rem.shape[0], lookups / rem.shape[0]


def anchor_lookup_trips(keys, A, K, a: int):
    """Each key's AnchorHash lookup as ``anchor_one`` runs it: its bucket and
    the dependent round trips it waits for, 1 + 2 passes + 2 successor
    reads (A of the start; A[h] of each pass and A[b] again at its end; K
    then A of each successor).  A model over the tables, not a device
    count."""
    import torch

    from repro_torch.kernels.primitives import fmix32, gather1d, hash2

    b = fmix32(keys) % a
    Ab = gather1d(A, b)
    trips = torch.ones_like(keys)
    active = Ab > 0
    while bool(active.any()):
        trips += 2 * active
        h = hash2(keys, b) % torch.where(active, Ab, 1)
        follow = active & (gather1d(A, h) >= Ab)
        while bool(follow.any()):
            trips += 2 * follow
            h = torch.where(follow, gather1d(K, h), h)
            follow = active & (gather1d(A, h) >= Ab)
        b = torch.where(active, h, b)
        Ab = gather1d(A, b)
        active = Ab > 0
    return b, trips


def walk_step_trips(chain, probe, pending, load, cap: int, trips_of):
    """The dependent round trips of each lane's first lookup and of each of
    its steps in a chain-walk step as ``walk_kernel`` runs it: a pending
    lane reads load[b] after each lookup, and a step is a lookup and that
    read.  ``trips_of(keys)`` gives each key's (bucket, round trips).
    Returns an int64 [lanes, 1 + most steps] tensor, 0 past a lane's last
    step.  A model over the tables, not a device count."""
    import torch

    from repro_torch.core.bounded import walk_probe_bound
    from repro_torch.kernels.primitives import as_u32, gather1d, hash2

    max_probe = walk_probe_bound(load.numel())
    keys = as_u32(chain)
    b, first = trips_of(keys)
    cols = [first + pending.long()]
    lanes = torch.nonzero(pending).reshape(-1)
    ch, pr, bb = keys[lanes], probe[lanes].long(), b[lanes]
    while True:
        go = (gather1d(load, bb) >= cap) & (pr < max_probe)
        lanes, pr = lanes[go], pr[go] + 1
        if not lanes.numel():
            break
        ch = hash2(ch[go], pr)
        bb, t = trips_of(ch)
        col = torch.zeros_like(first)
        col[lanes] = t + 1
        cols.append(col)
    return torch.stack(cols, dim=1)


def walk_slots(trips, block: int = WALK_BLOCK) -> dict:
    """A walk step's cost as ``walk_kernel`` runs it, each thread one lane
    to its end (a warp runs its open lanes' steps, waiting for its
    slowest), ``block`` lanes a block, from ``trips``
    (:func:`walk_step_trips`; 32 and ``block`` consecutive lanes a warp and
    a block).  "rounds": lookup rounds a warp runs, and "lookups": lane
    lookups, each per warp; "slot": the round trips a block holds its SM
    slots (its slowest lane's sum), a block's mean; "lookup slot": the same
    of the first lookups alone (a lookup kernel's).  A model, not a device
    count."""
    import torch

    steps = (trips[:, 1:] > 0).sum(dim=1)
    pad = -steps.numel() % block
    s = torch.nn.functional.pad(steps, (0, pad))
    tb = torch.nn.functional.pad(trips, (0, 0, 0, pad)).reshape(-1, block, trips.shape[1])
    warps = s.numel() // 32
    return {"rounds": float((1 + s.reshape(-1, 32).amax(dim=1)).sum()) / warps,
            "lookups": float(steps.numel() + steps.sum()) / warps,
            "slot": float(tb.sum(dim=2).amax(dim=1).double().mean()),
            "lookup slot": float(tb[:, :, 0].amax(dim=1).double().mean())}


def power_level_of(n: int) -> int:
    """PowerHash's top level L = floor(log2(n - 1)), 0 at n <= 2."""
    return max(0, (n - 1).bit_length() - 1)


def power_work(keys, n: int):
    """Each key's extra top draws and levels descended under PowerHash at
    ``n`` (int64; ``keys`` int32 bit patterns or uint32 words): the plain
    version's counters ("draw", "level"), a key each, as ``power32`` draws
    them."""
    import torch

    from repro_torch.core.power import POWER_SALT, POWER_TRY_CAP
    from repro_torch.kernels.primitives import as_u32, hash2

    keys = as_u32(keys)
    L = power_level_of(n)
    hi, base = (2 << L) - 1, POWER_SALT + (L << 6)
    v = hash2(keys, base) & hi
    draws = torch.zeros_like(keys)
    for t in range(1, POWER_TRY_CAP):
        redo = v >= n
        if not bool(redo.any()):
            break
        draws += redo
        v = torch.where(redo, hash2(keys, base + t) & hi, v)
    out = torch.where((v < n) & (v >= (1 << L)), v, -1)
    levels = torch.zeros_like(keys)
    for j in range(L - 1, -1, -1):
        pending = out < 0
        if not bool(pending.any()):
            break
        levels += pending
        cand = hash2(keys, POWER_SALT + (j << 6)) & ((2 << j) - 1)
        out = torch.where(pending & (cand >= (1 << j)), cand, out)
    return draws, levels


def power_rounds(draws, levels, L: int) -> dict:
    """Warp issue slots a key of ``power_lookup`` (a model over each key's
    extra top draws and levels, :func:`power_work`; 32 consecutive keys a
    warp, a warp's slots its operations as OPS above, one a lane at a time,
    so a warp runs its deepest lane's draws and levels): "PR 24", every
    draw hashed in full (POWER_HASH2_OPS) and the top level's shift loop
    in each thread (3 a level); "step 1", without the loop; "kept", each
    draw's inner mix loaded (the kernel, ALGO_OPS)."""
    import torch

    pad = -draws.numel() % 32
    d = torch.nn.functional.pad(draws, (0, pad)).reshape(-1, 32)
    lv = torch.nn.functional.pad(levels, (0, pad)).reshape(-1, 32)

    def thread(per_key, per_draw, per_level):
        return per_key + per_draw * d.amax(dim=1) + per_level * lv.amax(dim=1)

    hashed = thread(*POWER_HASH2_OPS)
    return {"PR 24": float((hashed + 3 * (L + 1)).double().mean()),
            "step 1": float(hashed.double().mean()),
            "kept": float(thread(ALGO_OPS["power"][0], *ALGO_OPS["power"][1].values())
                          .double().mean())}


def anchor_words(work: dict, keys: int, load_reads: int = 0) -> int:
    """Distinct words an AnchorHash run reads, from the plain version's
    counters: 1 + passes + 2 successor reads a lookup (A[b] of the start,
    A[h] of each pass, K and A of each successor), plus ``load_reads``."""
    return (work.get("lookups", keys) + work.get("outer", 0) + 2 * work.get("read", 0)
            + load_reads)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found: run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    smoke = Smoke(torch)
    walls = {}

    def timed(name: str, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        walls[name] = time.perf_counter() - t0
        return out

    timed("1", smoke.phase_build, smi)
    kernels = timed("2 memento", smoke.phase_kernels)
    algo_kernels = timed("2 others", smoke.phase_algo_kernels)
    timed("3", smoke.phase_main_path, kernels)
    timed("4", smoke.phase_replay, algo_kernels)
    timed("4b", smoke.phase_host_vs_device)
    replica_kernels = timed("5", smoke.phase_replicas)
    packed_kernels = timed("6", smoke.phase_packed)
    compact_kernels = timed("7", smoke.phase_compact_replicas)
    kernels += algo_kernels + replica_kernels + packed_kernels + compact_kernels
    timed("7 cold", smoke.lookup_cold_times, kernels)
    timed("8", smoke.phase_substrates)
    timed("9", smoke.phase_stream)
    timed("10", smoke.phase_replication)
    timed("11", smoke.phase_telemetry)
    log("phase walls: " + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items())
        + f"; {sum(walls.values()):.1f} s in all")
    log_rule2_order(kernels)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def log_rule2_order(kernels: list[dict]) -> None:
    """The order in which to redesign the kernels: first those slower
    than the PyTorch call that computes the same function, then those below
    half of their bound by launches on their path x (time - bound), largest
    first; an entry that reaches half of its bound and is no slower than a
    library call is left alone."""
    def slower(k):
        return k["library_ms"] is not None and k["ms"] > k["library_ms"]

    todo = [k for k in kernels if slower(k) or k["bound_ms"] < 0.5 * k["ms"]]
    order = sorted(todo, key=lambda k: (not slower(k),
                                        -k["launches"] * (k["ms"] - k["bound_ms"])))
    log("redesign order (slower than a library call first, then those below half of "
        "their bound by launches x (ms - bound_ms)): " + ", ".join(
            f"{k['name']} ({'slower than library, ' if slower(k) else ''}"
            f"{k['launches']} x ({k['ms']:.6f} - {k['bound_ms']:.6f}) = "
            f"{k['launches'] * (k['ms'] - k['bound_ms']):.6f} ms, "
            f"{k['bound_ms'] / k['ms']:.1%} of the bound)" for k in order)
        + "; left alone (half of the bound or more): " + ", ".join(
            f"{k['name']} ({k['bound_ms'] / k['ms']:.1%})" for k in kernels if k not in todo))


class Smoke:
    def __init__(self, torch):
        import numpy as np

        self.torch, self.np = torch, np
        self.dev = torch.device("cuda", 0)
        self.rng = np.random.default_rng(SEED)
        # algo -> (one-shot host state, stable image, one-shot image on the
        # card), kept from phase 2 for phase 5: no state is built twice
        self.kept: dict = {}
        self.flush = None  # phase 7's L2 flush buffer
        # AnchorHash entries: name -> (words read, footprint bytes, kernel ms),
        # and the gather-rate probe's G words/s by table MB (phase 5)
        self.anchor_reads: dict = {}
        self.gather: dict = {}
        # (scenario, algo, size) -> fingerprint of the unsharded replays of
        # phases 4 ("full") and 4b ("default"), the comparands of phase 9
        self.fingerprints: dict = {}

    # -- helpers ---------------------------------------------------------------
    def time_ms(self, fn, reps: int, warmup: int = 3) -> float:
        """Mean device time of ``fn`` over ``reps`` calls (CUDA events).

        The calls are queued behind a ``torch.cuda._sleep`` on the stream,
        so the card runs them back to back and the host's time to issue
        each one (Python, checks, ``ctypes``) stays out of the reading;
        the host's share is in ``wrapper_ms``/the scenario latencies.  A
        function that synchronizes inside (the plain versions) is timed
        as it runs: its waits are part of its time."""
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def launch_floor_ms(self) -> float:
        """A yardstick for the smallest kernels: the device time of one
        launch of a one-element torch elementwise op (``add_``), timed as
        :meth:`time_ms` times the kernels.  Not a bound."""
        one = self.torch.zeros(1, dtype=self.torch.int32, device=self.dev)
        return self.time_ms(lambda: one.add_(1), reps=100)

    def time_cold_ms(self, fn, reps: int = COLD_REPS) -> float:
        """Median device time of one call of ``fn`` on a cold L2: before each
        call a 128 MiB buffer is written, outside the call's event pair.
        Queued behind a GPU sleep, as :meth:`time_ms`."""
        np, torch = self.np, self.torch
        if self.flush is None:
            self.flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device=self.dev)
        self.flush.fill_(-1)
        fn()
        torch.cuda.synchronize()
        ev = [[torch.cuda.Event(enable_timing=True) for _ in range(2)] for _ in range(reps)]
        torch.cuda._sleep(SLEEP_CYCLES)
        for i, (start, end) in enumerate(ev):
            self.flush.fill_(i)
            start.record()
            fn()
            end.record()
        ev[-1][1].synchronize()
        return float(np.median([start.elapsed_time(end) for start, end in ev]))

    def remove_random(self, m, count: int) -> None:
        """``count`` removals of random working buckets on the host."""
        removed = 0
        for b in self.rng.permutation(m.n).tolist():
            if removed == count:
                return
            if m.is_working(b) and m.working > 1:
                m.remove(b)
                removed += 1

    def keys(self):
        from repro_torch.kernels.engine import key_tensor

        k = self.rng.integers(0, 2**32, size=KEYS, dtype=self.np.uint32)
        return k, key_tensor(k, self.dev)

    @staticmethod
    def lookup_ops(work: dict, keys: int) -> int:
        """32-bit operations of one lookup pass over ``keys`` keys whose
        plain-version lane counts are ``work``."""
        return (keys * OPS_PER_KEY + work.get("step", 0) * OPS_PER_STEP
                + work.get("outer", 0) * OPS_PER_OUTER
                + work.get("read", 0) * OPS_PER_READ
                + work.get("bit", 0) * OPS_PER_BIT + work.get("start", 0) * OPS_PER_START
                + work.get("slot", 0) * OPS_PER_SLOT)

    @staticmethod
    def bound(ops: int, nbytes: int) -> tuple[float, str]:
        """The least time (ms) for ``ops`` int32 operations and ``nbytes``
        of memory traffic, and which of the two sets it."""
        ops_ms = ops / INT32_OPS_PER_S * 1e3
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")

    # -- phase 1 ---------------------------------------------------------------
    def phase_build(self, smi: str) -> None:
        from repro_torch.kernels import build

        torch = self.torch
        log(smi)
        log(f"torch {torch.__version__} cuda {torch.version.cuda} "
            f"python {sys.version.split()[0]}")
        t0 = time.perf_counter()
        built = build.build()
        log(f"build: {time.perf_counter() - t0:.3f} s for {sorted(built)} "
            f"(one nvcc per source, started together: {' '.join(build.NVCC_FLAGS)})")
        for name, b in sorted(built.items()):
            log(f"  {name}: nvcc {b.seconds:.3f} s{' (reused)' if b.reused else ''}")
            for line in b.ptxas.splitlines():
                if "registers" in line or "spill" in line or "Compiling entry" in line:
                    log(f"  ptxas {name}: {line.strip()}")

    # -- phase 2 ---------------------------------------------------------------
    def phase_kernels(self) -> list[dict]:
        from repro_torch.core.memento import MementoHash

        torch = self.torch
        states = {"stable": MementoHash(N, variant="32")}
        inc = MementoHash(N, variant="32")
        removed = 0
        images = [("stable", states["stable"].device_image())]
        for frac in INCREMENTAL_STAGES:
            self.remove_random(inc, int(frac * N) - removed)
            removed = int(frac * N)
            images.append((f"incremental {frac:.0%}", inc.device_image()))
        states["incremental"] = inc
        one = MementoHash(N, variant="32")
        t0 = time.perf_counter()
        self.remove_random(one, int(ONESHOT_FRACTION * N))
        log(f"host: one-shot removal of {int(ONESHOT_FRACTION * N)} buckets "
            f"took {(time.perf_counter() - t0) * 1e3:.1f} ms")
        states["oneshot"] = one
        images.append(("oneshot", one.device_image()))
        self.kept["memento"] = (one, self.on_card(states["stable"].device_image()),
                                self.on_card(one.device_image()))
        images = [(name, img.arrays["repl"].to(self.dev), img.n)
                  for name, img in images]
        lookup = self.check_lookup(states, images)
        diff = self.check_diff(images)
        apply = self.check_apply()
        torch.cuda.synchronize()
        return [lookup, diff, apply]

    def check_lookup(self, states, images) -> dict:
        from repro_torch.kernels.engine import memento_lookup, memento_lookup_plain

        np = self.np
        host_of = {"stable": states["stable"], "oneshot": states["oneshot"],
                   f"incremental {INCREMENTAL_STAGES[-1]:.0%}": states["incremental"]}
        by_state = {}
        for name, repl, n in images:
            keys_np, keys = self.keys()
            out = memento_lookup(keys, repl, n)
            work: dict = {}
            plain = memento_lookup_plain(keys, repl, n, work)
            err = int((out.long() - plain.long()).abs().max())
            if err:
                raise AssertionError(f"memento_lookup {name}: kernel != plain "
                                     f"(max abs err {err})")
            if name in host_of:
                sample = np.arange(0, KEYS, KEYS // 2048)
                host = np.array([host_of[name].lookup(int(k)) for k in keys_np[sample]])
                if not (host == out.cpu().numpy()[sample]).all():
                    raise AssertionError(f"memento_lookup {name}: kernel != host")
            ok = bool(((out >= 0) & (out < n)).all()) and bool((repl[out.long()] < 0).all())
            if not ok:
                raise AssertionError(f"memento_lookup {name}: non-working bucket")
            ms = self.time_ms(lambda: memento_lookup(keys, repl, n), reps=50)
            plain_ms = self.time_ms(lambda: memento_lookup_plain(keys, repl, n),
                                    reps=2, warmup=1)
            ops = self.lookup_ops(work, KEYS)
            bound_ms, bound_by = self.bound(ops, 8 * KEYS + 4 * n)
            ops_key = ops / KEYS
            by_state[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                              "bound_by": bound_by, "max_abs_err": err}
            log(f"check memento_lookup {name}: n={n} keys={KEYS} kernel == plain"
                f"{' == host sample' if name in host_of else ''}; kernel {ms:.6f} ms, "
                f"plain {plain_ms:.3f} ms, bound {bound_ms:.6f} ms ({bound_by}: "
                f"{ops_key:.1f} ops/key = {OPS_PER_KEY} + "
                f"{work.get('step', 0) / KEYS:.3f} steps x {OPS_PER_STEP} + "
                f"{work.get('outer', 0) / KEYS:.3f} passes x {OPS_PER_OUTER} + "
                f"{work.get('read', 0) / KEYS:.3f} reads x {OPS_PER_READ}, "
                f"at {INT32_OPS_PER_S:.4g} int32 ops/s), "
                f"{bound_ms / ms:.1%} of the bound")
        head = by_state["oneshot"]
        return {"name": "memento_lookup", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/engine.cu",
                "replaces": "src/repro/kernels/engine.py:526",
                "launches": None, "max_abs_err": max(s["max_abs_err"] for s in by_state.values()),
                "ms": head["ms"], "plain_ms": head["plain_ms"],
                "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
                "library_ms": None, "state": "oneshot", "by_state": by_state}

    def check_diff(self, images) -> dict:
        from repro_torch.kernels.engine import (memento_diff, memento_diff_plain,
                                                memento_lookup_plain)

        pairs = list(zip(images[:-2], images[1:-1]))  # stable → incremental stages
        pairs.append((images[0], images[-1]))         # stable → one-shot
        result = None
        for (name_a, repl_a, n_a), (name_b, repl_b, n_b) in pairs:
            _, keys = self.keys()
            old, new, moved = memento_diff(keys, repl_a, n_a, repl_b, n_b)
            p_old, p_new, p_moved = memento_diff_plain(keys, repl_a, n_a, repl_b, n_b)
            err = max(int((old.long() - p_old.long()).abs().max()),
                      int((new.long() - p_new.long()).abs().max()),
                      int((moved != p_moved).sum()))
            if err:
                raise AssertionError(f"memento_diff {name_a} -> {name_b}: "
                                     f"kernel != plain ({err})")
            log(f"check memento_diff {name_a} -> {name_b}: kernel == plain, "
                f"moved {int(moved.sum())} of {KEYS}")
            if name_b == "oneshot":
                ms = self.time_ms(lambda: memento_diff(keys, repl_a, n_a, repl_b, n_b),
                                  reps=30)
                plain_ms = self.time_ms(
                    lambda: memento_diff_plain(keys, repl_a, n_a, repl_b, n_b),
                    reps=2, warmup=1)
                both: dict = {}
                memento_lookup_plain(keys, repl_a, n_a, both)
                memento_lookup_plain(keys, repl_b, n_b, both)
                # two lookups and a compare per key, one jump32 for both at one
                # n; keys read once, 3 outputs
                bound_ms, bound_by = self.bound(
                    self.lookup_ops(both, 2 * KEYS) + KEYS
                    - self.diff_shared_ops("memento", both, n_a, n_b),
                    16 * KEYS + 4 * (n_a + n_b))
                log(f"time memento_diff stable -> oneshot (n = {n_a} -> {n_b}): kernel "
                    f"{ms:.6f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.6f} ms "
                    f"({bound_by} of both lookups), {bound_ms / ms:.1%} of the bound")
                result = {"name": "memento_diff", "route": "cuda",
                          "source": "src/repro_torch/kernels/csrc/engine.cu",
                          "replaces": "src/repro/kernels/engine.py:526",
                          "launches": None, "max_abs_err": err, "ms": ms,
                          "plain_ms": plain_ms, "bound_ms": bound_ms,
                          "bound_by": bound_by,
                          "library_ms": None, "state": "stable -> oneshot"}
        return result

    def check_apply(self) -> dict:
        from repro_torch.kernels.delta_apply import (_pad_updates, apply_form, dedup_last,
                                                     delta_apply, delta_apply_plain,
                                                     scatter_update)

        np, torch = self.np, self.torch
        base = self.rng.integers(-1, N, size=DELTA_TABLE).astype(np.int32)
        table = torch.from_numpy(base).to(self.dev)
        # duplicates among the updates: the last write must win
        idx = self.rng.integers(0, DELTA_TABLE, size=DELTA_UPDATES)
        idx[-512:] = idx[:512]
        vals = self.rng.integers(-1, N, size=DELTA_UPDATES).astype(np.int32)
        host = base.copy()
        for i, v in zip(idx.tolist(), vals.tolist()):
            host[i] = v
        uidx, uvals = dedup_last(idx, vals)
        pidx, pval, count = _pad_updates(uidx, uvals, sentinel=-1)
        meta = torch.from_numpy(np.concatenate([pidx, pval])).to(self.dev)
        out = delta_apply(table, meta, count)
        plain = delta_apply_plain(table, meta, count)
        ti = torch.from_numpy(uidx).to(self.dev)
        tv = torch.from_numpy(uvals).to(self.dev)
        lib = table.index_put((ti,), tv)
        via_wrapper = scatter_update(table, idx, vals)
        err = int((out.long() - plain.long()).abs().max())
        if err or not torch.equal(out, lib) or not torch.equal(out, via_wrapper):
            raise AssertionError("delta_apply: kernel != plain / index_put / wrapper")
        if not (out.cpu().numpy() == host).all() or not (table.cpu().numpy() == base).all():
            raise AssertionError("delta_apply: kernel != in-order host apply, or input changed")
        ms = self.time_ms(lambda: delta_apply(table, meta, count), reps=100)
        plain_ms = self.time_ms(lambda: delta_apply_plain(table, meta, count), reps=100)
        library_ms = self.time_ms(lambda: table.index_put((ti,), tv), reps=100)
        t0 = time.perf_counter()
        for _ in range(20):
            scatter_update(table, idx, vals)
        torch.cuda.synchronize()
        wrapper_ms = (time.perf_counter() - t0) / 20 * 1e3
        form = apply_form(DELTA_TABLE, torch.int32)
        bound_ms, _ = self.bound(0, 2 * 4 * DELTA_TABLE + 8 * count)
        log(f"check delta_apply: {DELTA_UPDATES} updates ({count} distinct indices) into "
            f"{DELTA_TABLE} int32: kernel == plain == index_put == in-order host apply, "
            f"input unchanged; form {form}; kernel {ms:.6f} ms, plain {plain_ms:.6f} ms, "
            f"index_put {library_ms:.6f} ms, bound {bound_ms:.6f} ms (bytes: 2 x "
            f"{4 * DELTA_TABLE} table + {8 * count} update bytes at {HBM_BYTES_PER_S:.3g} "
            f"B/s{self.form_bytes_text(form, count, 4)}), {bound_ms / ms:.1%} of the bound; "
            f"launch floor {self.launch_floor_ms():.6f} ms (a yardstick, not a bound); "
            f"scatter_update incl. host dedup and copy {wrapper_ms:.4f} ms")
        return {"name": "delta_apply", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/delta_apply.cu",
                "replaces": "src/repro/kernels/delta_apply.py:52",
                "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": library_ms,
                "wrapper_ms": wrapper_ms, "form": form}

    @staticmethod
    def form_bytes_text(form: str, count: int, size: int) -> str:
        """What the delta apply's form moves beyond the function's bytes: the
        copy and the scatter write each updated word twice."""
        if form == "one block":
            return "; the one-block form moves just these"
        return f"; the copy and the scatter also write the {count} updated words twice, " \
            f"+{count * size} bytes"

    # -- phase 2, the other algorithms' kernels ---------------------------------
    def remove_fraction(self, h, frac: float) -> float:
        """Remove ``frac`` of the working buckets (random victims; the
        highest ids for the LIFO-only algorithms); returns host ms."""
        from repro_torch.core.protocol import ALGORITHM_REGISTRY

        count = int(frac * h.working)
        t0 = time.perf_counter()
        if ALGORITHM_REGISTRY[h.name].lifo_only:
            victims = range(h.size - 1, h.size - 1 - count, -1)
        else:
            victims = self.rng.permutation(sorted(h.working_set()))[:count].tolist()
        for b in victims:
            h.remove(b)
        return (time.perf_counter() - t0) * 1e3

    def on_card(self, img):
        img.arrays = {k: v.to(self.dev) for k, v in img.arrays.items()}
        return img

    def operands(self, h):
        """The host state's image on the card, and as kernel operands."""
        from repro_torch.kernels.engine import image_operands

        img = self.on_card(h.device_image())
        tables, scalars = image_operands(img)
        return tables, scalars, sum(4 * t.numel() for t in tables), img

    @staticmethod
    def algo_ops(algo: str, work: dict, keys: int, n: int) -> int:
        per_key, per_iter = ALGO_OPS[algo]
        return keys * per_key + sum(work.get(k, 0) * v for k, v in per_iter.items())

    def per_key_ops(self, algo: str, n: int) -> int:
        return OPS_PER_KEY if algo == "memento" else ALGO_OPS[algo][0]

    def mode_ops(self, algo: str, work: dict, keys: int, n: int, slots: int = 0,
                 bounded: bool = False, walk: bool = False) -> int:
        """32-bit operations of a phase-5 kernel over ``keys`` lanes whose
        plain run counted ``work``: every lookup's body, the salted tries
        and duplicate compares of a replica walk writing ``slots`` slots a
        key, and the steps of a chain walk."""
        body = (self.lookup_ops(work, keys) if algo == "memento"
                else self.algo_ops(algo, work, keys, n))
        more = work.get("lookups", keys) - keys
        walk = keys * OPS_PER_WALK_LANE if walk else 0
        return (body + more * (self.per_key_ops(algo, n) - 3) + keys * slots
                + work.get("try", 0) * (OPS_PER_TRY + (OPS_PER_BOUNDED_TRY if bounded else 0))
                + work.get("compare", 0) * OPS_PER_COMPARE
                + work.get("walk", 0) * OPS_PER_WALK_STEP + walk)

    @staticmethod
    def diff_shared_ops(algo: str, work: dict, n_old: int, n_new: int, keys=None) -> int:
        """The operations of a k = 1 diff that its plain counters ``work``
        (both epochs) count twice and the kernel makes once: for two Memento
        epochs of one n, the jump32 steps of a key, one epoch's half of
        ``work["step"]`` (both run the same steps); for two PowerHash epochs
        of one top level, each key's first draw and the draws and levels
        both epochs make (one top sequence, one descent: the smaller of the
        two epochs' counts, :func:`power_work` over ``keys``, whose sums
        must equal ``work``'s); 0 otherwise."""
        if algo == "power" and power_level_of(n_old) == power_level_of(n_new):
            (do, lo), (dn, ln) = (power_work(keys, n) for n in (n_old, n_new))
            both = [int((do + dn).sum()), int((lo + ln).sum())]
            if both != [work.get("draw", 0), work.get("level", 0)]:
                raise AssertionError(f"power diff: per-key draws and levels {both} != the "
                                     f"plain counters' {work}")
            per_draw, per_level = ALGO_OPS["power"][1].values()
            return (keys.numel() * OPS_PER_POWER_SHARED_KEY
                    + int(do.minimum(dn).sum()) * per_draw
                    + int(lo.minimum(ln).sum()) * per_level)
        if algo != "memento" or n_old != n_new:
            return 0
        return work.get("step", 0) // 2 * OPS_PER_STEP

    def pair_shared_ops(self, algo: str, keys, works: list[dict], old, new,
                        table: str) -> int:
        """The operations of a k = REPLICAS_K replica diff that its plain
        counters ``works`` (each epoch's, or one of both for Memento) count
        twice and the function needs once, both epochs' rows walked on one
        salt walk: each salt either row tries, drawn once; for two Memento
        epochs of one n, its jump32 steps once (:func:`pair_walk_work`);
        for two DxHash epochs of one a, the probes both make on a salt once
        (:func:`dx_pair_walk_work`).  The model's tries, and DxHash's
        probes an epoch, must equal the plain counters'.  0 otherwise."""
        from repro_torch.kernels import engine
        from repro_torch.kernels.primitives import as_u32

        if algo not in ("memento", "dx") or old[1][0] != new[1][0]:
            return 0
        tries = sum(w.get("try", 0) for w in works)
        per_key = keys.numel()
        if algo == "dx":
            pair = dx_pair_walk_work(as_u32(keys), REPLICAS_K,
                                     [(t[0], *s) for t, s in (old, new)])
            plain = [[w.get(c, 0) for w in works] for c in ("try", "probe")]
            if [pair["tries"], pair["probe"]] != plain:
                raise AssertionError(f"dx replica diff: pair walk model tries and probes "
                                     f"{pair['tries']}, {pair['probe']} != the plain "
                                     f"counters' {plain[0]}, {plain[1]}")
            log(f"  pair walk (a = {old[1][0]} both): {pair['try'] / per_key:.3f} salted "
                f"tries and {pair['shared'] / per_key:.3f} probes a key drawn once for both "
                f"epochs, where the two walks make {tries / per_key:.3f} and "
                f"{sum(pair['probe']) / per_key:.3f} (model)")
            return (tries - pair["try"]) * OPS_PER_TRY + pair["shared"] * OPS_PER_SHARED_PROBE
        steps = sum(w.get("step", 0) for w in works)
        pair = pair_walk_work(as_u32(keys), REPLICAS_K,
                              [lambda kk, e=e: engine.lookup_plain(algo, kk, *e,
                                                                   table=table).long()
                               for e in (old, new)], old[1][0])
        if sum(pair["tries"]) != tries:
            raise AssertionError(f"memento replica diff ({table}): pair walk model tries "
                                 f"{pair['tries']} != the plain counters' {tries}")
        log(f"  pair walk ({table}, n = {old[1][0]} both): {pair['try'] / per_key:.3f} "
            f"salted tries and {pair['step'] / per_key:.3f} jump32 steps a key for both "
            f"epochs, where the two walks make {tries / per_key:.3f} and "
            f"{steps / per_key:.3f} (model)")
        return (tries - pair["try"]) * OPS_PER_TRY + (steps - pair["step"]) * OPS_PER_STEP

    def phase_algo_kernels(self) -> list[dict]:
        """``{algo}_lookup`` and ``{algo}_diff`` of every algorithm but
        Memento against their plain versions, at w = 10^6 stable and after
        a one-shot removal of 90 %."""
        from repro_torch.core.protocol import ALGORITHMS, make_hash
        from repro_torch.kernels.engine import kernel_lookup, lookup_plain

        np, torch = self.np, self.torch
        rows = []
        for algo in ALGORITHMS:
            if algo == "memento":
                continue
            t0 = time.perf_counter()
            h = make_hash(algo, N, capacity=CAPACITY_FACTOR * N, variant="32")
            build_ms = (time.perf_counter() - t0) * 1e3
            stable = self.operands(h)
            remove_ms = self.remove_fraction(h, ONESHOT_FRACTION)
            oneshot = self.operands(h)
            log(f"host {algo}: build {build_ms:.1f} ms, one-shot removal to "
                f"{h.working} of size {h.size} {remove_ms:.1f} ms")
            by_state = {}
            for name, (tables, scalars, table_bytes, _) in (("stable", stable),
                                                           ("oneshot", oneshot)):
                keys_np, keys = self.keys()
                out = kernel_lookup(algo, keys, tables, scalars)
                work: dict = {}
                plain = lookup_plain(algo, keys, tables, scalars, work)
                err = int((out.long() - plain.long()).abs().max())
                if err:
                    raise AssertionError(f"{algo}_lookup {name}: kernel != plain ({err})")
                if name == "oneshot":
                    sample = np.arange(0, KEYS, KEYS // 2048)
                    host = np.array([h.lookup(int(k)) for k in keys_np[sample]])
                    if not (host == out.cpu().numpy()[sample]).all():
                        raise AssertionError(f"{algo}_lookup {name}: kernel != host")
                ms = self.time_ms(lambda: kernel_lookup(algo, keys, tables, scalars),
                                  reps=30)
                plain_ms = self.time_ms(lambda: lookup_plain(algo, keys, tables, scalars),
                                        reps=2, warmup=1)
                ops = self.algo_ops(algo, work, KEYS, scalars[0])
                bound_ms, bound_by = self.bound(ops, 8 * KEYS + table_bytes)
                by_state[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                                  "bound_by": bound_by, "max_abs_err": err}
                if algo == "dx":
                    self.dx_rounds(keys, tables, scalars, name)
                if algo == "power":
                    self.power_model(keys, scalars[0], work, name, ms)
                if algo == "anchor":
                    self.anchor_trips(work, name)
                    self.anchor_reads[f"anchor_lookup {name}"] = (
                        anchor_words(work, KEYS), table_bytes, ms)
                log(f"check {algo}_lookup {name}: keys={KEYS} kernel == plain"
                    f"{' == host sample' if name == 'oneshot' else ''}; kernel {ms:.6f} ms, "
                    f"plain {plain_ms:.3f} ms, bound {bound_ms:.6f} ms ({bound_by}: "
                    f"{ops / KEYS:.2f} ops/key from "
                    f"{ {k: round(v / KEYS, 3) for k, v in work.items()} } per key, "
                    f"{table_bytes} table bytes), {bound_ms / ms:.1%} of the bound")
            head = by_state["oneshot"]
            rows.append({"name": f"{algo}_lookup", "route": "cuda",
                         "source": "src/repro_torch/kernels/csrc/engine.cu",
                         "replaces": "src/repro/kernels/engine.py:526",
                         "launches": None,
                         "max_abs_err": max(v["max_abs_err"] for v in by_state.values()),
                         "ms": head["ms"], "plain_ms": head["plain_ms"],
                         "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
                         "library_ms": None, "state": "oneshot", "by_state": by_state})
            # the diff across the one-shot removal; PowerHash's also across its
            # incremental replay's removal of one bucket (n -> n - 1 at one
            # top level: the pair kernel)
            pairs = [("stable -> oneshot", stable, oneshot)]
            if algo == "power":
                h1 = make_hash(algo, N, capacity=CAPACITY_FACTOR * N, variant="32")
                h1.remove(h1.size - 1)
                pairs.append((f"n={N} -> {N - 1}", stable, self.operands(h1)))
            diffs = {name: self.algo_diff(algo, name, a, b) for name, a, b in pairs}
            head = diffs["stable -> oneshot"]
            rows.append({"name": f"{algo}_diff", "route": "cuda",
                         "source": "src/repro_torch/kernels/csrc/engine.cu",
                         "replaces": "src/repro/kernels/engine.py:526",
                         "launches": None,
                         "max_abs_err": max(v["max_abs_err"] for v in diffs.values()),
                         "ms": head["ms"], "plain_ms": head["plain_ms"],
                         "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
                         "library_ms": None, "state": "stable -> oneshot",
                         **({"by_state": diffs} if len(diffs) > 1 else {})})
            self.kept[algo] = (h, stable[3], oneshot[3])
        torch.cuda.synchronize()
        return rows

    def algo_diff(self, algo: str, name: str, old_ops, new_ops) -> dict:
        """``{algo}_diff`` from ``old_ops`` to ``new_ops`` (:meth:`operands`)
        against its plain version, timed beside its bound; its by-state entry."""
        from repro_torch.kernels import engine
        from repro_torch.kernels.engine import diff_plain, kernel_diff, lookup_plain

        _, keys = self.keys()
        old, new = old_ops[:2], new_ops[:2]
        got = kernel_diff(algo, keys, old, new)
        want = diff_plain(algo, keys, old, new)
        err = max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want))
        if err:
            raise AssertionError(f"{algo}_diff {name}: kernel != plain ({err})")
        ms = self.time_ms(lambda: kernel_diff(algo, keys, old, new), reps=20)
        plain_ms = self.time_ms(lambda: diff_plain(algo, keys, old, new), reps=2, warmup=1)
        w_a: dict = {}
        w_b: dict = {}
        lookup_plain(algo, keys, *old, w_a)
        lookup_plain(algo, keys, *new, w_b)
        both = {k: w_a.get(k, 0) + w_b.get(k, 0) for k in set(w_a) | set(w_b)}
        bound_ms, bound_by = self.bound(
            self.algo_ops(algo, w_a, KEYS, old[1][0]) + self.algo_ops(algo, w_b, KEYS, new[1][0])
            + KEYS - self.diff_shared_ops(algo, both, old[1][0], new[1][0], keys),
            16 * KEYS + old_ops[2] + new_ops[2])
        lanes = (f", G={engine.dx_diff_lane_group(old[1][1], new[1][1])} lanes a key"
                 if algo == "dx" else "")
        pair = (", one top level: the pair kernel" if algo == "power"
                and power_level_of(old[1][0]) == power_level_of(new[1][0]) else "")
        if algo == "anchor":
            self.anchor_reads[f"anchor_diff {name}"] = (
                anchor_words(w_a, KEYS) + anchor_words(w_b, KEYS), old_ops[2] + new_ops[2], ms)
        log(f"check {algo}_diff {name}{lanes}{pair}: kernel == plain, moved "
            f"{int(got[2].sum())} of {KEYS}; kernel {ms:.6f} ms, plain {plain_ms:.3f} ms, "
            f"bound {bound_ms:.6f} ms ({bound_by}), {bound_ms / ms:.1%} of the bound")
        return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "max_abs_err": err}

    @staticmethod
    def anchor_trips(work: dict, name: str) -> None:
        """Log ``anchor_lookup``'s passes (removed buckets met) and successor
        reads a key, from the plain version's counters, and a model of its
        loads a key: ``anchor_one`` waits on 1 + 2 passes + 2 reads dependent
        loads (A[b] is read again at each pass, the word the chain's last
        test read) of 1 + passes + 2 reads distinct words; with K[h] loaded
        beside every A[h] and the chain's last read kept (a design that ran
        slower and was deleted) 1 + passes + reads round trips would load
        1 + 2 passes + 2 reads distinct words."""
        o, r = work.get("outer", 0) / KEYS, work.get("read", 0) / KEYS
        log(f"anchor_lookup {name}: {o:.4f} passes and {r:.4f} successor reads a key (plain "
            f"counters); model: anchor_one {1 + 2 * o + 2 * r:.4f} round trips and "
            f"{1 + o + 2 * r:.4f} distinct words a key, K loaded with every A "
            f"{1 + o + r:.4f} and {1 + 2 * o + 2 * r:.4f}")

    @staticmethod
    def power_model(keys, n: int, work: dict, name: str, ms: float) -> None:
        """Log ``power_lookup``'s warp model (:func:`power_rounds`) beside its
        time: from each key's draws and levels (:func:`power_work`), whose
        sums must equal the plain counters ``work``."""
        draws, levels = power_work(keys, n)
        got = [int(draws.sum()), int(levels.sum())]
        if got != [work.get("draw", 0), work.get("level", 0)]:
            raise AssertionError(f"power_rounds {name}: draws and levels {got} != the plain "
                                 f"counters' {work}")
        L = power_level_of(n)
        m = power_rounds(draws.cpu(), levels.cpu(), L)
        log(f"power_rounds {name} (n = {n}, L = {L}; {got[0]} draws and {got[1]} levels == "
            f"the plain counters): {float(draws.double().mean()):.4f} extra draws and "
            f"{float(levels.double().mean()):.4f} levels a key, deepest lane's a warp "
            f"{float(draws.reshape(-1, 32).amax(1).double().mean()):.4f} and "
            f"{float(levels.reshape(-1, 32).amax(1).double().mean()):.4f}; warp issue slots "
            f"a key (model): PR 24 {m['PR 24']:.2f}, the top level once a launch "
            f"{m['step 1']:.2f}, each draw's mix loaded (the kernel) {m['kept']:.2f} = "
            f"{m['kept'] * KEYS / INT32_OPS_PER_S * 1e3:.6f} ms at {INT32_OPS_PER_S:.4g} ops/s "
            f"(kernel {ms:.6f} ms)")

    @staticmethod
    def dx_rounds(keys, tables, scalars, name: str) -> None:
        """Log ``dx_lookup``'s lane group G (read from the kernel library),
        the mean probes a key, and the warp rounds a key (a model) with G
        lanes a key and with one thread a key."""
        from repro_torch.kernels import engine

        a, max_probes = scalars[0], scalars[1]
        _, probes = dx_probes(keys, tables[0], a, max_probes, scalars[2])
        g = engine.dx_lane_group(max_probes)
        log(f"dx_lookup {name}: a={a} max_probes={max_probes}, G={g} lanes a key; "
            f"{float(probes.double().mean()):.4f} probes a key (max {int(probes.max())}); "
            f"warp rounds a key (model) {warp_rounds(probes, g):.4f} at G={g}, "
            f"{warp_rounds(probes, 1):.4f} at one lane a key")

    # -- phase 3 ---------------------------------------------------------------
    def check_batch(self, router, ids, out, what: str) -> None:
        """``out`` of ``route_batch(ids)`` against the plain version on the
        front image, and every bucket working."""
        from repro_torch.core.hashing import np_key_to_u32
        from repro_torch.kernels.engine import key_tensor, memento_lookup_plain

        np = self.np
        img = router.image_store().image()
        repl = img.arrays["repl"]
        plain = memento_lookup_plain(key_tensor(np_key_to_u32(ids), self.dev),
                                     repl, img.n).cpu().numpy()
        if out.shape != (len(ids),) or out.dtype != np.int32 or not (out == plain).all():
            raise AssertionError(f"{what}: route_batch != plain version")
        if not ((out >= 0) & (out < img.n)).all() or (repl.cpu().numpy()[out] >= 0).any():
            raise AssertionError(f"{what}: a session routed to a removed replica")

    def run_batches(self, router, batches: int, what: str, lat: list) -> None:
        torch = self.torch
        for _ in range(batches):
            ids = self.rng.integers(0, 2**63, size=KEYS, dtype=self.np.uint64)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = router.route_batch(ids)
            lat.append((time.perf_counter() - t0) * 1e3)
            self.check_batch(router, ids, out, what)

    def report(self, what: str, lat: list, syncs: list, launches: dict) -> None:
        np = self.np
        sync_ms = [s for s, _ in syncs]
        modes: dict = {}
        for _, m in syncs:
            modes[m] = modes.get(m, 0) + 1
        log(f"scenario {what}: batches={len(lat)} of {KEYS} ids, keys/s="
            f"{KEYS * len(lat) / (sum(lat) / 1e3):.6g}, p50_lookup_ms={np.median(lat):.4f} "
            f"max_lookup_ms={max(lat):.4f}, syncs={len(syncs)} modes={modes} "
            + (f"p50_sync_ms={np.median(sync_ms):.4f} max_sync_ms={max(sync_ms):.4f} "
               if syncs else "") + f"launches={launches}")

    def working_victim(self, m) -> int:
        victim = int(self.rng.integers(m.n))
        while not m.is_working(victim):
            victim = int(self.rng.integers(m.n))
        return victim

    def phase_main_path(self, kernels: list[dict]) -> None:
        from repro_torch.core.hashing import np_key_to_u32
        from repro_torch.kernels import delta_apply, engine
        from repro_torch.kernels.engine import key_tensor, memento_diff_plain
        from repro_torch.serve.router import SessionRouter

        np, torch = self.np, self.torch
        counters = [engine.LAUNCHES, delta_apply.LAUNCHES]

        def snapshot():
            return {k: v for c in counters for k, v in c.items()}

        def since(before):
            now = snapshot()
            return {k: now[k] - before[k] for k in now}

        for c in counters:
            for k in c:
                c[k] = 0

        # stable, then one-shot removal of 90 % and one sync, on one router
        router = SessionRouter(N)
        t0 = time.perf_counter()
        store = router.image_store()
        torch.cuda.synchronize()
        log(f"store build (snapshot upload of {store.capacity['repl']} int32): "
            f"{(time.perf_counter() - t0) * 1e3:.3f} ms")
        before, lat = snapshot(), []
        self.run_batches(router, 10, "stable", lat)
        self.report("stable", lat, [], since(before))

        before, lat = snapshot(), []
        t0 = time.perf_counter()
        self.remove_random(router.ch, int(ONESHOT_FRACTION * N))
        log(f"host: one-shot removal, {router.ch.working} of {N} working, "
            f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
        t0 = time.perf_counter()
        st = store.sync()
        torch.cuda.synchronize()
        syncs = [((time.perf_counter() - t0) * 1e3, st.mode)]
        if st.mode != "snapshot":
            raise AssertionError(f"one-shot sync was {st.mode}, expected snapshot")
        keys = np_key_to_u32(self.rng.integers(0, 2**63, size=KEYS, dtype=np.uint64))
        t0 = time.perf_counter()
        diff = store.migration_diff(keys)
        torch.cuda.synchronize()
        diff_ms = (time.perf_counter() - t0) * 1e3
        prev, front = store.previous_image(), store.image()
        p_old, p_new, p_moved = memento_diff_plain(
            key_tensor(keys, self.dev), prev.arrays["repl"], prev.n,
            front.arrays["repl"], front.n)
        if not (torch.equal(diff.old, p_old) and torch.equal(diff.new, p_new)
                and torch.equal(diff.moved, p_moved)):
            raise AssertionError("migration_diff != plain version")
        log(f"one-shot migration_diff: {diff.num_moved} of {KEYS} keys moved, "
            f"{diff_ms:.4f} ms")
        self.run_batches(router, 10, "oneshot", lat)
        self.report("oneshot", lat, syncs, since(before))
        oneshot_router = router

        # incremental: single removals, each synced as a delta, then a batch
        router = SessionRouter(N)
        router.image_store()
        before, lat, syncs = snapshot(), [], []
        for _ in range(INCREMENTAL_EVENTS):
            victim = self.working_victim(router.ch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            info = router.fail_replica(victim)
            torch.cuda.synchronize()
            syncs.append(((time.perf_counter() - t0) * 1e3, info["control_plane"]["mode"]))
            self.run_batches(router, 1, "incremental", lat)
        if any(m != "delta" for _, m in syncs):
            raise AssertionError("an incremental removal did not sync as a delta")
        self.report("incremental", lat, syncs, since(before))

        # failover with overlapped syncs: mark, fail, restore
        router = SessionRouter(N, sync_mode="overlap")
        store = router.image_store()
        before, lat, syncs = snapshot(), [], []
        for _ in range(4):
            victim = self.working_victim(router.ch)
            router.mark_failed(victim)
            self.run_batches(router, 1, "failover", lat)
            t0 = time.perf_counter()
            info = router.fail_replica(victim)
            syncs.append(((time.perf_counter() - t0) * 1e3, info["control_plane"]["mode"]))
            self.run_batches(router, 1, "failover", lat)
        for _ in range(2):
            t0 = time.perf_counter()
            router.restore_replica()
            syncs.append(((time.perf_counter() - t0) * 1e3, store.pending.stats.mode))
            self.run_batches(router, 1, "failover", lat)
        store.flush()
        if store.epoch != router.ch.epoch or any(m != "delta" for _, m in syncs):
            raise AssertionError("overlap store missed the host epoch or a delta")
        self.run_batches(router, 1, "failover", lat)
        sids = self.rng.integers(0, 2**63, size=256, dtype=np.uint64)
        if [router.route(int(s)) for s in sids] != router.route_batch(sids).tolist():
            raise AssertionError("route() on the host != route_batch() on the card")
        self.report("failover (overlap)", lat, syncs, since(before))

        launches = snapshot()
        log(f"main-path launches: {launches}")
        for k in kernels:
            k["launches"] = launches[k["name"]]
            if k["launches"] <= 0:
                raise AssertionError(f"kernel {k['name']} was not launched on the main path")
        self.breakdown(oneshot_router)

    # -- phase 4: this slice's path ---------------------------------------------
    def phase_replay(self, kernels: list[dict]) -> None:
        """The paper's scenarios through ``repro_torch.sim`` on the card, for
        every algorithm, at w = 10^6 with 2^20 keys per batch."""
        from repro_torch.core.protocol import ALGORITHMS, DeltaEmitter
        from repro_torch.kernels import delta_apply, engine
        from repro_torch.sim import ScenarioDriver, make_trace

        np = self.np

        class CheckedDriver(ScenarioDriver):
            """The driver, with a host check of a sample of every lookup
            batch after the batch's timed part."""

            checked = 0

            def _lookup(self, keys, k=1):
                self._last = (keys, super()._lookup(keys, k))
                return self._last[1]

            def _do_lookup(self, i, ev):
                super()._do_lookup(i, ev)
                keys, out = self._last
                idx = np.linspace(0, len(keys) - 1, HOST_SAMPLE).astype(np.int64)
                host = [self.h.lookup(int(keys[j])) for j in idx]
                if host != out[idx].tolist():
                    raise AssertionError(f"{self.algo} event {i}: device lookup != host")
                self.checked += len(idx)

        counters = [engine.LAUNCHES, delta_apply.LAUNCHES]
        for c in counters:
            for k in c:
                c[k] = 0
        for algo in ALGORITHMS:
            for scenario in REPLAYED:
                trace = make_trace(scenario, SEED, w=N, n_keys=KEYS)
                t0 = time.perf_counter()
                driver = CheckedDriver(trace, algo=algo, plane="device", probe_keys=KEYS)
                res = driver.run()
                wall = time.perf_counter() - t0
                if not res.ok:
                    raise AssertionError(f"replay {scenario} {algo}: {res.violations[:3]}")
                self.fingerprints[(scenario, algo, "full")] = res.fingerprint
                summ = res.summary()
                syncs = [(r.op, len(r.buckets), r.sync_mode, round(r.sync_us / 1e3, 3),
                          r.moved) for r in res.metrics.records if r.sync_mode]
                log(f"replay {scenario} {algo}: w={N} keys={KEYS} events={summ['events']} "
                    f"working {N} -> {res.final_working}, lookup_us_per_key="
                    f"{summ.get('lookup_us_per_key', 0):.6f} over "
                    f"{summ.get('lookup_keys_total', 0)} keys, host-checked {driver.checked}, "
                    f"syncs (op, events, mode, ms, moved)={syncs}, violations=0, "
                    f"fingerprint {res.fingerprint}, wall {wall:.1f} s")
        # k-replica sets under churn: the replica-stability checker reads
        # the k = 2 epoch diff after every removal burst
        trace = make_trace("incremental", SEED, w=N, n_keys=KEYS)
        t0 = time.perf_counter()
        driver = CheckedDriver(trace, algo="memento", plane="device",
                               probe_keys=REPLICA_PROBE_KEYS, replica_k=2)
        res = driver.run()
        if not res.ok:
            raise AssertionError(f"replay incremental replica_k=2: {res.violations[:3]}")
        moved = [r.moved for r in res.metrics.records if r.sync_mode]
        log(f"replay incremental memento replica_k=2: w={N} keys={KEYS} probe keys "
            f"{REPLICA_PROBE_KEYS}, working {N} -> {res.final_working}, replica-stability "
            f"checked after {len(moved)} syncs (moved {moved}), host-checked "
            f"{driver.checked}, violations=0, fingerprint {res.fingerprint}, wall "
            f"{time.perf_counter() - t0:.1f} s")
        launches = {k: v for c in counters for k, v in c.items()}
        log(f"phase 4 launches: {launches} (a burst longer than the host's "
            f"{DeltaEmitter._DELTA_LOG_CAP}-event delta log syncs as a snapshot)")
        for k in kernels:
            k["launches"] = launches[k["name"]]
        for name in [f"{a}_{m}" for a in ALGORITHMS for m in ("lookup", "diff")]:
            if launches[name] <= 0:
                raise AssertionError(f"kernel {name} was not launched on the replay path")
        if launches["memento_replica_diff"] <= 0:
            raise AssertionError("the replica_k=2 replay never reached memento_replica_diff")

    def phase_host_vs_device(self) -> None:
        """Every scenario at its default size: card and host replays agree."""
        from repro_torch.core.protocol import ALGORITHMS
        from repro_torch.kernels import delta_apply, engine
        from repro_torch.sim import SCENARIOS, make_trace, replay

        counters = [engine.LAUNCHES, delta_apply.LAUNCHES]
        for c in counters:
            for k in c:
                c[k] = 0
        t0 = time.perf_counter()
        count = 0
        for scenario in SCENARIOS:
            for algo in ALGORITHMS:
                dev = replay(make_trace(scenario, SEED), algo=algo, plane="device")
                host = replay(make_trace(scenario, SEED), algo=algo, plane="host")
                if not (dev.ok and host.ok and dev.fingerprint == host.fingerprint):
                    raise AssertionError(f"4b {scenario} {algo}: device {dev.fingerprint} "
                                         f"host {host.fingerprint}, violations "
                                         f"{dev.violations[:2]} {host.violations[:2]}")
                self.fingerprints[(scenario, algo, "default")] = dev.fingerprint
                count += 1
        launches = {k: v for c in counters for k, v in c.items()}
        log(f"phase 4b: {count} replays (every scenario x every algorithm) equal on "
            f"the card and on the host, no violations, {time.perf_counter() - t0:.1f} s; "
            f"launches {launches}")
        if launches["delta_apply"] <= 0:
            raise AssertionError("no delta sync reached the delta_apply kernel in 4b")
        for algo in ALGORITHMS:  # session_affinity's k-replica failover
            if launches[f"{algo}_replica"] <= 0:
                raise AssertionError(f"session_affinity never reached {algo}_replica in 4b")

    # -- phase 5: this slice's path --------------------------------------------
    def phase_replicas(self) -> list[dict]:
        """k-replica, bounded and chain-walk lookups: the path with the
        launch counts reset just before it, then every result against its
        plain version and the host, then the kernels' times."""
        from repro_torch.core.protocol import ALGORITHMS
        from repro_torch.kernels import delta_apply, engine

        counters = [engine.LAUNCHES, delta_apply.LAUNCHES]
        for c in counters:
            for k in c:
                c[k] = 0
        t0 = time.perf_counter()
        ids = self.replica_route()
        runs = {algo: self.replica_path(algo) for algo in ALGORITHMS}
        launches = {k: v for c in counters for k, v in c.items()}
        log(f"phase 5 path: {time.perf_counter() - t0:.1f} s; launches {launches}")
        for name in [f"{a}_{m}" for a in ALGORITHMS
                     for m in ("replica", "replica_diff", "walk")]:
            if launches[name] <= 0:
                raise AssertionError(f"kernel {name} was not launched on the phase 5 path")
        t0 = time.perf_counter()
        rows = []
        for algo in ALGORITHMS:
            rows += self.check_replica_kernels(algo, runs[algo], launches)
        self.gather_rate()
        self.check_assign(runs["memento"])
        self.replica_breakdown(ids)
        log(f"phase 5 checks and timing: {time.perf_counter() - t0:.1f} s")
        return rows

    def replica_route(self):
        """``route_batch`` with ``replicas_k = 3`` over 10^6 replicas: stable,
        a replica marked failed (failover before any delta), its removal
        (one-word delta) and its restore."""
        from repro_torch.serve.router import SessionRouter

        np, torch = self.np, self.torch
        router = SessionRouter(N, replicas_k=REPLICAS_K)
        router.image_store()
        ids = self.rng.integers(0, 2**63, size=KEYS, dtype=np.uint64)
        lat: dict = {}

        def batch(what):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = router.route_batch(ids)
            lat.setdefault(what, []).append((time.perf_counter() - t0) * 1e3)
            return out

        base = batch("stable")
        for _ in range(2):
            if not (batch("stable") == base).all():
                raise AssertionError("route_batch is not repeatable")
        victim = int(np.bincount(base).argmax())  # the replica with the most sessions
        router.mark_failed(victim)
        for _ in range(5):
            out = batch("marked")
            if victim in set(out.tolist()):
                raise AssertionError("a session was routed to the marked replica")
            if not (out == base)[base != victim].all():
                raise AssertionError("a session whose primary was not marked moved")
        sets = router.replica_set_batch(ids)
        hit = base == victim
        if not ((sets[:, 0] == base).all() and (out[hit] == sets[hit, 1]).all()
                and router.stats.failovers > 0):
            raise AssertionError("failover did not take the next replica")
        failovers = router.stats.failovers
        t0 = time.perf_counter()
        info = router.fail_replica(victim)
        torch.cuda.synchronize()
        fail_ms = (time.perf_counter() - t0) * 1e3
        if info["control_plane"]["mode"] != "delta":
            raise AssertionError(f"removal synced as {info['control_plane']}")
        for _ in range(3):
            out = batch("removed")
            if victim in set(out.tolist()) or not (out == base)[~hit].all():
                raise AssertionError("removal moved more than the victim's sessions")
        t0 = time.perf_counter()
        router.restore_replica()
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        for _ in range(3):
            if not (batch("restored") == base).all():
                raise AssertionError("the restore did not bring every session back")
        log(f"route_batch replicas_k={REPLICAS_K}: {KEYS} sessions over {N} replicas; "
            + "; ".join(f"{w} p50 {np.median(v):.4f} / max {max(v):.4f} ms ({len(v)} batches)"
                        for w, v in lat.items())
            + f"; replica {victim} marked: {int(hit.sum())} sessions failed over "
            f"({failovers} failovers counted), none routed to it, the rest kept their "
            f"primary; fail_replica {fail_ms:.4f} ms ({info['control_plane']['mode']}, "
            f"{info['control_plane']['words']} words), restore {restore_ms:.4f} ms, "
            f"every session back on its primary")
        self.router_k = (router, victim)
        return ids

    def replica_path(self, algo: str) -> dict:
        """One algorithm through the engine's entry points on phase 2's
        states: k = 3 sets stable and one-shot, a bounded assignment of
        2^20 keys, the bounded k = 2 lookup under its load, the k = 3 diff
        and a chain-walk step on a mixed pending mask."""
        from repro_torch.kernels import engine
        from repro_torch.sim.checkers import check_cap_invariant

        np, torch = self.np, self.torch
        h, stable, oneshot = self.kept[algo]
        keys_np, keys = self.keys()
        run = {"keys_np": keys_np, "keys": keys,
               "stable": engine.engine_lookup(keys, stable, k=REPLICAS_K),
               "oneshot": engine.engine_lookup(keys, oneshot, k=REPLICAS_K)}
        assign = self.rng.integers(0, 2**32, size=KEYS, dtype=np.uint32)
        cap = int(np.ceil(CAP_C * KEYS / h.working))
        load0 = np.zeros(engine.bounded_load_len(oneshot), np.int32)
        before = engine.LAUNCHES[f"{algo}_walk"]
        t0 = time.perf_counter()
        out, load = engine.bounded_assign(assign, oneshot, load0, cap)
        wall_ms = (time.perf_counter() - t0) * 1e3
        rounds = engine.LAUNCHES[f"{algo}_walk"] - before
        found = check_cap_invariant(0, out, load, cap)
        if found or load.sum() != KEYS:
            raise AssertionError(f"bounded_assign {algo}: {found}")
        run["assign"] = (assign, load0, cap, out, load, rounds, wall_ms)
        load_t = torch.from_numpy(load).to(self.dev)
        run["bounded"] = engine.engine_lookup(keys, oneshot, k=BOUNDED_K, load=load_t, cap=cap)
        run["diff"] = engine.engine_diff(keys, stable, oneshot, k=REPLICAS_K)
        pending = self.rng.random(KEYS) < 0.5
        probe = np.zeros(KEYS, np.int32)
        run["walk_in"] = (keys_np, probe, pending, load_t, cap)
        run["walk"] = engine.engine_chain_walk(keys_np, probe, pending, oneshot, load_t, cap)
        if algo == "anchor":  # the replica diff's two-walk branch; every lane pending
            run["diverge_in"] = self.diverging_pair(h)
            run["diverge"] = engine.engine_diff(keys, *run["diverge_in"], k=REPLICAS_K)
            run["walk_all"] = engine.engine_chain_walk(keys_np, probe, np.ones(KEYS, bool),
                                                       oneshot, load_t, cap)
        torch.cuda.synchronize()
        full = float((load >= cap).sum()) / h.working
        log(f"path {algo}: k={REPLICAS_K} sets stable and one-shot; bounded_assign of "
            f"{KEYS} keys at c={CAP_C} (cap {cap}, {h.working} working, {full:.2%} of "
            f"them full): {rounds} rounds = walk launches, {wall_ms:.3f} ms, cap "
            f"invariant silent; bounded k={BOUNDED_K}; k={REPLICAS_K} diff stable -> "
            f"one-shot moved {run['diff'].num_moved}; walk step on "
            f"{int(pending.sum())} pending lanes")
        return run

    def diverging_pair(self, h):
        """Two images on the card whose removal stacks part after ``h``'s:
        ``h`` with a working bucket x removed, and with x restored and
        another bucket y removed; ``h`` is left as it was."""
        x, y = (int(b) for b in self.rng.choice(sorted(h.working_set()), 2, replace=False))
        h.remove(x)
        old = self.on_card(h.device_image())
        h.add()
        h.remove(y)
        new = self.on_card(h.device_image())
        h.add()
        return old, new

    def host_walk(self, h, chain: int, probe: int, pending: bool, load, cap: int):
        """The host's chain-walk step of one lane."""
        from repro_torch.core.bounded import walk_probe_bound
        from repro_torch.core.hashing import hash2_32

        b = h.lookup(chain)
        if pending:
            while load[b] >= cap and probe < walk_probe_bound(len(load)):
                probe += 1
                chain = hash2_32(chain, probe)
                b = h.lookup(chain)
        return b, chain, probe

    def timed_plain(self, fn):
        """Run a plain version once (it synchronizes inside); its ms."""
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        self.torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def check_replica_kernels(self, algo: str, run: dict, launches: dict) -> list[dict]:
        """The path's results against the plain versions on the card (max
        abs error 0) and 2048 keys against the host; kernel times."""
        from repro_torch.kernels import engine

        np, torch = self.np, self.torch
        h, stable, oneshot = self.kept[algo]
        keys_np, keys = run["keys_np"], run["keys"]
        sample = np.arange(0, KEYS, KEYS // KERNEL_SAMPLE)
        ops_of = {"stable": engine.image_operands(stable),
                  "oneshot": engine.image_operands(oneshot)}
        tbytes = {k: sum(4 * t.numel() for t in v[0]) for k, v in ops_of.items()}

        def err(a, b):
            a, b = (torch.as_tensor(x).cpu().long() for x in (a, b))
            return int((a - b).abs().max()) if a.numel() else 0

        def row(mode, by_state, head):
            h_ = by_state[head]
            return {"name": f"{algo}_{mode}", "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/engine.cu",
                    "replaces": "src/repro/kernels/engine.py:526",
                    "launches": launches[f"{algo}_{mode}"],
                    "max_abs_err": max(v["max_abs_err"] for v in by_state.values()),
                    "ms": h_["ms"], "plain_ms": h_["plain_ms"], "bound_ms": h_["bound_ms"],
                    "bound_by": h_["bound_by"], "library_ms": None, "state": head,
                    "by_state": by_state}

        def entry(name, e, ms, plain_ms, ops, nbytes, work):
            bound_ms, bound_by = self.bound(ops, nbytes)
            log(f"check {algo}_{name}: keys={KEYS} kernel == plain (max abs err {e}); "
                f"kernel {ms:.6f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.6f} ms "
                f"({bound_by}: {ops / KEYS:.2f} ops/key from "
                f"{ {k: round(v / KEYS, 3) for k, v in work.items()} } per key), "
                f"{bound_ms / ms:.1%} of the bound")
            return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "max_abs_err": e}

        # {algo}_replica, unbounded k = 3, and bounded k = 2 under the load
        replica, works = {}, {}
        for name in ("stable", "oneshot"):
            tables, scalars = ops_of[name]
            works[name] = {}
            plain, plain_ms = self.timed_plain(lambda: engine.replica_plain(
                algo, keys, REPLICAS_K, tables, scalars, work=works[name]))
            e = err(run[name], plain)
            if e:
                raise AssertionError(f"{algo}_replica {name}: kernel != plain ({e})")
            ms = self.time_ms(lambda: engine.kernel_replica(algo, keys, REPLICAS_K, tables,
                                                            scalars), reps=10, warmup=1)
            replica[f"{name} k={REPLICAS_K}"] = entry(
                f"replica {name} k={REPLICAS_K}", e, ms, plain_ms,
                self.mode_ops(algo, works[name], KEYS, scalars[0], REPLICAS_K),
                4 * KEYS * (1 + REPLICAS_K) + tbytes[name], works[name])
            if algo == "anchor":
                self.anchor_reads[f"anchor_replica {name} k={REPLICAS_K}"] = (
                    anchor_words(works[name], KEYS), tbytes[name], ms)
        host = [h.lookup_k(int(x), REPLICAS_K) for x in keys_np[sample]]
        if host != run["oneshot"][sample].tolist():
            raise AssertionError(f"{algo}_replica one-shot: kernel != host lookup_k")
        tables, scalars = ops_of["oneshot"]
        _, _, _, load_t, cap = run["walk_in"]
        load_np = load_t.cpu().numpy()
        work: dict = {}
        plain, plain_ms = self.timed_plain(lambda: engine.replica_plain(
            algo, keys, BOUNDED_K, tables, scalars, load_t, cap, work))
        e = err(run["bounded"], plain)
        if e:
            raise AssertionError(f"{algo}_replica bounded: kernel != plain ({e})")
        want = engine.bounded_replica_sets(h, keys_np[sample], BOUNDED_K, load_np, cap)
        if not (want == run["bounded"][sample].cpu().numpy()).all():
            raise AssertionError(f"{algo}_replica bounded: kernel != host")
        ms = self.time_ms(lambda: engine.kernel_replica(algo, keys, BOUNDED_K, tables, scalars,
                                                        load_t, cap), reps=10, warmup=1)
        replica[f"oneshot bounded k={BOUNDED_K} c={CAP_C}"] = entry(
            f"replica bounded k={BOUNDED_K} cap={cap}", e, ms, plain_ms,
            self.mode_ops(algo, work, KEYS, scalars[0], BOUNDED_K, bounded=True),
            4 * KEYS * (1 + BOUNDED_K) + tbytes["oneshot"] + 4 * load_t.numel(), work)
        if algo == "anchor":
            self.anchor_reads[f"anchor_replica oneshot bounded k={BOUNDED_K}"] = (
                anchor_words(work, KEYS, work.get("try", 0)),
                tbytes["oneshot"] + 4 * load_t.numel(), ms)

        if algo == "dx":  # the lanes a key, beside dx_lookup's and dx_diff's (phase 2)
            log("dx_replica and dx_walk: " + ", ".join(
                f"{name} G={engine.dx_replica_lane_group(sc[1])} and "
                f"{engine.dx_walk_lane_group(sc[1])} lanes a key (max_probes {sc[1]})"
                for name, (_, sc) in ops_of.items())
                + "; dx_replica_diff stable -> oneshot G="
                f"{engine.dx_replica_diff_lane_group(*(sc[1] for _, sc in ops_of.values()))} "
                "(at G >= 8 each epoch's rows at dx_replica's G, then a compare pass)")

        # {algo}_replica_diff, k = 3, stable -> one-shot
        d = run["diff"]
        old, new = ops_of["stable"], ops_of["oneshot"]
        (p_old, p_new, p_moved), plain_ms = self.timed_plain(
            lambda: engine.replica_diff_plain(algo, keys, REPLICAS_K, old, new))
        e = max(err(d.old, p_old), err(d.new, p_new), int((d.moved != p_moved).sum()))
        if e or not (torch.equal(d.old, run["stable"]) and torch.equal(d.new, run["oneshot"])):
            raise AssertionError(f"{algo}_replica_diff: kernel != plain / replica sets ({e})")
        ms = self.time_ms(lambda: engine.kernel_replica_diff(algo, keys, REPLICAS_K, old, new),
                          reps=10, warmup=1)
        if algo == "anchor":
            diff = self.anchor_replica_diff_branches(run, ops_of, tbytes, (e, ms, plain_ms),
                                                     entry, err)
        else:
            both = {k: works["stable"].get(k, 0) + works["oneshot"].get(k, 0)
                    for k in set(works["stable"]) | set(works["oneshot"])}
            ops = (self.mode_ops(algo, works["stable"], KEYS, old[1][0], REPLICAS_K)
                   + self.mode_ops(algo, works["oneshot"], KEYS, new[1][0], REPLICAS_K)
                   + 2 * REPLICAS_K * KEYS - self.pair_shared_ops(
                       algo, keys, [works["stable"], works["oneshot"]], old, new, "dense"))
            diff = {f"stable -> oneshot k={REPLICAS_K}": entry(
                f"replica_diff stable -> oneshot, moved {d.num_moved}", e, ms, plain_ms, ops,
                4 * KEYS * (2 + 2 * REPLICAS_K) + tbytes["stable"] + tbytes["oneshot"], both)}

        # {algo}_walk on a mixed pending mask
        chain_np, probe_np, pending_np, load_t, cap = run["walk_in"]
        chain = engine.key_tensor(chain_np, self.dev)
        probe = torch.from_numpy(probe_np).to(self.dev)
        pending = torch.from_numpy(pending_np).to(self.dev)
        work = {}
        plain, plain_ms = self.timed_plain(lambda: engine.walk_plain(
            algo, chain, probe, pending, tables, scalars, load_t, cap, work))
        b, ch, pr = run["walk"]
        e = max(err(b, plain[0]), err(ch.view(np.int32), plain[1]), err(pr, plain[2]))
        if e:
            raise AssertionError(f"{algo}_walk: kernel != plain ({e})")
        for j in sample:
            want = self.host_walk(h, int(chain_np[j]), 0, bool(pending_np[j]), load_np, cap)
            if want != (int(b[j]), int(ch[j]), int(pr[j])):
                raise AssertionError(f"{algo}_walk lane {j}: kernel != host walk")
        ms = self.time_ms(lambda: engine.kernel_walk(algo, chain, probe, pending, tables,
                                                     scalars, load_t, cap), reps=10, warmup=1)
        walk = {f"oneshot cap={cap}": entry(
            f"walk ({int(pending_np.sum())} pending, {work.get('walk', 0)} steps)", e, ms,
            plain_ms, self.mode_ops(algo, work, KEYS, scalars[0], walk=True),
            21 * KEYS + tbytes["oneshot"] + 4 * load_t.numel(), work)}
        if algo == "anchor":
            self.anchor_reads[f"anchor_walk oneshot cap={cap}"] = (
                anchor_words(work, KEYS, int(pending_np.sum()) + work.get("walk", 0)),
                tbytes["oneshot"] + 4 * load_t.numel(), ms)
            walk[f"oneshot cap={cap} every lane pending"] = self.anchor_walk_all(
                run, chain, probe, tables, scalars, load_t, cap, tbytes, entry, err)
            self.anchor_walk_model(chain, probe, pending, tables, scalars, load_t, cap)
        if algo in ("memento", "jump"):
            self.walk_model(algo, probe, pending, plain[2], load_t.numel(), work)
        log(f"check {algo}: {KERNEL_SAMPLE} keys of the replica sets, the bounded sets and "
            f"the walk equal the host (lookup_k, bounded_replica_sets, the host walk)")
        return [row("replica", replica, f"oneshot k={REPLICAS_K}"),
                row("replica_diff", diff, f"stable -> oneshot k={REPLICAS_K}"),
                row("walk", walk, f"oneshot cap={cap}")]

    def anchor_replica_diff_branches(self, run, ops_of, tbytes, timed, entry,
                                     err) -> dict:
        """``anchor_replica_diff`` on both of its branches: the path's
        stable -> one-shot diff (epochs that nest: one walk through the
        one-shot epoch's tables; ``timed`` its max abs error, ms and plain
        ms) and its diverging pair (:meth:`diverging_pair`: each epoch's
        replica_row), the second held against its plain version and timed;
        each with the branch its check took (read back from the call's own
        workspace, and equal to the plain check's) and the check's own time.
        The bound counts the check and, where the epochs nest, one walk
        (the pair model's work, :func:`~repro_torch.kernels.engine.
        anchor_pair_replica_diff_plain`; the two walks' bound is logged
        beside it).  Each pair's words a key, the check's A and K words
        included, go to the gather-rate line.  Returns both by-state
        entries."""
        from repro_torch.kernels import engine

        keys = run["keys"]
        names = {engine.NEST_NONE: "two walks (the epochs do not nest)",
                 engine.NEST_OLD_SHALLOW: "one walk (the older epoch the shallower)",
                 engine.NEST_NEW_SHALLOW: "one walk (the newer epoch the shallower)"}
        pairs = [("stable -> oneshot", ops_of["stable"], ops_of["oneshot"], run["diff"],
                  engine.NEST_OLD_SHALLOW, tbytes["stable"] + tbytes["oneshot"]),
                 ("diverging pair", *(engine.image_operands(i) for i in run["diverge_in"]),
                  run["diverge"], engine.NEST_NONE, 2 * tbytes["oneshot"])]
        out = {}
        for name, old, new, d, want, table_bytes in pairs:
            if name == "stable -> oneshot":
                e, ms, plain_ms = timed
            else:
                p, plain_ms = self.timed_plain(
                    lambda: engine.replica_diff_plain("anchor", keys, REPLICAS_K, old, new))
                e = max(err(d.old, p[0]), err(d.new, p[1]), int((d.moved != p[2]).sum()))
                if e:
                    raise AssertionError(f"anchor_replica_diff {name}: kernel != plain ({e})")
                ms = self.time_ms(lambda: engine.kernel_replica_diff(
                    "anchor", keys, REPLICAS_K, old, new), reps=10, warmup=1)
            nest = engine.kernel_replica_diff("anchor", keys, REPLICAS_K, old, new,
                                              with_nest=True)[3]
            branch = tuple(nest.tolist())
            alone = tuple(engine.anchor_nest_check(old, new).tolist())
            if branch != engine.anchor_nest_plain(old, new) or branch != alone \
                    or branch[0] != want:
                raise AssertionError(f"anchor_replica_diff {name}: the check's verdict "
                                     f"{branch} (alone {alone}), the plain check's "
                                     f"{engine.anchor_nest_plain(old, new)}, want {want}")
            check_ms = self.time_ms(lambda: engine.anchor_nest_check(old, new), reps=20)
            a = old[1][0]
            removed = int(((old[0][0][:a] > 0) | (new[0][0][:a] > 0)).sum())
            check_words = 2 * a + 2 * removed  # both As, and both Ks where either removed
            both: dict = {}
            engine.replica_diff_plain("anchor", keys, REPLICAS_K, old, new, both)
            walks_ops = self.mode_ops("anchor", both, 2 * KEYS, a, REPLICAS_K)
            work = both
            ops = walks_ops
            if branch[0] != engine.NEST_NONE:
                work = {}
                engine.anchor_pair_replica_diff_plain(keys, REPLICAS_K, old, new, work)
                ops = self.mode_ops("anchor", {**work, "compare": both.get("compare", 0)},
                                    KEYS, a, 2 * REPLICAS_K)
            extra = 2 * REPLICAS_K * KEYS + a * OPS_PER_NEST_BUCKET
            nbytes = 4 * KEYS * (2 + 2 * REPLICAS_K) + table_bytes
            walks_ms, _ = self.bound(walks_ops + extra, nbytes)
            log(f"anchor_replica_diff {name} k={REPLICAS_K}: branch {branch[0]}, "
                f"{names[branch[0]]}, N_S = {branch[1]}; the check alone {check_ms:.6f} ms "
                f"({check_words / 1e6:.3f} M words: both As, both Ks at the {removed} "
                f"buckets either epoch removed) of the call's {ms:.6f} ms; bound with two "
                f"walks counted {walks_ms:.6f} ms")
            self.anchor_reads[f"anchor_replica_diff {name} k={REPLICAS_K}"] = (
                anchor_words(work, KEYS if work is not both else 2 * KEYS) + check_words,
                table_bytes, ms)
            out[f"{name} k={REPLICAS_K}"] = entry(
                f"replica_diff {name} ({names[branch[0]]}), moved {d.num_moved}", e, ms,
                plain_ms, ops + extra, nbytes, work)
        return out

    def anchor_walk_all(self, run, chain, probe, tables, scalars, load_t, cap: int, tbytes,
                        entry, err) -> dict:
        """``anchor_walk`` on the path's every-lane-pending step, against its
        plain version and timed: its by-state entry."""
        from repro_torch.kernels import engine

        torch = self.torch
        every = torch.ones_like(chain, dtype=torch.bool)
        work: dict = {}
        plain, plain_ms = self.timed_plain(lambda: engine.walk_plain(
            "anchor", chain, probe, every, tables, scalars, load_t, cap, work))
        b, ch, pr = run["walk_all"]
        e = max(err(b, plain[0]), err(ch.view(self.np.int32), plain[1]), err(pr, plain[2]))
        if e:
            raise AssertionError(f"anchor_walk every lane pending: kernel != plain ({e})")
        ms = self.time_ms(lambda: engine.kernel_walk("anchor", chain, probe, every, tables,
                                                     scalars, load_t, cap), reps=10, warmup=1)
        self.anchor_reads[f"anchor_walk oneshot cap={cap} every lane pending"] = (
            anchor_words(work, KEYS, KEYS + work.get("walk", 0)),
            tbytes["oneshot"] + 4 * load_t.numel(), ms)
        return entry(f"walk ({KEYS} pending, {work.get('walk', 0)} steps)", e, ms, plain_ms,
                     self.mode_ops("anchor", work, KEYS, scalars[0], walk=True),
                     21 * KEYS + tbytes["oneshot"] + 4 * load_t.numel(), work)

    def anchor_walk_model(self, chain, probe, pending, tables, scalars, load_t,
                          cap: int) -> None:
        """Log ``anchor_walk``'s warp and slot model (:func:`walk_slots`
        over :func:`walk_step_trips`) on the path's mixed and every-lane
        masks: lookup rounds and lane lookups a warp, and the round trips a
        block holds its slots, of ``walk_kernel`` (one thread a lane)."""
        (A, K), (a,) = tables, scalars
        for label, mask in (("half the lanes", pending),
                            ("every lane", self.torch.ones_like(pending))):
            trips = walk_step_trips(chain, probe, mask, load_t, cap,
                                    lambda k: anchor_lookup_trips(k, A, K, a)).cpu()
            m = walk_slots(trips)
            log(f"anchor_walk model, {label} pending ({int((trips[:, 1:] > 0).sum())} steps, "
                f"{float(trips[:, 0].double().mean()):.4f} round trips a first lookup), "
                f"{WALK_BLOCK} lanes a block: {m['rounds']:.4f} rounds and "
                f"{m['lookups']:.4f} lane lookups a warp, slot {m['slot']:.4f} round trips "
                f"a block; a lookup kernel's slot {m['lookup slot']:.4f}")

    def walk_model(self, algo: str, probe, pending, probe_out, load_len: int,
                   work: dict) -> None:
        """Log ``{algo}_walk``'s lookup rounds a warp and lane lookups a warp
        (a model, :func:`walk_rounds`) at one step a round, as
        ``walk_kernel`` runs it, and with up to S steps of each open lane a
        round on the warp's lanes for each of WALK_LOOKAHEAD_STEPS (a design
        that lost on both walks).  From the plain walk's per-lane steps,
        whose sum must equal its counter."""
        from repro_torch.core.bounded import walk_probe_bound

        steps = (probe_out.long() - probe.long()) * pending
        if int(steps.sum()) != work.get("walk", 0):
            raise AssertionError(f"{algo}_walk model: {int(steps.sum())} steps != the plain "
                                 f"walk's counter {work.get('walk', 0)}")
        max_probe = walk_probe_bound(load_len)
        rounds = {s: walk_rounds(steps, probe.long(), max_probe, s)
                  for s in (1, *WALK_LOOKAHEAD_STEPS)}
        log(f"{algo}_walk model ({int(steps.sum())} steps == the plain walk's counter, "
            f"warps of 32): lookup rounds and lane lookups a warp at one step a round "
            f"(walk_kernel) {rounds[1][0]:.4f} and {rounds[1][1]:.4f}; with up to S steps "
            f"of each open lane a round on the warp's lanes (a look-ahead that lost "
            f"one-shot and was deleted) " + ", ".join(
                f"S={s} {r:.4f} and {q:.4f}" for s, (r, q) in rounds.items() if s > 1))

    def gather_rate(self) -> None:
        """The card's random-word rate, a yardstick: ``torch.index_select``
        of GATHER_WORDS uniformly random int32 indices from int32 tables of
        each GATHER_TABLE_MB (each table written, then warmed by a call, then
        timed by CUDA events), in G words/s; beside it each AnchorHash entry's
        words a key (:func:`anchor_words`, its plain counters), the G words/s
        its kernel time gives, and its gather-rate ms: its words at the
        probe's rate for its footprint (the smallest table at least as large,
        else the largest).  No entry calls ``index_select``."""
        torch = self.torch
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(SEED)
        for mb in GATHER_TABLE_MB:
            words = mb * 10**6 // 4
            table = torch.empty(words, dtype=torch.int32, device=self.dev)
            idx = torch.randint(0, words, (GATHER_WORDS,), generator=gen, device=self.dev,
                                dtype=torch.int32)
            table.random_(generator=gen)
            ms = self.time_ms(lambda: torch.index_select(table, 0, idx), reps=20)
            self.gather[mb] = GATHER_WORDS / (ms * 1e-3) / 1e9
            del table, idx
        log(f"gather rate (index_select of {GATHER_WORDS} random int32 words, G words/s): "
            + ", ".join(f"{mb} MB {r:.3f}" for mb, r in self.gather.items())
            + "; AnchorHash entries (words a key: 1 + passes + 2 successor reads a lookup, "
            "+ load reads): " + "; ".join(self.anchor_read_text(name, *v)
                                          for name, v in self.anchor_reads.items()))

    def anchor_read_text(self, name: str, words: int, footprint: int, ms: float) -> str:
        """An AnchorHash entry's words a key, the G words/s its kernel time
        gives, and its gather-rate ms: ``words`` at the probe's rate for a
        footprint of ``footprint`` bytes."""
        sizes = [mb for mb in self.gather if mb * 10**6 >= footprint] or [max(self.gather)]
        gather_ms = words / (self.gather[min(sizes)] * 1e9) * 1e3
        return (f"{name} {words / KEYS:.4f} words a key, {words / (ms * 1e-3) / 1e9:.3f} "
                f"G words/s, gather-rate ms {gather_ms:.6f} ({footprint / 1e6:.3f} MB)")

    def check_assign(self, run: dict) -> None:
        """The path's Memento ``bounded_assign`` against the same loop
        through the plain walk on the card, and a 2^14-key batch against
        the host reference."""
        from repro_torch.core.bounded import bounded_assign_ref
        from repro_torch.kernels import engine

        np = self.np
        h, _, oneshot = self.kept["memento"]
        assign, load0, cap, out, load, rounds, wall_ms = run["assign"]
        t0 = time.perf_counter()
        p_out, p_load = engine.bounded_assign(assign, oneshot, load0, cap,
                                              walk=engine.walk_plain)
        plain_ms = (time.perf_counter() - t0) * 1e3
        if not ((p_out == out).all() and (p_load == load).all()):
            raise AssertionError("bounded_assign: the walk kernel's run != the plain walk's")
        small = assign[:ASSIGN_HOST_KEYS]
        cap_s = int(np.ceil(CAP_C * len(small) / h.working))
        zeros = np.zeros_like(load0)
        got = engine.bounded_assign(small, oneshot, zeros, cap_s)
        want = bounded_assign_ref(h, small, zeros, cap_s)
        if not all((g == w).all() for g, w in zip(got, want)):
            raise AssertionError("bounded_assign of 2^14 keys != bounded_assign_ref on the host")
        log(f"bounded_assign memento one-shot: {KEYS} keys at c={CAP_C}, cap {cap}: "
            f"{rounds} rounds = {rounds} memento_walk launches, {wall_ms:.3f} ms wall; "
            f"== the same loop through the plain walk on the card ({plain_ms:.3f} ms), "
            f"peak load {int(load.max())} <= cap; {ASSIGN_HOST_KEYS} keys (cap {cap_s}) "
            f"== bounded_assign_ref on the host")

    def replica_breakdown(self, ids) -> None:
        """Where a failover ``route_batch`` goes: the router of
        ``replica_route`` with its replica marked again."""
        from repro_torch.core.hashing import np_key_to_u32
        from repro_torch.kernels.engine import image_operands, kernel_replica, key_tensor

        np, torch = self.np, self.torch
        router, victim = self.router_k
        router.mark_failed(victim)
        tables, scalars = image_operands(router.image_store().image())
        rows, lat = [], []
        for _ in range(10):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            keys = np_key_to_u32(ids)
            t1 = time.perf_counter()
            ev[0].record()
            kt = key_tensor(keys, self.dev)
            ev[1].record()
            sets = kernel_replica("memento", kt, REPLICAS_K, tables, scalars)
            ev[2].record()
            host = sets.cpu().numpy()
            ev[3].record()
            t2 = time.perf_counter()
            router._failover_pick(host)
            t3 = time.perf_counter()
            ev[3].synchronize()
            rows.append(((t1 - t0) * 1e3, ev[0].elapsed_time(ev[1]),
                         ev[1].elapsed_time(ev[2]), ev[2].elapsed_time(ev[3]),
                         (t3 - t2) * 1e3, (t3 - t0) * 1e3))
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            router.route_batch(ids)
            lat.append((time.perf_counter() - t0) * 1e3)
        med = np.median(np.asarray(rows), axis=0)
        p50 = float(np.median(lat))
        busy = (med[1] + med[2] + med[3]) / p50
        log(f"failover route_batch breakdown (replicas_k={REPLICAS_K}, {KEYS} ids, one "
            f"replica marked, medians of 10): route_batch p50 {p50:.4f} ms max "
            f"{max(lat):.4f} ms; host hashing {med[0]:.4f} ms, host-to-device keys "
            f"{med[1]:.4f} ms, memento_replica kernel {med[2]:.4f} ms, device-to-host "
            f"[{KEYS}, {REPLICAS_K}] sets {med[3]:.4f} ms (events), host failover pick "
            f"{med[4]:.4f} ms; parts end to end {med[5]:.4f} ms; card busy at most "
            f"{busy:.2%} of route_batch (idle at least {1 - busy:.2%})")

    def breakdown(self, router) -> None:
        """Where a ``route_batch`` goes, on the one-shot state."""
        from repro_torch.core.hashing import np_key_to_u32
        from repro_torch.kernels.engine import key_tensor, memento_lookup

        np, torch = self.np, self.torch
        img = router.image_store().image()
        repl, n = img.arrays["repl"], img.n
        rows = []
        for _ in range(10):
            ids = self.rng.integers(0, 2**63, size=KEYS, dtype=np.uint64)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            keys = np_key_to_u32(ids)
            t1 = time.perf_counter()
            ev[0].record()
            kt = key_tensor(keys, self.dev)
            ev[1].record()
            out = memento_lookup(kt, repl, n)
            ev[2].record()
            host = out.cpu().numpy()
            ev[3].record()
            t2 = time.perf_counter()
            ev[3].synchronize()
            rows.append(((t1 - t0) * 1e3, ev[0].elapsed_time(ev[1]),
                         ev[1].elapsed_time(ev[2]), ev[2].elapsed_time(ev[3]),
                         (t2 - t0) * 1e3))
            del host
        lat = []
        ids = self.rng.integers(0, 2**63, size=KEYS, dtype=np.uint64)
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            router.route_batch(ids)
            lat.append((time.perf_counter() - t0) * 1e3)
        med = np.median(np.asarray(rows), axis=0)
        p50 = float(np.median(lat))
        busy = (med[1] + med[2] + med[3]) / p50
        log(f"route_batch breakdown (one-shot state, {KEYS} ids, medians of 10): "
            f"route_batch p50 {p50:.4f} ms; host hashing {med[0]:.4f} ms, "
            f"host-to-device keys {med[1]:.4f} ms, lookup kernel {med[2]:.4f} ms, "
            f"device-to-host buckets {med[3]:.4f} ms (events); parts end to end "
            f"{med[4]:.4f} ms; card busy at most {busy:.2%} of route_batch "
            f"(idle at least {1 - busy:.2%}), kernel {med[2] / p50:.2%}")

    # -- phase 6: this slice's path --------------------------------------------
    def phase_packed(self) -> list[dict]:
        """Packed and compact layouts: the path with the launch counts reset
        just before it, then every new kernel against its plain version on
        the card at every width, timed beside its bound."""
        from repro_torch.kernels import delta_apply, engine

        counters = [engine.LAUNCHES, delta_apply.LAUNCHES]
        for c in counters:
            for k in c:
                c[k] = 0
        t0 = time.perf_counter()
        main = self.packed_route()
        self.packed_main = main  # phase 7 reads its states
        self.packed_failover()
        self.packed_modes(main)
        sets = {"memento": [main["set"]], "anchor": []}
        for algo in ("memento", "anchor"):
            sets[algo] += [self.packed_small(algo), self.packed_tiny(algo)]
        launches = {k: v for c in counters for k, v in c.items()}
        log(f"phase 6 path: {time.perf_counter() - t0:.1f} s; launches {launches}")
        new = [n for n, (_, m, t) in engine.KERNELS.items()
               if t == "packed" or (t, m) == ("compact", "lookup")]
        for name in new + ["delta_apply_int16", "delta_apply_int8"]:
            if launches[name] <= 0:
                raise AssertionError(f"kernel {name} was not launched on the phase 6 path")
        t0 = time.perf_counter()
        rows = []
        for algo in ("memento", "anchor"):
            rows += self.check_packed_kernels(algo, sets[algo], launches)
        rows.append(self.check_compact(main, launches))
        rows += self.check_narrow_apply(sets, launches)
        log(f"phase 6 checks and timing: {time.perf_counter() - t0:.1f} s")
        return rows

    def packed_batches(self, router, dense, batches: int, what: str, lat: list) -> None:
        """``route_batch`` on 2^20 ids against the dense store on the same
        host state (the whole batch) and 4096 ids against the host."""
        from repro_torch.core.hashing import np_key_to_u32

        np, torch = self.np, self.torch
        for _ in range(batches):
            ids = self.rng.integers(0, 2**63, size=KEYS, dtype=np.uint64)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = router.route_batch(ids)
            lat.append((time.perf_counter() - t0) * 1e3)
            keys = np_key_to_u32(ids)
            want = dense.lookup(keys).cpu().numpy()
            if out.shape != (len(ids),) or out.dtype != np.int32 or not (out == want).all():
                raise AssertionError(f"packed {what}: route_batch != the dense store")
            idx = np.linspace(0, KEYS - 1, HOST_SAMPLE).astype(np.int64)
            if [router.ch.lookup(int(keys[j])) for j in idx] != out[idx].tolist():
                raise AssertionError(f"packed {what}: route_batch != host")

    def packed_breakdown(self, router, what: str, p50: float) -> None:
        """Where a packed ``route_batch`` goes (medians of a few)."""
        from repro_torch.core.hashing import np_key_to_u32
        from repro_torch.kernels.engine import image_operands, kernel_lookup, key_tensor

        np, torch = self.np, self.torch
        tables, scalars = image_operands(router.image_store().image())
        rows = []
        for _ in range(BREAKDOWN_REPS):
            ids = self.rng.integers(0, 2**63, size=KEYS, dtype=np.uint64)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            keys = np_key_to_u32(ids)
            t1 = time.perf_counter()
            ev[0].record()
            kt = key_tensor(keys, self.dev)
            ev[1].record()
            out = kernel_lookup("memento", kt, tables, scalars, table="packed")
            ev[2].record()
            out.cpu()
            ev[3].record()
            ev[3].synchronize()
            rows.append(((t1 - t0) * 1e3, ev[0].elapsed_time(ev[1]),
                         ev[1].elapsed_time(ev[2]), ev[2].elapsed_time(ev[3])))
        med = np.median(np.asarray(rows), axis=0)
        busy = (med[1] + med[2] + med[3]) / p50
        log(f"packed route_batch breakdown ({what}, {KEYS} ids, medians of "
            f"{BREAKDOWN_REPS}): p50 {p50:.4f} ms; host hashing {med[0]:.4f} ms, "
            f"host-to-device keys {med[1]:.4f} ms, memento_packed_lookup {med[2]:.4f} ms, "
            f"device-to-host buckets {med[3]:.4f} ms (events); card busy at most "
            f"{busy:.2%} (idle at least {1 - busy:.2%})")

    def packed_route(self) -> dict:
        """Memento at n = 10^6 with packed images through the router: stable,
        1024 removals, 128 single removals, 64 restores, one-shot 90 %."""
        from repro_torch.core.image_store import DeviceImageStore
        from repro_torch.core.packing import TOMBSTONE, image_table_bytes
        from repro_torch.serve.router import SessionRouter

        np, torch = self.np, self.torch
        router = SessionRouter(N, compact_images=True)
        t0 = time.perf_counter()
        store = router.image_store()
        torch.cuda.synchronize()
        log(f"packed store build (n={N}): {(time.perf_counter() - t0) * 1e3:.3f} ms, "
            f"tables {store.capacity}")
        dense = DeviceImageStore(router.ch)
        kept = {"stable": store.image()}

        def sync(what):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st = store.sync()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            dst = dense.sync()
            return (ms, st.mode, st.words, dst.words)

        def state(what, lat, syncs):
            p50 = float(np.median(lat))
            dbytes, pbytes = image_table_bytes(dense.image()), image_table_bytes(store.image())
            modes: dict = {}
            for _, m, _, _ in syncs:
                modes[m] = modes.get(m, 0) + 1
            sync_ms = [x[0] for x in syncs]
            log(f"scenario packed {what}: batches={len(lat)} of {KEYS} ids, keys/s="
                f"{KEYS * len(lat) / (sum(lat) / 1e3):.6g}, p50_lookup_ms={p50:.4f} "
                f"max_lookup_ms={max(lat):.4f}, syncs={len(syncs)} modes={modes}"
                + (f" p50_sync_ms={np.median(sync_ms):.4f} max_sync_ms={max(sync_ms):.4f}"
                   f" words packed/dense per sync (median) "
                   f"{np.median([x[2] for x in syncs]):.0f}/"
                   f"{np.median([x[3] for x in syncs]):.0f}" if syncs else "")
                + f"; table bytes dense {dbytes}, packed {pbytes} "
                f"({pbytes / dbytes:.4%}), removed {router.ch.n - router.ch.working}, "
                f"slots {store.capacity['slot_b']} x {store.image().arrays['slot_b'].dtype}; "
                f"every batch == the dense store, {HOST_SAMPLE} ids a batch == host")
            self.packed_breakdown(router, what, p50)

        lat: list = []
        self.packed_batches(router, dense, 10, "stable", lat)
        state("stable", lat, [])

        self.remove_random(router.ch, PACKED_REMOVALS)
        syncs = [sync("r1024")]
        keys = self.rng.integers(0, 2**32, size=KEYS, dtype=np.uint32)
        diff, want = store.migration_diff(keys), dense.migration_diff(keys)
        if not all(self.torch.equal(getattr(diff, f), getattr(want, f))
                   for f in ("old", "new", "moved")):
            raise AssertionError("packed migration_diff != the dense store's")
        log(f"packed migration_diff stable -> {PACKED_REMOVALS} removals: "
            f"{diff.num_moved} of {KEYS} keys moved == the dense store")
        lat = []
        self.packed_batches(router, dense, 10, f"{PACKED_REMOVALS} removals", lat)
        state(f"{PACKED_REMOVALS} removals", lat, syncs)
        kept["r1024"] = (dense.image().arrays["repl"], dense.image().n, router.ch.working)
        kept["lookups"] = [("stable", kept["stable"]),
                           (f"{PACKED_REMOVALS} removals", store.image())]

        lat, syncs = [], []
        for _ in range(INCREMENTAL_EVENTS):
            victim = self.working_victim(router.ch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            info = router.fail_replica(victim)
            torch.cuda.synchronize()
            cp = info["control_plane"]
            syncs.append(((time.perf_counter() - t0) * 1e3, cp["mode"], cp["words"],
                          dense.sync().words))
            if len(syncs) % BATCH_EVERY == 0:
                self.packed_batches(router, dense, 1, "incremental", lat)
        if any(m != "delta" for _, m, _, _ in syncs):
            raise AssertionError("a single removal did not ride a packed delta")
        diff, want = store.migration_diff(keys), dense.migration_diff(keys)
        if not self.torch.equal(diff.new, want.new) or not self.torch.equal(diff.moved, want.moved):
            raise AssertionError("packed migration_diff != the dense store's")
        state(f"incremental, {INCREMENTAL_EVENTS} removals", lat, syncs)

        lat, syncs = [], []
        for _ in range(PACKED_RESTORES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            router.restore_replica()
            torch.cuda.synchronize()
            st = store.last_sync
            syncs.append(((time.perf_counter() - t0) * 1e3, st.mode, st.words,
                          dense.sync().words))
            if len(syncs) % BATCH_EVERY == 0:
                self.packed_batches(router, dense, 1, "restores", lat)
        tombs = int((store._mirror["slot_b"] == TOMBSTONE).sum())
        if any(m != "delta" for _, m, _, _ in syncs) or not tombs:
            raise AssertionError("restores did not ride packed deltas leaving tombstones")
        log(f"packed restores: {tombs} tombstones in the slot table")
        state(f"{PACKED_RESTORES} restores", lat, syncs)

        t0 = time.perf_counter()
        self.remove_random(router.ch, int(ONESHOT_FRACTION * N) - (N - router.ch.working))
        log(f"host: one-shot removal, {router.ch.working} of {N} working, "
            f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
        syncs = [sync("oneshot")]
        if syncs[0][1] != "snapshot":
            raise AssertionError(f"one-shot packed sync was {syncs[0][1]}, expected snapshot")
        lat = []
        self.packed_batches(router, dense, 10, "oneshot", lat)
        state("one-shot 90 %", lat, syncs)
        kept["oneshot"] = store.image()
        kept["oneshot_dense"] = (dense.image().arrays["repl"], dense.image().n)
        kept["router"] = router
        width = str(kept["oneshot"].arrays["slot_b"].dtype).replace("torch.", "")
        kept["set"] = {"label": f"{width}, n={N} one-shot", "h": router.ch,
                       "old": kept["stable"], "new": kept["oneshot"],
                       "lookups": kept["lookups"]}
        return kept

    def packed_failover(self) -> None:
        """``route_batch`` with ``replicas_k = 3`` on a packed store over 10^6
        replicas: a replica marked, removed (a delta) and restored."""
        from repro_torch.serve.router import SessionRouter

        np, torch = self.np, self.torch
        router = SessionRouter(N, replicas_k=REPLICAS_K, compact_images=True)
        ids = self.rng.integers(0, 2**63, size=KEYS, dtype=np.uint64)
        lat: dict = {}

        def batch(what):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = router.route_batch(ids)
            lat.setdefault(what, []).append((time.perf_counter() - t0) * 1e3)
            return out

        base = batch("stable")
        victim = int(np.bincount(base).argmax())
        router.mark_failed(victim)
        hit = base == victim
        for _ in range(3):
            out = batch("marked")
            if victim in set(out.tolist()) or not (out == base)[~hit].all():
                raise AssertionError("packed failover routed to the marked replica or "
                                     "moved another session")
        sets = router.replica_set_batch(ids)
        if not ((sets[:, 0] == base).all() and (out[hit] == sets[hit, 1]).all()):
            raise AssertionError("packed failover did not take the next replica")
        info = router.fail_replica(victim)
        if info["control_plane"]["mode"] != "delta":
            raise AssertionError(f"packed removal synced as {info['control_plane']}")
        out = batch("removed")
        if victim in set(out.tolist()) or not (out == base)[~hit].all():
            raise AssertionError("packed removal moved more than the victim's sessions")
        router.restore_replica()
        if not (batch("restored") == base).all():
            raise AssertionError("the packed restore did not bring every session back")
        log(f"packed route_batch replicas_k={REPLICAS_K}: {KEYS} sessions over {N} replicas; "
            + "; ".join(f"{w} p50 {np.median(v):.4f} ms ({len(v)})" for w, v in lat.items())
            + f"; replica {victim} marked: {int(hit.sum())} sessions failed over, the rest "
            f"kept their primary; removal {info['control_plane']['words']} words (delta); "
            f"restore brought every session back")

    def packed_modes(self, main: dict) -> None:
        """Bounded assignment, the bounded k = 2 lookup, the k = 3 diff and a
        walk step on the packed one-shot state; the compact table through
        ``ops.memento_lookup``."""
        from repro_torch.kernels import engine, ops
        from repro_torch.sim.checkers import check_cap_invariant

        np, torch = self.np, self.torch
        h, stable, oneshot = main["router"].ch, main["stable"], main["oneshot"]
        assign = self.rng.integers(0, 2**32, size=KEYS, dtype=np.uint32)
        cap = int(np.ceil(CAP_C * KEYS / h.working))
        load0 = np.zeros(engine.bounded_load_len(oneshot), np.int32)
        before = engine.LAUNCHES["memento_packed_walk"]
        t0 = time.perf_counter()
        out, load = engine.bounded_assign(assign, oneshot, load0, cap)
        wall_ms = (time.perf_counter() - t0) * 1e3
        rounds = engine.LAUNCHES["memento_packed_walk"] - before
        found = check_cap_invariant(0, out, load, cap)
        if found or load.sum() != KEYS:
            raise AssertionError(f"packed bounded_assign: {found}")
        repl, n = main["oneshot_dense"]
        dense_img = type(oneshot)("memento", n, {"repl": repl}, epoch=oneshot.epoch)
        d_out, d_load = engine.bounded_assign(assign, dense_img, load0[:repl.numel()], cap)
        if not ((d_out == out).all() and (d_load == load[:repl.numel()]).all()):
            raise AssertionError("packed bounded_assign != the dense image's")
        load_t = torch.from_numpy(load).to(self.dev)
        keys_np, keys = self.keys()
        bounded = engine.engine_lookup(keys, oneshot, k=BOUNDED_K, load=load_t, cap=cap)
        diff = engine.engine_diff(keys, stable, oneshot, k=REPLICAS_K)
        pending = self.rng.random(KEYS) < 0.5
        walk = engine.engine_chain_walk(keys_np, np.zeros(KEYS, np.int32), pending, oneshot,
                                        load_t, cap)
        want = engine.engine_lookup(keys, dense_img, k=BOUNDED_K,
                                    load=load_t[:repl.numel()].contiguous(), cap=cap)
        if not torch.equal(bounded, want):
            raise AssertionError("packed bounded lookup != the dense image's")
        main["set"]["load"] = (load_t, cap)
        r1024, n1024, _ = main["r1024"]
        compact = {}
        for name, (rp, nn) in ((f"{PACKED_REMOVALS} removals", (r1024, n1024)),
                               ("one-shot", (repl, n))):
            got = ops.memento_lookup(keys, rp, nn, table="compact")
            if not torch.equal(got, engine.memento_lookup(keys, rp, nn)):
                raise AssertionError(f"compact lookup {name} != memento_lookup")
            compact[name] = got
        torch.cuda.synchronize()
        log(f"packed modes: bounded_assign of {KEYS} keys at c={CAP_C} (cap {cap}): "
            f"{rounds} rounds = memento_packed_walk launches, {wall_ms:.3f} ms, cap "
            f"invariant silent, == the dense image's; bounded k={BOUNDED_K} == dense; "
            f"k={REPLICAS_K} diff stable -> one-shot moved {diff.num_moved}; walk step on "
            f"{int(pending.sum())} pending lanes; ops.memento_lookup(table='compact') on "
            f"{sorted(compact)} == memento_lookup on the dense table")

    def packed_small(self, algo: str) -> dict:
        """A packed router whose tables narrow to int16 (Memento at
        n = 10^4, AnchorHash at a = 32000): removals and restores as
        deltas, a marked replica, diffs and a bounded assignment."""
        from repro_torch.core.image_store import DeviceImageStore
        from repro_torch.kernels import engine
        from repro_torch.serve.router import SessionRouter

        np, torch = self.np, self.torch
        t0 = time.perf_counter()
        if algo == "memento":
            router = SessionRouter(SMALL_N, compact_images=True, replicas_k=REPLICAS_K)
        else:
            router = SessionRouter(ANCHOR_W, algo="anchor", capacity=ANCHOR_A,
                                   compact_images=True, replicas_k=REPLICAS_K)
        store, h = router.image_store(), router.ch
        dense = DeviceImageStore(h)
        lat: list = []
        self.packed_batches(router, dense, 1, f"{algo} small", lat)
        first = store.image()
        removals, restores = SMALL_EVENTS
        for _ in range(removals):
            victim = int(self.rng.permutation(sorted(h.working_set()))[0])
            if router.fail_replica(victim)["control_plane"]["mode"] != "delta":
                raise AssertionError(f"packed {algo} removal was not a delta")
            dense.sync()
        for _ in range(restores):
            router.restore_replica()
            dense.sync()
        if store.last_sync.mode != "delta":
            raise AssertionError(f"packed {algo} restore was not a delta")
        self.packed_batches(router, dense, 1, f"{algo} small", lat)
        ids = self.rng.integers(0, 2**63, size=KEYS, dtype=np.uint64)
        base = router.route_batch(ids)
        victim = int(np.bincount(base).argmax())
        router.mark_failed(victim)
        out = router.route_batch(ids)
        if victim in set(out.tolist()):
            raise AssertionError(f"packed {algo} failover routed to the marked replica")
        keys_np, keys = self.keys()
        img = store.image()
        d1 = engine.engine_diff(keys, first, img)
        d3 = engine.engine_diff(keys, first, img, k=REPLICAS_K)
        cap = int(np.ceil(CAP_C * KEYS / h.working))
        load0 = np.zeros(engine.bounded_load_len(img), np.int32)
        _, load = engine.bounded_assign(keys_np, img, load0, cap)
        dtypes = sorted({str(t.dtype) for t in img.arrays.values()})
        log(f"packed {algo} small: {h.working} working of {h.size}, tables {dtypes}, "
            f"{removals} removals and {restores} restores as deltas, every batch == the "
            f"dense store, failover around replica {victim}; diff moved {d1.num_moved} "
            f"(k={REPLICAS_K}: {d3.num_moved}); bounded_assign cap {cap}; "
            f"{(time.perf_counter() - t0):.1f} s")
        width = str(img.arrays[engine.table_names(algo, "packed")[-1]].dtype)
        return {"label": f"{width.replace('torch.', '')}, {'n' if algo == 'memento' else 'a'}"
                         f"={img.n}",
                "h": h, "old": first, "new": img,
                "load": (torch.from_numpy(load).to(self.dev), cap)}

    def packed_tiny(self, algo: str) -> dict:
        """A hand-built int8 image (``pack_image`` pads every table to 128
        entries, so it never narrows to int8): a host removal as a packed
        delta through ``scatter_update``, then every mode."""
        from repro_torch.core.packing import host_arrays, pack_image, packed_delta_updates
        from repro_torch.core.protocol import DeviceImage, make_hash
        from repro_torch.kernels import engine
        from repro_torch.kernels.delta_apply import apply_updates

        np, torch = self.np, self.torch
        h = make_hash(algo, TINY_N, capacity=TINY_N, variant="32")
        for b in self.rng.permutation(TINY_N)[: TINY_N // 2].tolist():
            h.remove(int(b))
        img = pack_image(h.device_image())
        narrow = ("slot_b", "slot_c") if algo == "memento" else ("A", "K")
        old = DeviceImage(algo, img.n, {k: (v.to(torch.int8) if k in narrow else v).to(self.dev)
                                        for k, v in img.arrays.items()},
                          dict(img.scalars), img.epoch, packed=True)
        mirror = host_arrays(old)
        victim = sorted(h.working_set())[3]
        h.remove(victim)
        delta = h.device_delta(old.epoch)
        updates = packed_delta_updates(mirror, delta)
        new = DeviceImage(algo, delta.n, apply_updates(old.arrays, updates),
                          dict(delta.scalars), delta.epoch, packed=True)
        keys_np, keys = self.keys()
        out = engine.engine_lookup(keys, new)
        sample = np.arange(0, KEYS, KEYS // KERNEL_SAMPLE)
        if [h.lookup(int(k)) for k in keys_np[sample]] != out.cpu().numpy()[sample].tolist():
            raise AssertionError(f"int8 {algo} lookup after a packed delta != host")
        engine.engine_lookup(keys, new, k=REPLICAS_K)
        engine.engine_diff(keys, old, new)
        engine.engine_diff(keys, old, new, k=REPLICAS_K)
        cap = int(np.ceil(CAP_C * KEYS / h.working))
        load0 = np.zeros(engine.bounded_load_len(new), np.int32)
        _, load = engine.bounded_assign(keys_np, new, load0, cap)
        log(f"int8 {algo}: {h.working} working of {TINY_N}, a removal as a packed delta "
            f"({ {k: len(v[0]) for k, v in updates.items()} } words scattered), lookup "
            f"== host, k={REPLICAS_K}, diffs and bounded_assign (cap {cap}) on the card")
        return {"label": f"int8, {'n' if algo == 'memento' else 'a'}={new.n}", "h": h,
                "old": old, "new": new, "load": (torch.from_numpy(load).to(self.dev), cap),
                "updates": updates}

    def packed_entry(self, name: str, e: int, ms: float, plain_ms: float, ops: int,
                     nbytes: int, work: dict) -> dict:
        bound_ms, bound_by = self.bound(ops, nbytes)
        log(f"check {name}: keys={KEYS} kernel == plain (max abs err {e}); kernel "
            f"{ms:.6f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.6f} ms ({bound_by}: "
            f"{ops / KEYS:.2f} ops/key from "
            f"{ {k: round(v / KEYS, 3) for k, v in work.items()} } per key), "
            f"{bound_ms / ms:.1%} of the bound")
        return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "max_abs_err": e}

    def check_packed_replica(self, algo: str, label: str, keys, operands, load_cap,
                             rows: dict):
        """``{algo}_packed_replica`` at k = 3 and bounded k = 2 on one state
        against its plain version, timed beside its bound; for Memento also
        logs the table sectors a key of its reader (a model over the plain
        reader's counters) and the rate that gives at the kernel's time.
        Returns the k = 3 sets."""
        from repro_torch.kernels import engine

        tables, scalars = operands
        n, kw = scalars[0], {"table": "packed"}
        tb = sum(t.numel() * t.element_size() for t in tables)
        sets = None
        for k, load, cap in ((REPLICAS_K, None, None), (BOUNDED_K, *load_cap)):
            bounded = load is not None
            work: dict = {}
            got = engine.kernel_replica(algo, keys, k, tables, scalars, load, cap, **kw)
            want, plain_ms = self.timed_plain(lambda: engine.replica_plain(
                algo, keys, k, tables, scalars, load, cap, work, **kw))
            e = int((got.long() - want.long()).abs().max())
            if e:
                raise AssertionError(f"{algo}_packed_replica {label} k={k}"
                                     f"{' bounded' if bounded else ''}: kernel != plain ({e})")
            ms = self.time_ms(lambda: engine.kernel_replica(algo, keys, k, tables, scalars,
                                                            load, cap, **kw), reps=10, warmup=1)
            what = f"{label} {'bounded ' if bounded else ''}k={k}"
            entry = self.packed_entry(
                f"{algo}_packed_replica {what}{f' cap={cap}' if bounded else ''}", e, ms,
                plain_ms, self.mode_ops(algo, work, KEYS, n, k, bounded=bounded),
                4 * KEYS * (1 + k) + tb + (4 * load.numel() if bounded else 0), work)
            if algo == "memento":
                sec = replica_sectors(work, KEYS, bounded)
                log(f"  memento_packed_replica {what}: table sectors a key (model) {sec:.3f}, "
                    f"{sec * KEYS / (ms * 1e-3) / 1e9:.3f} G sectors/s at the kernel's time")
            else:
                log("  " + self.anchor_read_text(
                    f"anchor_packed_replica {what}",
                    anchor_words(work, KEYS, work.get("try", 0) if bounded else 0),
                    tb + (4 * load.numel() if bounded else 0), ms))
            rows[what] = entry
            sets = got if sets is None else sets
        return sets

    def packed_diverging_pair(self, st: dict):
        """Two packed images on the card, A and K of the width of ``st``'s
        newer image, whose removal stacks part after ``st``'s host state
        (:meth:`diverging_pair`): their operands."""
        from repro_torch.core.packing import pack_image
        from repro_torch.core.protocol import DeviceImage
        from repro_torch.kernels import engine

        dtype = st["new"].arrays["A"].dtype
        out = []
        for img in self.diverging_pair(st["h"]):
            p = pack_image(img)
            out.append(engine.image_operands(DeviceImage(
                p.algo, p.n, {k: (v.to(dtype) if k in ("A", "K") else v)
                              for k, v in p.arrays.items()},
                dict(p.scalars), p.epoch, packed=True)))
        return out

    def anchor_packed_diff_branches(self, k: int, keys, pairs, err) -> dict:
        """``anchor_packed_diff`` (k = 1) or ``anchor_packed_replica_diff`` (k =
        REPLICAS_K) on each of ``pairs`` ((state, old, new) operands: the
        path's epoch pair, which nests, then a pair whose stacks part): held
        against its plain version and timed, beside the branch its check took
        (read back from the call's own workspace, equal to the plain check's
        and to the check's alone) and the check's own time.  The bound counts
        the check (its buckets, ``OPS_PER_NEST_BUCKET`` each) and, where the
        epochs nest, one walk (the pair model's work:
        :func:`~repro_torch.kernels.engine.anchor_pair_diff_plain`, or
        ``anchor_pair_replica_diff_plain``); the bound with two walks is
        logged beside it.  Each pair's words a key, the check's words
        included, are logged as on the gather-rate line.  Returns the
        by-state entries."""
        from repro_torch.kernels import engine

        kw = {"table": "packed"}
        name = f"anchor_packed_{'diff' if k == 1 else 'replica_diff'}"
        wants = [engine.NEST_OLD_SHALLOW, engine.NEST_NONE]

        def call(old, new, with_nest=False):
            if k == 1:
                return engine.kernel_diff("anchor", keys, old, new, **kw, with_nest=with_nest)
            return engine.kernel_replica_diff("anchor", keys, k, old, new, **kw,
                                              with_nest=with_nest)

        def plain(old, new, work=None):
            if k == 1:
                return engine.diff_plain("anchor", keys, old, new, work, **kw)
            return engine.replica_diff_plain("anchor", keys, k, old, new, work, **kw)

        out = {}
        for (state, old, new), want in zip(pairs, wants):
            both: dict = {}
            got = call(old, new)
            p, plain_ms = self.timed_plain(lambda: plain(old, new, both))
            e = max(err(g, w) for g, w in zip(got, p))
            if e:
                raise AssertionError(f"{name} {state}: kernel != plain ({e})")
            ms = self.time_ms(lambda: call(old, new), reps=20 if k == 1 else 10,
                              warmup=3 if k == 1 else 1)
            branch = tuple(call(old, new, with_nest=True)[3].tolist())
            alone = tuple(engine.anchor_nest_check(old, new, **kw).tolist())
            if branch != engine.anchor_nest_plain(old, new) or branch != alone \
                    or branch[0] != want:
                raise AssertionError(f"{name} {state}: the check's verdict {branch} (alone "
                                     f"{alone}), the plain check's "
                                     f"{engine.anchor_nest_plain(old, new)}, want {want}")
            check_ms = self.time_ms(lambda: engine.anchor_nest_check(old, new, **kw), reps=20)
            a = old[1][0]
            tables = [t for e_ in (old, new) for t in e_[0]]
            table_bytes = sum(t.numel() * t.element_size() for t in tables)
            if a <= engine.NEST_BLOCK_MAX:  # the parted check: both As and both Ks in full
                check_words = 4 * a
            else:  # the grid: both As, both Ks where either epoch removed the bucket
                check_words = 2 * a + 2 * int(((old[0][0][:a] > 0) | (new[0][0][:a] > 0)).sum())
            check_ops = a * OPS_PER_NEST_BUCKET
            if k == 1:
                walks_ops = self.algo_ops("anchor", both, 2 * KEYS, a) + KEYS
                nbytes = 16 * KEYS + table_bytes
            else:
                walks_ops = (self.mode_ops("anchor", both, 2 * KEYS, a, k) + 2 * k * KEYS)
                nbytes = 4 * KEYS * (2 + 2 * k) + table_bytes
            work, ops = both, walks_ops
            if branch[0] != engine.NEST_NONE:
                work = {}
                if k == 1:
                    engine.anchor_pair_diff_plain(keys, old, new, work)
                    ops = self.algo_ops("anchor", work, KEYS, a) + KEYS
                else:
                    engine.anchor_pair_replica_diff_plain(keys, k, old, new, work)
                    ops = self.mode_ops("anchor", {**work, "compare": both.get("compare", 0)},
                                        KEYS, a, 2 * k) + 2 * k * KEYS
            walks_ms, walks_by = self.bound(walks_ops + check_ops, nbytes)
            label = state if k == 1 else f"{state} k={k}"
            entry = self.packed_entry(f"{name} {label}, moved {int(got[2].sum())}", e, ms,
                                      plain_ms, ops + check_ops, nbytes, work)
            words = anchor_words(work, KEYS if work is not both else 2 * KEYS) + check_words
            log(f"  {name} {label}: branch {branch[0]}, N_S = {branch[1]}; the check alone "
                f"{check_ms:.6f} ms ({check_words} words) of the call's {ms:.6f} ms; bound "
                f"with two walks counted {walks_ms:.6f} ms ({walks_by}); "
                + self.anchor_read_text(f"{name} {label}", words, table_bytes, ms))
            out[label] = {**entry, "branch": list(branch), "check_ms": check_ms,
                          "two_walks_bound_ms": walks_ms}
        return out

    def check_packed_kernels(self, algo: str, sets: list, launches: dict) -> list[dict]:
        """Every ``{algo}_packed_*`` kernel against its plain version on the
        card on each of ``sets`` (one table width each), 2048 keys of each
        lookup against the host; times and bounds."""
        from repro_torch.kernels import engine

        np, torch = self.np, self.torch
        kw = {"table": "packed"}
        by_mode: dict = {m: {} for m in ("lookup", "diff", "replica", "replica_diff", "walk")}

        def err(a, b):
            a, b = (torch.as_tensor(x).long() for x in (a, b))
            return int((a - b).abs().max()) if a.numel() else 0

        def nbytes(tables):
            return sum(t.numel() * t.element_size() for t in tables)

        for st in sets:
            label, h = st["label"], st["h"]
            keys_np, keys = self.keys()
            new, old = engine.image_operands(st["new"]), engine.image_operands(st["old"])
            tables, scalars = new
            tb, ob = nbytes(tables), nbytes(old[0])
            n = scalars[0]
            load_t, cap = st["load"]

            work: dict = {}
            out = engine.kernel_lookup(algo, keys, tables, scalars, **kw)
            plain, plain_ms = self.timed_plain(lambda: engine.lookup_plain(
                algo, keys, tables, scalars, work, **kw))
            e = err(out, plain)
            sample = np.arange(0, KEYS, KEYS // KERNEL_SAMPLE)
            if e or [h.lookup(int(k)) for k in keys_np[sample]] != out.cpu().numpy()[sample].tolist():
                raise AssertionError(f"{algo}_packed_lookup {label}: kernel != plain / host ({e})")
            ms = self.time_ms(lambda: engine.kernel_lookup(algo, keys, tables, scalars, **kw),
                              reps=30)
            ops = (self.lookup_ops(work, KEYS) if algo == "memento"
                   else self.algo_ops(algo, work, KEYS, n))
            by_mode["lookup"][label] = self.packed_entry(
                f"{algo}_packed_lookup {label}", e, ms, plain_ms, ops, 8 * KEYS + tb, work)
            if algo == "anchor":
                log("  " + self.anchor_read_text(f"anchor_packed_lookup {label}",
                                                 anchor_words(work, KEYS), tb, ms))
            for name, img in st.get("lookups", []):  # earlier states of the path
                t, sc = engine.image_operands(img)
                work = {}
                out = engine.kernel_lookup(algo, keys, t, sc, **kw)
                plain, p_ms = self.timed_plain(lambda: engine.lookup_plain(
                    algo, keys, t, sc, work, **kw))
                e = err(out, plain)
                if e:
                    raise AssertionError(f"{algo}_packed_lookup {name}: kernel != plain ({e})")
                ms = self.time_ms(lambda: engine.kernel_lookup(algo, keys, t, sc, **kw), reps=30)
                by_mode["lookup"][f"{label.split(',')[0]}, n={N} {name}"] = self.packed_entry(
                    f"{algo}_packed_lookup {name}", e, ms, p_ms, self.lookup_ops(work, KEYS),
                    8 * KEYS + nbytes(t), work)

            if algo == "anchor":  # both branches of each diff's check
                pairs = [(label, old, new), (f"{label} parted",
                                             *self.packed_diverging_pair(st))]
                for k, mode in ((1, "diff"), (REPLICAS_K, "replica_diff")):
                    by_mode[mode].update(self.anchor_packed_diff_branches(k, keys, pairs, err))
            else:
                both: dict = {}  # both epochs' lookups; their ops depend on no scalar
                got = engine.kernel_diff(algo, keys, old, new, **kw)
                want, plain_ms = self.timed_plain(lambda: engine.diff_plain(
                    algo, keys, old, new, both, **kw))
                e = max(err(g, w) for g, w in zip(got, want))
                if e:
                    raise AssertionError(f"{algo}_packed_diff {label}: kernel != plain ({e})")
                ms = self.time_ms(lambda: engine.kernel_diff(algo, keys, old, new, **kw), reps=20)
                ops = self.lookup_ops(both, 2 * KEYS) + KEYS - self.diff_shared_ops(
                    algo, both, old[1][0], n)
                by_mode["diff"][label] = self.packed_entry(
                    f"{algo}_packed_diff {label}, moved {int(got[2].sum())}", e, ms, plain_ms,
                    ops, 16 * KEYS + tb + ob, both)

            got = self.check_packed_replica(algo, label, keys, new, (load_t, cap),
                                            by_mode["replica"])
            if [h.lookup_k(int(k), REPLICAS_K) for k in keys_np[sample[:256]]] != \
                    got.cpu().numpy()[sample[:256]].tolist():
                raise AssertionError(f"{algo}_packed_replica {label}: kernel != host")
            if algo == "memento":  # the path's earlier states
                for name, img in st.get("lookups", []):  # the set's load covers their ids
                    width = str(img.arrays["slot_b"].dtype).replace("torch.", "")
                    self.check_packed_replica(algo, f"{width}, n={img.n} {name}", keys,
                                              engine.image_operands(img), (load_t, cap),
                                              by_mode["replica"])

            if algo == "memento":  # AnchorHash's: anchor_packed_diff_branches
                both = {}
                got = engine.kernel_replica_diff(algo, keys, REPLICAS_K, old, new, **kw)
                want, plain_ms = self.timed_plain(lambda: engine.replica_diff_plain(
                    algo, keys, REPLICAS_K, old, new, both, **kw))
                e = max(err(g, w) for g, w in zip(got, want))
                if e:
                    raise AssertionError(f"{algo}_packed_replica_diff {label}: kernel != plain")
                ms = self.time_ms(lambda: engine.kernel_replica_diff(
                    algo, keys, REPLICAS_K, old, new, **kw), reps=10, warmup=1)
                ops = (self.mode_ops(algo, both, 2 * KEYS, n, REPLICAS_K) + 2 * REPLICAS_K * KEYS
                       - self.pair_shared_ops(algo, keys, [both], old, new, "packed"))
                by_mode["replica_diff"][f"{label} k={REPLICAS_K}"] = self.packed_entry(
                    f"{algo}_packed_replica_diff {label} k={REPLICAS_K}, moved "
                    f"{int(got[2].sum())}", e, ms, plain_ms, ops,
                    4 * KEYS * (2 + 2 * REPLICAS_K) + tb + ob, both)

            chain = keys
            probe = torch.zeros(KEYS, dtype=torch.int32, device=self.dev)
            pending = torch.from_numpy(self.rng.random(KEYS) < 0.5).to(self.dev)
            work = {}
            got = engine.kernel_walk(algo, chain, probe, pending, tables, scalars, load_t, cap, **kw)
            want, plain_ms = self.timed_plain(lambda: engine.walk_plain(
                algo, chain, probe, pending, tables, scalars, load_t, cap, work, **kw))
            e = max(err(g, w) for g, w in zip(got, want))
            if e:
                raise AssertionError(f"{algo}_packed_walk {label}: kernel != plain ({e})")
            ms = self.time_ms(lambda: engine.kernel_walk(algo, chain, probe, pending, tables,
                                                         scalars, load_t, cap, **kw),
                              reps=10, warmup=1)
            by_mode["walk"][f"{label} cap={cap}"] = self.packed_entry(
                f"{algo}_packed_walk {label} ({int(pending.sum())} pending, "
                f"{work.get('walk', 0)} steps)", e, ms, plain_ms,
                self.mode_ops(algo, work, KEYS, n, walk=True),
                21 * KEYS + tb + 4 * load_t.numel(), work)
            if algo == "memento":
                self.log_walk_trips(label, chain, probe, pending, new, load_t, cap, work, ms)
            else:
                log("  " + self.anchor_read_text(
                    f"anchor_packed_walk {label} cap={cap}",
                    anchor_words(work, KEYS, int(pending.sum()) + work.get("walk", 0)),
                    tb + 4 * load_t.numel(), ms))
        rows = []
        for mode, by_state in by_mode.items():
            head = next(iter(by_state))
            h_ = by_state[head]
            rows.append({"name": f"{algo}_packed_{mode}", "route": "cuda",
                         "source": "src/repro_torch/kernels/csrc/engine.cu",
                         "replaces": "src/repro/kernels/engine.py:526",
                         "launches": launches[f"{algo}_packed_{mode}"],
                         "max_abs_err": max(v["max_abs_err"] for v in by_state.values()),
                         "ms": h_["ms"], "plain_ms": h_["plain_ms"],
                         "bound_ms": h_["bound_ms"], "bound_by": h_["bound_by"],
                         "library_ms": None, "state": head, "by_state": by_state})
        return rows

    @staticmethod
    def log_walk_trips(label, chain, probe, pending, operands, load, cap, work, ms) -> None:
        """Log a packed Memento walk step's round trips a lane (a model,
        :func:`walk_trips`, whose count must equal the plain walk's
        counters), the lane use that leaves over warps of 32, and the round
        trips a second the kernel's time implies."""
        (tables, scalars), keys = operands, chain.numel()
        trips = walk_trips(chain, probe, pending, tables, scalars[0], load, cap)
        counted = (sum(work.get(c, 0) for c in ("bit", "slot", "walk")) - work.get("start", 0)
                   + int(pending.sum()))
        if int(trips.sum()) != counted:
            raise AssertionError(f"memento_packed_walk {label}: round-trip model "
                                 f"{int(trips.sum())} != the plain walk's counters {counted}")
        log(f"  memento_packed_walk {label}: round trips a lane (model) "
            f"{trips.sum() / keys:.3f}; lane use {lane_use(trips):.4f} over warps of 32; "
            f"{trips.sum() / (ms * 1e-3) / 1e9:.3f} G round trips/s at the kernel's time")

    def check_compact(self, main: dict, launches: dict) -> dict:
        """``memento_compact_lookup`` on the 1024-removal and one-shot states
        against its plain version and ``memento_lookup`` on the dense
        table."""
        from repro_torch.kernels import engine

        torch = self.torch
        by_state = {}
        r1024, n1024, _ = main["r1024"]
        for name, (repl, n) in ((f"{PACKED_REMOVALS} removals", (r1024, n1024)),
                                ("one-shot", main["oneshot_dense"])):
            _, keys = self.keys()
            t0 = time.perf_counter()
            slot_b, slot_c = engine.build_compact_table(repl)
            build_ms = (time.perf_counter() - t0) * 1e3
            out = engine.compact_lookup(keys, slot_b, slot_c, n)
            work: dict = {}
            plain, plain_ms = self.timed_plain(lambda: engine.lookup_plain(
                "memento", keys, [slot_b, slot_c], [n], work, table="compact"))
            e = int((out.long() - plain.long()).abs().max())
            if e or not torch.equal(out, engine.memento_lookup(keys, repl, n)):
                raise AssertionError(f"memento_compact_lookup {name}: != plain / dense")
            ms = self.time_ms(lambda: engine.compact_lookup(keys, slot_b, slot_c, n), reps=30)
            dense_ms = self.time_ms(lambda: engine.memento_lookup(keys, repl, n), reps=30)
            by_state[name] = self.packed_entry(
                f"memento_compact_lookup {name} ({slot_b.numel()} slots, built on the host "
                f"in {build_ms:.1f} ms; memento_lookup on the dense table {dense_ms:.6f} ms, "
                f"equal)", e, ms, plain_ms, self.lookup_ops(work, KEYS),
                8 * KEYS + 8 * slot_b.numel(), work)
        head = by_state["one-shot"]
        return {"name": "memento_compact_lookup", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/engine.cu",
                "replaces": "src/repro/kernels/engine.py:526",
                "launches": launches["memento_compact_lookup"],
                "max_abs_err": max(v["max_abs_err"] for v in by_state.values()),
                "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
                "bound_by": head["bound_by"], "library_ms": None, "state": "one-shot",
                "by_state": by_state}

    def check_narrow_apply(self, sets: dict, launches: dict) -> list[dict]:
        """The int16 and int8 delta applies at the path's shapes (a small
        store's int16 slot table, an int8 image's table) against the plain
        version and ``index_put``."""
        from repro_torch.kernels.delta_apply import (KERNELS, _pad_updates, apply_form,
                                                     dedup_last, delta_apply,
                                                     delta_apply_plain)

        np, torch = self.np, self.torch
        rows = []
        floor_ms = self.launch_floor_ms()
        log(f"launch floor: one add_ of a one-element int32 tensor {floor_ms:.6f} ms (CUDA "
            f"events over 100 launches behind a GPU sleep, as the kernels are timed): a "
            f"yardstick for the K2 rows below, not a bound")
        for dtype, st in ((torch.int16, sets["memento"][1]), (torch.int8, sets["memento"][2])):
            name = KERNELS[dtype]
            table = st["new"].arrays["slot_b"]
            if table.dtype != dtype:
                raise AssertionError(f"{name}: the path's slot table is {table.dtype}")
            idx = self.rng.integers(0, table.numel(), size=8)
            vals = self.rng.integers(-2, TINY_N, size=8).astype(np.int32)
            uidx, uvals = dedup_last(idx, vals)
            pidx, pval, count = _pad_updates(uidx, uvals, sentinel=-1)
            meta = torch.from_numpy(np.concatenate([pidx, pval])).to(self.dev)
            out = delta_apply(table, meta, count)
            plain = delta_apply_plain(table, meta, count)
            ti = torch.from_numpy(uidx).to(self.dev)
            tv = torch.from_numpy(uvals).to(dtype).to(self.dev)
            lib = table.index_put((ti,), tv)
            e = int((out.long() - plain.long()).abs().max())
            if e or not torch.equal(out, lib):
                raise AssertionError(f"{name}: kernel != plain / index_put")
            ms = self.time_ms(lambda: delta_apply(table, meta, count), reps=100)
            plain_ms = self.time_ms(lambda: delta_apply_plain(table, meta, count), reps=100)
            library_ms = self.time_ms(lambda: table.index_put((ti,), tv), reps=100)
            nbytes = 2 * table.numel() * table.element_size() + 8 * count
            bound_ms, bound_by = self.bound(0, nbytes)
            form = apply_form(table.numel(), dtype)
            log(f"check {name}: {count} updates into {table.numel()} {dtype} ({st['label']}): "
                f"kernel == plain == index_put; form {form}; kernel {ms:.6f} ms, plain "
                f"{plain_ms:.6f} ms, index_put {library_ms:.6f} ms, bound {bound_ms:.9f} ms "
                f"(bytes: {nbytes}{self.form_bytes_text(form, count, table.element_size())}), "
                f"{bound_ms / ms:.4%} of the bound; launch floor {floor_ms:.6f} ms "
                f"({ms / floor_ms:.2f} x)")
            rows.append({"name": name, "route": "cuda",
                         "source": "src/repro_torch/kernels/csrc/delta_apply.cu",
                         "replaces": "src/repro/kernels/delta_apply.py:169",
                         "launches": launches[name], "max_abs_err": e, "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                         "library_ms": library_ms, "state": st["label"], "form": form,
                         "launch_floor_ms": floor_ms})
        return rows

    # -- phase 7: this slice's path --------------------------------------------
    def phase_compact_replicas(self) -> list[dict]:
        """Compact tables at k > 1 and bounded, and a diff across two
        algorithms, on phase 6's one-shot state: the path with the launch
        counts reset just before it, then each result against its plain
        version, the dense sets of the same host state and the host."""
        from repro_torch.core.protocol import DeviceImage
        from repro_torch.kernels import delta_apply, engine

        np, torch = self.np, self.torch
        main = self.packed_main
        h = main["router"].ch
        repl, n = main["oneshot_dense"]
        img = DeviceImage("memento", n, {"repl": repl}, epoch=main["oneshot"].epoch)
        load_t, cap = main["set"]["load"]
        h_a, _, anchor_oneshot = self.kept["anchor"]
        keys_np, keys = self.keys()
        counters = [engine.LAUNCHES, delta_apply.LAUNCHES]
        for c in counters:
            for k in c:
                c[k] = 0
        t0 = time.perf_counter()
        sets = engine.engine_lookup(keys, img, k=REPLICAS_K, table="compact")
        bounded = engine.engine_lookup(keys, img, k=BOUNDED_K, load=load_t, cap=cap,
                                       table="compact")
        cross = {k: engine.engine_diff(keys, anchor_oneshot, main["oneshot"], k=k)
                 for k in (1, REPLICAS_K)}
        torch.cuda.synchronize()
        launches = {k: v for c in counters for k, v in c.items()}
        log(f"phase 7 path: {time.perf_counter() - t0:.1f} s; launches {launches}")
        for name in ("memento_compact_replica", "anchor_lookup", "anchor_replica",
                     "memento_packed_lookup", "memento_packed_replica"):
            if launches[name] <= 0:
                raise AssertionError(f"kernel {name} was not launched on the phase 7 path")

        t0 = time.perf_counter()
        sample = np.arange(0, KEYS, KEYS // KERNEL_SAMPLE)
        compact = list(engine.build_compact_table(repl))
        by_state = {}
        for what, k, ld, got, bounded_ in (
                (f"one-shot k={REPLICAS_K}", REPLICAS_K, None, sets, False),
                (f"one-shot bounded k={BOUNDED_K} c={CAP_C}", BOUNDED_K, load_t, bounded, True)):
            c = None if ld is None else cap
            work: dict = {}
            plain, plain_ms = self.timed_plain(lambda: engine.replica_plain(
                "memento", keys, k, compact, [n], ld, c, work, table="compact"))
            e = int((got.long() - plain.long()).abs().max())
            dense = engine.kernel_replica("memento", keys, k, [repl], [n], ld, c)
            if e or not torch.equal(got, dense):
                raise AssertionError(f"memento_compact_replica {what}: kernel != plain / dense")
            if ld is None:
                host = [h.lookup_k(int(x), k) for x in keys_np[sample[:512]]]
            else:
                host = engine.bounded_replica_sets(h, keys_np[sample[:512]], k,
                                                   ld.cpu().numpy(), cap).tolist()
            if host != got[sample[:512]].tolist():
                raise AssertionError(f"memento_compact_replica {what}: kernel != host")
            ms = self.time_ms(lambda: engine.kernel_replica(
                "memento", keys, k, compact, [n], ld, c, table="compact"), reps=10, warmup=1)
            dense_ms = self.time_ms(lambda: engine.kernel_replica(
                "memento", keys, k, [repl], [n], ld, c), reps=10, warmup=1)
            nbytes = 4 * KEYS * (1 + k) + 8 * compact[0].numel() + (
                4 * ld.numel() if bounded_ else 0)
            by_state[what] = self.packed_entry(
                f"memento_compact_replica {what} ({compact[0].numel()} slots; "
                f"memento_replica on the dense table {dense_ms:.6f} ms, equal, == host "
                f"on 512 keys)", e, ms, plain_ms,
                self.mode_ops("memento", work, KEYS, n, k, bounded=bounded_), nbytes, work)
        tables_a, scalars_a = engine.image_operands(anchor_oneshot)
        tables_m, scalars_m = engine.image_operands(main["oneshot"])
        old = engine.lookup_plain("anchor", keys, tables_a, scalars_a)
        new = engine.lookup_plain("memento", keys, tables_m, scalars_m, table="packed")
        d = cross[1]
        if not (torch.equal(d.old, old) and torch.equal(d.new, new)
                and torch.equal(d.moved, old != new)):
            raise AssertionError("cross-algorithm engine_diff != the two plain lookups")
        d3 = cross[REPLICAS_K]
        if not (torch.equal(d3.old[:, 0], old) and torch.equal(d3.new[:, 0], new)
                and torch.equal(d3.moved, (d3.old != d3.new).any(dim=1))):
            raise AssertionError(f"cross-algorithm k={REPLICAS_K} engine_diff is inconsistent")
        want = [(h_a.lookup(int(x)), h.lookup(int(x))) for x in keys_np[sample]]
        if want != list(zip(d.old[sample].tolist(), d.new[sample].tolist())):
            raise AssertionError("cross-algorithm engine_diff != host")
        log(f"cross-algorithm engine_diff anchor (a={h_a.size}, {h_a.working} working) -> "
            f"packed memento ({h.working} of {h.n}): k=1 moved {d.num_moved} of {KEYS}, == the "
            f"plain lookups and {KERNEL_SAMPLE} keys == host; k={REPLICAS_K} moved "
            f"{d3.num_moved}, column 0 == k=1")
        log(f"phase 7 checks and timing: {time.perf_counter() - t0:.1f} s")
        head = by_state[f"one-shot k={REPLICAS_K}"]
        return [{"name": "memento_compact_replica", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/engine.cu",
                 "replaces": "src/repro/kernels/engine.py:526",
                 "launches": launches["memento_compact_replica"],
                 "max_abs_err": max(v["max_abs_err"] for v in by_state.values()),
                 "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
                 "bound_by": head["bound_by"], "library_ms": None,
                 "state": f"one-shot k={REPLICAS_K}", "by_state": by_state}]

    def lookup_cold_times(self, kernels: list[dict]) -> None:
        """``memento_lookup`` (phase 2's stable and one-shot states) and
        ``memento_packed_lookup`` (phase 6's, int32 slots) timed warm and
        cold (the L2 flushed before each launch).  The cold one-shot time
        joins the kernel's row."""
        from repro_torch.kernels import engine

        _, stable, oneshot = self.kept["memento"]
        main = self.packed_main
        states = {"memento_lookup": (stable, oneshot, {}),
                  "memento_packed_lookup": (main["stable"], main["oneshot"], {"table": "packed"})}
        rows = {k["name"]: k for k in kernels}
        _, keys = self.keys()
        for name, (st, one, kw) in states.items():
            times = {}
            for state, im in (("stable", st), ("one-shot", one)):
                tables, scalars = engine.image_operands(im)
                run = (lambda: engine.kernel_lookup("memento", keys, tables, scalars, **kw))
                times[state] = (self.time_ms(run, reps=30), self.time_cold_ms(run))
            log(f"{name} (one thread a key; {KEYS} keys, n={N}), warm / cold ms: " + "; ".join(
                f"{state} {w:.6f} / {c:.6f}" for state, (w, c) in times.items()))
            rows[name]["cold_ms"] = times["one-shot"][1]

    # -- phases 8 and 9: the substrates and the sharded streaming plane ----------
    def launch_counts(self):
        """``(reset, snapshot, uncounted)`` over the engine's and the delta
        apply's launch counters: ``uncounted(fn)`` runs a check and puts
        the counters back, so its launches stay off the path's counts."""
        from repro_torch.kernels import delta_apply, engine

        counters = [engine.LAUNCHES, delta_apply.LAUNCHES]

        def reset():
            for c in counters:
                for k in c:
                    c[k] = 0

        def snapshot():
            return {k: v for c in counters for k, v in c.items()}

        def uncounted(fn):
            before = [dict(c) for c in counters]
            try:
                return fn()
            finally:
                for c, b in zip(counters, before):
                    c.update(b)

        return reset, snapshot, uncounted

    def phase_substrates(self) -> None:
        """Phase 8: the elastic cluster for every algorithm at 2^20 shards on
        10^4 hosts, the checkpoint store, and the data pipeline."""
        from repro_torch.core.protocol import ALGORITHMS, ALGORITHM_REGISTRY

        t_phase = time.perf_counter()
        reset, snapshot, uncounted = self.launch_counts()
        reset()
        for algo in ALGORITHMS:
            self.cluster_run(algo, uncounted)
        launches = snapshot()
        log(f"phase 8 cluster launches: {launches}")
        for name in ([f"{a}_{m}" for a in ALGORITHMS for m in ("diff", "replica_diff")]
                     + ["delta_apply"]):
            if launches[name] <= 0:
                raise AssertionError(f"kernel {name} was not launched on the cluster path")
        cluster_s = time.perf_counter() - t_phase
        self.checkpoint_run()
        self.pipeline_run()
        log(f"phase 8 wall: {time.perf_counter() - t_phase:.1f} s (cluster {cluster_s:.1f} s)")

    def cluster_run(self, algo: str, uncounted) -> None:
        from repro_torch.core.protocol import ALGORITHM_REGISTRY
        from repro_torch.runtime import ElasticCluster

        np, torch = self.np, self.torch
        info = ALGORITHM_REGISTRY[algo]
        cap = CAPACITY_FACTOR * CLUSTER_HOSTS if info.fixed_capacity else None
        rng = np.random.default_rng([SEED, 8])
        t0 = time.perf_counter()
        c = ElasticCluster(CLUSTER_HOSTS, num_shards=CLUSTER_SHARDS, algo=algo,
                           capacity=cap, replica_k=CLUSTER_K)
        store = c.placement.image_store()
        torch.cuda.synchronize()
        build_ms = (time.perf_counter() - t0) * 1e3
        h = c.placement.ch
        plan_ms, movement_ms, moved, replica_moved = [], [], [], []
        for i in range(CLUSTER_FAILS + CLUSTER_JOINS):
            joining = i >= CLUSTER_FAILS
            if not joining:
                if info.lifo_only:
                    host = h.size - 1
                else:
                    ws = sorted(h.working_set())
                    host = ws[int(rng.integers(len(ws)))]
            t0 = time.perf_counter()
            plan = c.join() if joining else c.fail(host)
            t1 = time.perf_counter()
            mv = c.replica_movement()
            plan_ms.append((t1 - t0) * 1e3)
            movement_ms.append((time.perf_counter() - t1) * 1e3)
            if not (plan["monotone"] if joining else plan["minimal"]):
                raise AssertionError(f"{algo} event {i}: plan not "
                                     f"{'monotone' if joining else 'minimal'}")
            host = plan["host"] if joining else host
            for s, b in plan["moved"].items():
                if h.lookup(s) != b or (joining and b != host):
                    raise AssertionError(f"{algo} event {i}: shard {s} moved to {b}, "
                                         f"host lookup {h.lookup(s)}")
            for s, sets in mv.items():
                if h.lookup_k(s, CLUSTER_K) != sets["new"]:
                    raise AssertionError(f"{algo} event {i}: shard {s} replica set "
                                         f"{sets['new']} != host lookup_k")
            moved.append(len(plan["moved"]))
            replica_moved.append(len(mv))
            if i in (0, CLUSTER_FAILS):  # the first failure and the first join
                uncounted(lambda: self.check_cluster_diffs(algo, store))
            if i in (CLUSTER_FAILS - 1, CLUSTER_FAILS + CLUSTER_JOINS - 1):
                uncounted(lambda: self.check_cluster_sample(algo, h, store))
        log(f"phase 8 cluster {algo}: {CLUSTER_HOSTS} hosts, {CLUSTER_SHARDS} shards, "
            f"k={CLUSTER_K}, store build {build_ms:.3f} ms; {CLUSTER_FAILS} failures then "
            f"{CLUSTER_JOINS} joins, every plan minimal / monotone and every moved shard "
            f"== host; shards moved a failure mean {np.mean(moved[:CLUSTER_FAILS]):.2f}, "
            f"a join {np.mean(moved[CLUSTER_FAILS:]):.2f}; replica sets changed a failure "
            f"{np.mean(replica_moved[:CLUSTER_FAILS]):.2f}, a join "
            f"{np.mean(replica_moved[CLUSTER_FAILS:]):.2f}; plan ms p50 "
            f"{np.median(plan_ms):.4f} max {max(plan_ms):.4f}; replica_movement ms p50 "
            f"{np.median(movement_ms):.4f} max {max(movement_ms):.4f}; movement_total "
            f"{c.movement_total()}; working {h.working}")

    def check_cluster_diffs(self, algo: str, store) -> None:
        """The store's two retained epochs diffed over every shard, k = 1 and
        k = 3, by the kernels and by their plain versions on the card."""
        from repro_torch.kernels import engine

        torch = self.torch
        keys = engine.key_tensor(self.np.arange(CLUSTER_SHARDS, dtype=self.np.uint32), self.dev)
        prev, front = store.previous_image(), store.image()
        old, new = engine.image_operands(prev), engine.image_operands(front)
        for k in (1, CLUSTER_K):
            got = engine.engine_diff(keys, prev, front, k=k)
            want = (engine.diff_plain(algo, keys, old, new) if k == 1
                    else engine.replica_diff_plain(algo, keys, k, old, new))
            if not all(torch.equal(g, w) for g, w in
                       zip((got.old, got.new, got.moved), want)):
                raise AssertionError(f"phase 8 {algo} k={k}: diff kernel != plain")

    def check_cluster_sample(self, algo: str, h, store) -> None:
        """4096 shards of the front epoch on the card == the host."""
        np = self.np
        sample = np.linspace(0, CLUSTER_SHARDS - 1, HOST_SAMPLE).astype(np.uint32)
        one = store.lookup(sample).cpu().numpy()
        sets = store.lookup(sample, k=CLUSTER_K).cpu().numpy()
        for j, s in enumerate(sample.tolist()):
            if one[j] != h.lookup(s) or sets[j].tolist() != h.lookup_k(s, CLUSTER_K):
                raise AssertionError(f"phase 8 {algo}: shard {s} on the card != host")

    def checkpoint_run(self) -> None:
        """AsyncCheckpointer(keep=2): three steps of a 64-tensor state on the
        card, restored bit-equal, placed as the host MementoHash places
        each leaf's path."""
        import tempfile

        from repro_torch.ckpt import AsyncCheckpointer, latest_step, restore_checkpoint
        from repro_torch.core.hashing import key_to_u64
        from repro_torch.core.memento import MementoHash

        np, torch = self.np, self.torch
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(SEED)
        per_leaf = CKPT_BYTES // CKPT_LEAVES // 4
        state = {}
        for i in range(CKPT_LEAVES):
            group = "params" if i % 2 == 0 else "counts"
            if group == "params":
                t = torch.randn(per_leaf, generator=gen, device=self.dev)
            else:
                t = torch.randint(-2**31, 2**31 - 1, (per_leaf,), generator=gen,
                                  device=self.dev, dtype=torch.int32)
            state.setdefault(group, {})[f"t{i:02d}"] = t.reshape(-1, 1024)
        nbytes = sum(t.numel() * t.element_size() for g in state.values() for t in g.values())
        saved, d2h_ms, write_ms = {}, [], []
        with tempfile.TemporaryDirectory() as tmp:
            ck = AsyncCheckpointer(tmp, keep=2)
            for step in range(1, CKPT_STEPS + 1):
                for g in state.values():
                    for t in g.values():
                        t.add_(1)  # each step its own state
                torch.cuda.synchronize()
                saved[step] = {g: {n: t.cpu().numpy().copy() for n, t in ts.items()}
                               for g, ts in state.items()}
                t0 = time.perf_counter()
                ck.save(state, step)  # device->host on this thread, then the writer
                t1 = time.perf_counter()
                ck.wait()
                d2h_ms.append((t1 - t0) * 1e3)
                write_ms.append((time.perf_counter() - t1) * 1e3)
            steps = sorted(int(p.split("_")[1]) for p in os.listdir(tmp))
            if steps != list(range(CKPT_STEPS - 1, CKPT_STEPS + 1)) or latest_step(tmp) != CKPT_STEPS:
                raise AssertionError(f"checkpoint gc kept steps {steps}")
            m = MementoHash(ck.num_buckets)
            for step in steps:
                got, manifest = restore_checkpoint(tmp, step)
                for g, ts in saved[step].items():
                    for n, a in ts.items():
                        b = got[g][n]
                        if b.dtype != a.dtype or b.shape != a.shape or b.tobytes() != a.tobytes():
                            raise AssertionError(f"step {step} {g}/{n} not restored bit-equal")
                for path, info in manifest["shards"].items():
                    if info["bucket"] != m.lookup(key_to_u64(path)):
                        raise AssertionError(f"manifest bucket of {path} != host MementoHash")
        log(f"phase 8 checkpoint: {CKPT_LEAVES} tensors, {nbytes} bytes (float32, int32), "
            f"{CKPT_STEPS} steps kept 2, restored bit-equal, buckets == host MementoHash; "
            f"device->host ms {', '.join(f'{x:.3f}' for x in d2h_ms)}; write ms "
            f"{', '.join(f'{x:.3f}' for x in write_ms)}")

    def pipeline_run(self) -> None:
        """A DataPipeline over a 4096-shard, 64-host placement on the card:
        batches, a resume, a host failure, the streams after it."""
        from repro_torch.data import DataPipeline, ShardPlacement

        np = self.np
        t0 = time.perf_counter()
        p = ShardPlacement(PIPE_SHARDS, PIPE_HOSTS)
        kw = dict(host=1, batch=4, seq_len=128, vocab_size=50257, shard_tokens=1 << 12)
        pipe = DataPipeline(p, **kw)
        first = [pipe.next_batch() for _ in range(2)]
        st = pipe.state()
        again = DataPipeline(p, **kw)
        again.load_state(st)
        for b in first:
            if not (b["tokens"].max() < kw["vocab_size"]
                    and np.array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])):
                raise AssertionError("pipeline batch is not a shifted token stream")
        owned = set(p.shards_for_host(1))
        plan = p.fail_host(7)
        gained = set(p.shards_for_host(1)) - owned
        if not plan["minimal"] or not owned <= set(p.shards_for_host(1)) or \
                gained != {s for s, b in plan["moved"].items() if b == 1}:
            raise AssertionError("pipeline host lost shards or gained others than the plan's")
        for _ in range(2):
            a, b = pipe.next_batch(), again.next_batch()
            if not np.array_equal(a["tokens"], b["tokens"]):
                raise AssertionError("resumed pipeline diverged after the failure")
        log(f"phase 8 pipeline: {PIPE_SHARDS} shards on {PIPE_HOSTS} hosts, host 1 owned "
            f"{len(owned)}, gained {len(gained)} of host 7's {len(plan['moved'])}; batches, "
            f"resume and the streams after the failure equal; "
            f"{(time.perf_counter() - t0) * 1e3:.1f} ms")

    def phase_stream(self) -> None:
        """Phase 9: route_stream of 2^20-id batches at n = 10^6 on every GPU
        and on two entries of one card, in both sync modes, through a
        failure and a restore; failover at k = 3; the packed layout; and
        sharded replays against phases 4 and 4b."""
        from repro_torch.core.protocol import ALGORITHMS

        t_phase = time.perf_counter()
        reset, snapshot, uncounted = self.launch_counts()
        self.uncounted = uncounted  # the comparands' route_batch calls
        reset()
        rng = self.np.random.default_rng([SEED, 9])
        batches = [rng.integers(0, 2**63, size=KEYS, dtype=self.np.uint64)
                   for _ in range(STREAM_BATCHES)]
        for devices in (None, [self.dev, self.dev]):
            for mode in ("block", "overlap"):
                self.stream_checked(batches, devices, mode)
        self.stream_failover(batches[:STREAM_SIDE_BATCHES])
        self.stream_packed(batches[:STREAM_SIDE_BATCHES])
        self.sharded_replays()
        launches = snapshot()
        log(f"phase 9 launches: {launches}")
        for name in (["memento_replica", "memento_packed_lookup", "delta_apply"]
                     + [f"{a}_lookup" for a in ALGORITHMS]):
            if launches[name] <= 0:
                raise AssertionError(f"kernel {name} was not launched on the stream path")
        uncounted(lambda: self.stream_rates(batches))
        log(f"phase 9 wall: {time.perf_counter() - t_phase:.1f} s")

    def stream_checked(self, batches, devices, mode: str) -> None:
        """Each streamed batch == route_batch of its ids at the epoch it was
        served at, taken before the batch is fed (after the event's device
        work is done, so the next poll point lands an overlapped flip)."""
        from repro_torch.serve.router import SessionRouter

        np, torch = self.np, self.torch
        t0 = time.perf_counter()
        r = SessionRouter(N, sync_mode=mode)
        r.image_store()
        want, victims = [], []

        def feed():
            for i, ids in enumerate(batches):
                if i == STREAM_FAIL_AT:
                    victims.append(self.working_victim(r.ch))
                    r.fail_replica(victims[0])
                if i == STREAM_RESTORE_AT:
                    if r.restore_replica() != victims[0]:
                        raise AssertionError("restore did not bring back the failed replica")
                torch.cuda.synchronize()
                want.append(self.uncounted(lambda: r.route_batch(ids)))
                yield ids

        plane = r.sharded_plane(devices=devices)
        for i, out in enumerate(r.route_stream(feed(), devices=devices)):
            if not np.array_equal(out, want[i]):
                raise AssertionError(f"route_stream batch {i} ({mode}, {devices}) != route_batch")
            if STREAM_FAIL_AT <= i < STREAM_RESTORE_AT and (out == victims[0]).any():
                raise AssertionError(f"batch {i} routed to the failed replica")
        if r.image_store().epoch != r.ch.epoch or plane.repins < 3:
            raise AssertionError("the stream missed an epoch flip")
        log(f"phase 9 route_stream {mode}, devices "
            f"{[str(d) for d in plane.devices]}: {STREAM_BATCHES} batches of {KEYS} ids, "
            f"replica {victims[0]} failed before batch {STREAM_FAIL_AT} and restored before "
            f"{STREAM_RESTORE_AT}, every batch == route_batch, repins {plane.repins}, "
            f"copies {plane.copies}; {time.perf_counter() - t0:.1f} s")

    def stream_failover(self, batches) -> None:
        from repro_torch.serve.router import SessionRouter

        np = self.np
        r = SessionRouter(N, replicas_k=REPLICAS_K)
        victim = int(np.bincount(self.uncounted(lambda: r.route_batch(batches[0]))).argmax())
        r.mark_failed(victim)
        want = []

        def feed():
            for ids in batches:
                want.append(self.uncounted(lambda: r.route_batch(ids)))
                yield ids

        for i, out in enumerate(r.route_stream(feed(), devices=[self.dev, self.dev])):
            if not np.array_equal(out, want[i]) or (out == victim).any():
                raise AssertionError(f"failover stream batch {i} != route_batch or on {victim}")
        log(f"phase 9 failover: replicas_k={REPLICAS_K}, replica {victim} marked, "
            f"{len(batches)} streamed batches == route_batch, none on it, failovers "
            f"{r.stats.failovers}")

    def stream_packed(self, batches) -> None:
        from repro_torch.serve.router import SessionRouter

        np = self.np
        r = SessionRouter(N, compact_images=True)
        r.image_store()
        want = []

        def feed():
            for i, ids in enumerate(batches):
                if i == 1:
                    r.fail_replica(self.working_victim(r.ch))
                want.append(self.uncounted(lambda: r.route_batch(ids)))
                yield ids

        for i, out in enumerate(r.route_stream(feed(), devices=[self.dev, self.dev])):
            if not np.array_equal(out, want[i]):
                raise AssertionError(f"packed stream batch {i} != route_batch")
        log(f"phase 9 packed: compact_images=True, {len(batches)} streamed batches through "
            f"a removal == route_batch, the image packed: {r.image_store().image().packed}")

    def sharded_replays(self) -> None:
        """Every scenario x every algorithm at its default size sharded, ==
        phase 4b's unsharded card fingerprint; Memento one-shot at w = 10^6
        with 2^20-key batches sharded, == phase 4's."""
        from repro_torch.core.protocol import ALGORITHMS
        from repro_torch.sim import SCENARIOS, make_trace, replay

        t0 = time.perf_counter()
        for scenario in SCENARIOS:
            for algo in ALGORITHMS:
                res = replay(make_trace(scenario, SEED), algo=algo, sharded=True)
                want = self.fingerprints[(scenario, algo, "default")]
                if not res.ok or res.fingerprint != want:
                    raise AssertionError(f"sharded replay {scenario} {algo}: "
                                         f"{res.fingerprint} != {want}, {res.violations[:2]}")
        default_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = replay(make_trace("oneshot", SEED, w=N, n_keys=KEYS), algo="memento",
                     probe_keys=KEYS, sharded=True)
        want = self.fingerprints[("oneshot", "memento", "full")]
        if not res.ok or res.fingerprint != want:
            raise AssertionError(f"sharded one-shot replay at w={N}: {res.fingerprint} != {want}")
        log(f"phase 9 sharded replays: {len(SCENARIOS) * len(ALGORITHMS)} at default size == "
            f"phase 4b's fingerprints ({default_s:.1f} s); memento one-shot w={N}, {KEYS} keys "
            f"== phase 4's {want} ({time.perf_counter() - t0:.1f} s)")

    def stream_rates(self, batches) -> None:
        """Keys/s of route_stream (block mode, no events) on each device
        list beside a loop of route_batch on the same batches, and the
        card's lookup busy share during the stream: the union of the
        plane's per-chunk lookup intervals (CUDA events) over the stream's
        span.  An interval opens when the chunk's stream reaches its start
        event, which an idle stream does before the host has issued the
        kernel, so the share is an upper bound.  A record: one card cannot
        show fan-out."""
        from repro_torch.serve.router import SessionRouter

        np, torch = self.np, self.torch
        keys = len(batches) * KEYS
        for devices in (None, [self.dev, self.dev]):
            r = SessionRouter(N)
            plane = r.sharded_plane(devices=devices)
            list(r.route_stream(batches[:2], devices=devices))  # warm
            plane.trace = []
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda.synchronize()
            start.record()
            t0 = time.perf_counter()
            for _ in r.route_stream(batches, devices=devices):
                pass
            wall = time.perf_counter() - t0
            end.record()
            end.synchronize()
            spans = sorted((start.elapsed_time(a), start.elapsed_time(b)) for a, b in plane.trace)
            busy, reach = 0.0, 0.0
            for a, b in spans:
                busy += max(0.0, b - max(a, reach))
                reach = max(reach, b)
            t0 = time.perf_counter()
            for ids in batches:
                r.route_batch(ids)
            batch_wall = time.perf_counter() - t0
            log(f"phase 9 rate, devices {[str(d) for d in plane.devices]}: route_stream "
                f"{keys / wall:.6g} keys/s ({wall * 1e3:.3f} ms for {len(batches)} x {KEYS}), "
                f"route_batch loop {keys / batch_wall:.6g} keys/s ({batch_wall * 1e3:.3f} ms); "
                f"lookup busy at most {busy:.4f} of {start.elapsed_time(end):.4f} ms "
                f"({busy / start.elapsed_time(end):.2%}, host issue time included) over "
                f"{len(spans)} chunk lookups")

    # -- phase 10: replication on the card -------------------------------------
    def phase_replication(self) -> None:
        """Phase 10: replays with followers on the card for every algorithm
        (dense, and packed Memento at w = 10^6 and 10^4 and AnchorHash at a =
        32000), the pull paths and fan-outs on Memento at w = 10^6, then real
        processes over gloo sharing the card."""
        from repro_torch.core.protocol import ALGORITHMS

        t_phase = time.perf_counter()
        reset, snapshot, uncounted = self.launch_counts()
        reset()
        t0 = time.perf_counter()
        self.repl_replays(uncounted)
        replays_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.repl_pulls(uncounted)
        pulls_s = time.perf_counter() - t0
        launches = snapshot()
        log(f"phase 10 launches: {launches}")
        for name in (["delta_apply", "delta_apply_int16", "memento_packed_lookup",
                      "anchor_packed_lookup"]
                     + [f"{a}_{m}" for a in ALGORITHMS for m in ("lookup", "replica", "diff")]):
            if launches[name] <= 0:
                raise AssertionError(f"kernel {name} was not launched on the replication path")
        t0 = time.perf_counter()
        self.repl_processes()
        log(f"phase 10 wall: {time.perf_counter() - t_phase:.1f} s (replays {replays_s:.1f} s, "
            f"pull paths and fan-out {pulls_s:.1f} s, gloo {time.perf_counter() - t0:.1f} s)")

    def repl_replays(self, uncounted) -> None:
        """(a) ``ScenarioDriver(followers=3, tree of arity 2)`` in overlap
        mode: no violation (the convergence checker runs after every synced
        event), the fingerprint of a replay without followers, and every
        follower's 2^20-key lookups at k = 1 and 3 == the leader store's."""
        from repro_torch.core.protocol import ALGORITHMS
        from repro_torch.sim import make_trace

        xl = lambda w, **kw: make_trace("churn_storm_xl", SEED, w=w, **kw)  # noqa: E731
        runs = [(algo, xl(REPL_ANCHOR_W if algo == "anchor" else N), False)
                for algo in ALGORITHMS]
        # the w = 10^4 storm's victims are random, so that its int16 slot
        # tables take writes (LIFO removals of Memento change n alone)
        runs += [("memento", xl(N), True), ("memento", xl(REPL_SMALL_W, select="random"), True),
                 ("anchor", make_trace("churn_storm", SEED, w=ANCHOR_W, storms=3,
                                       burst=REPL_ANCHOR_BURST), True)]
        for algo, trace, packed in runs:
            self.repl_replay(algo, trace, packed, uncounted)

    def repl_replay(self, algo: str, trace, packed: bool, uncounted) -> None:
        from repro_torch.sim import ScenarioDriver

        np = self.np
        config = {"topology": "tree", "arity": 2, "packed": packed}
        t0 = time.perf_counter()
        drv = ScenarioDriver(trace, algo=algo, sync_mode="overlap", followers=REPL_FOLLOWERS,
                             repl_config=config)
        res = drv.run()
        wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        alone = uncounted(lambda: ScenarioDriver(trace, algo=algo, sync_mode="overlap").run())
        alone_s = time.perf_counter() - t0
        label = f"{algo} {trace.name} w={trace.initial_nodes}{' packed' if packed else ''}"
        if not res.ok or res.fingerprint != alone.fingerprint:
            raise AssertionError(f"phase 10 replay {label}: {res.violations[:2]}, fingerprint "
                                 f"{res.fingerprint} != {alone.fingerprint} without followers")
        synced = sum(1 for r in res.metrics.records if r.sync_mode)
        image = drv.store.image()
        _keys, kt = self.keys()
        for k in (1, REPLICAS_K):
            want = uncounted(lambda: drv.store.lookup(kt, k=k)).cpu().numpy()
            for i, f in enumerate(drv.repl.followers):
                if f.image().packed != packed or not np.array_equal(f.lookup(kt, k=k), want):
                    raise AssertionError(f"phase 10 {label}: follower {i} k={k} != leader")
        s = res.summary()
        widths = {k: str(v.dtype).replace("torch.", "")
                  for k, v in drv.repl.followers[0].image().arrays.items()}
        log(f"phase 10 replay {label}: {REPL_FOLLOWERS} followers, tree arity 2, overlap; "
            f"{synced} synced events each checked converged, no violation, fingerprint "
            f"{res.fingerprint} == without followers; every follower's {KEYS} keys k=1 and "
            f"k={REPLICAS_K} == leader; epoch {image.epoch}, tables {widths}; "
            + ", ".join(f"{k} {s[k]}" for k in ("followers", "follower_lag_max",
                                                 "follower_lag_mean", "fanout_depth",
                                                 "wire_frames_total", "wire_bytes_total",
                                                 "leader_sends_total"))
            + f"; {wall:.1f} s (without followers {alone_s:.1f} s)")

    def repl_pulls(self, uncounted) -> None:
        """(b) On one Memento state at w = 10^6 through random storms: a
        follower offline across a storm repaired by a delta catch-up, one
        attached mid-stream (a snapshot catch-up), batch_epochs 0, 1 and 3,
        and flat against tree fan-out (arity 2 and 4, 7 followers)."""
        from repro_torch.core.image_store import DeviceImageStore
        from repro_torch.core.memento import MementoHash
        from repro_torch.core.protocol import image_fingerprint
        from repro_torch.launch.replicate import (DeltaPublisher, FollowerImageStore,
                                                  ReplicationGroup)

        np, torch = self.np, self.torch
        t0 = time.perf_counter()
        m = MementoHash(N, variant="32")
        store = DeviceImageStore(m, device=self.dev)
        pull = ReplicationGroup(m, 2, device=self.dev)
        batched = {be: ReplicationGroup(m, 1, device=self.dev, batch_epochs=be)
                   for be in (0, 1, 3)}
        fans = {"flat": ReplicationGroup(m, REPL_FANOUT, device=self.dev),
                **{f"tree arity {a}": ReplicationGroup(m, REPL_FANOUT, device=self.dev,
                                                       topology="tree", arity=a)
                   for a in (2, 4)}}
        groups = [pull, *batched.values(), *fans.values()]
        pub, probe = DeltaPublisher(m), FollowerImageStore(device=self.dev)
        for g in groups:
            g.publish()
        probe.apply_frames(pub.frames())
        first = {be: (g.stats.frames, g.stats.total_bytes) for be, g in batched.items()}
        dense_bytes = 4 * sum(len(f) for f in uncounted(lambda: DeltaPublisher(m).frames()))
        drains = []
        for storm in range(REPL_STORMS):
            if storm == 1:
                pull.set_online(1, False)
            if storm == 2:
                pull.set_online(1, True)
            self.remove_random(m, REPL_PULL_REMOVALS)
            for _ in range(REPL_PULL_REMOVALS // 2):
                m.add()
            store.sync()
            for g in groups:
                g.publish()
            frames = pub.frames()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            probe.apply_frames(frames)
            torch.cuda.synchronize()
            drains.append(((time.perf_counter() - t1) * 1e3, 4 * sum(len(f) for f in frames)))
        want = image_fingerprint(store.image())
        if not all(g.converged(store.image()) for g in groups) or probe.fingerprint() != want:
            raise AssertionError("phase 10: a group did not converge on the Memento storms")
        repair = (pull.stats.catchup_frames, pull.stats.catchup_bytes)
        if pull.followers[1].snapshots != 1 or repair[0] < 1:
            raise AssertionError("phase 10: the offline follower's repair was not a delta catch-up")
        joined = pull.attach_follower()
        join_bytes = pull.stats.catchup_bytes - repair[1]
        if joined.snapshots != 1 or joined.fingerprint() != want:
            raise AssertionError("phase 10: the attached follower's snapshot catch-up failed")
        prints = {be: g.followers[0].fingerprint() for be, g in batched.items()}
        if set(prints.values()) != {want}:
            raise AssertionError(f"phase 10: batch_epochs fingerprints {prints} != {want}")
        _keys, kt = self.keys()
        leader = uncounted(lambda: store.lookup(kt)).cpu().numpy()
        if not np.array_equal(joined.lookup(kt), leader):
            raise AssertionError("phase 10: the attached follower's lookups != leader")
        packed_bytes = 4 * sum(len(f) for f in
                               uncounted(lambda: DeltaPublisher(m, packed=True).frames()))
        log(f"phase 10 pulls, memento w={N}, {REPL_STORMS} storms of {REPL_PULL_REMOVALS} "
            f"random removals and {REPL_PULL_REMOVALS // 2} adds: follower 1 offline across "
            f"storm 2, repaired by {repair[0]} catch-up frame(s) ({repair[1]} bytes, a delta: "
            f"its snapshots {pull.followers[1].snapshots}); attached follower's snapshot "
            f"catch-up ({join_bytes} bytes) == leader (fingerprint {want}, {KEYS} keys); "
            "batch_epochs 0/1/3 fingerprints equal; the storms' frames and bytes after the "
            "first snapshot: " + "; ".join(
                f"batch_epochs {be}: {g.stats.frames - first[be][0]} frames, "
                f"{g.stats.total_bytes - first[be][1]} bytes" for be, g in batched.items()))
        log(f"phase 10 fan-out, {REPL_FANOUT} followers: " + "; ".join(
            f"{name}: frames {g.stats.frames}, bytes {g.stats.total_bytes}, leader sends "
            f"{g.stats.leader_sends}, leader bytes {g.stats.leader_bytes}, total sends "
            f"{g.stats.total_sends}, depth {g.depth}" for name, g in fans.items()))
        log(f"phase 10 wire: dense snapshot at w={N} {dense_bytes} bytes, packed "
            f"{packed_bytes} bytes; follower drain (decode, compose, delta_apply, a "
            "synchronize) ms and frame bytes by storm: "
            + ", ".join(f"{ms:.3f} ms / {b} bytes" for ms, b in drains)
            + f"; {time.perf_counter() - t0:.1f} s")

    def repl_processes(self) -> None:
        """(c) Real processes over gloo, every one on this card: a 4-process
        ``TreeBroadcast(arity=2)`` led at Memento w = 10^6, and a 2-process
        ``DistributedBroadcast`` over PowerHash.  Every rank's epoch,
        fingerprint and 2^20-key lookup CRC must agree."""
        mode = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip().splitlines()[0]
        log(f"phase 10 compute mode: {mode}")
        if mode != "Default":
            raise AssertionError(f"phase 10 needs compute mode Default to put 4 processes on "
                                 f"one card, not {mode}")
        for nproc, algo, tree in ((4, "memento", True), (2, "power", False)):
            self.gloo_run(nproc, algo, tree)

    def gloo_run(self, nproc: int, algo: str, tree: bool) -> None:
        import socket

        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        path = os.pathsep.join([str(SRC)] + [p for p in [os.environ.get("PYTHONPATH")] if p])
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-c", WORKER_PRELUDE + GLOO_WORKER], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True,
            env=dict(os.environ, PYTHONPATH=path, REPL_PID=str(pid), REPL_NPROC=str(nproc),
                     REPL_PORT=str(port), REPL_ALGO=algo, REPL_TREE=str(int(tree)),
                     REPL_N=str(N), REPL_KEYS=str(KEYS), REPL_ROUNDS=str(GLOO_ROUNDS),
                     REPL_BURST=str(GLOO_BURST), REPL_SEED=str(SEED)))
            for pid in range(nproc)]
        results, deadline = [], time.perf_counter() + GLOO_TIMEOUT
        try:
            for pid, p in enumerate(procs):
                try:
                    out, err = p.communicate(timeout=max(1.0, deadline - time.perf_counter()))
                except subprocess.TimeoutExpired:
                    raise AssertionError(f"phase 10 gloo rank {pid} timed out after "
                                         f"{GLOO_TIMEOUT} s") from None
                if p.returncode != 0:
                    raise AssertionError(f"phase 10 gloo rank {pid} failed:\n{out}\n{err[-4000:]}")
                results.append(json.loads([ln for ln in out.splitlines()
                                           if ln.startswith("{")][-1]))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        agree = {(r["epoch"], r["fingerprint"], r["lookup_crc"]) for r in results}
        if len(agree) != 1:
            raise AssertionError(f"phase 10 gloo {algo}: ranks disagree: {results}")
        rounds = [r["round_ms"] for r in results]
        log(f"phase 10 gloo {'TreeBroadcast(arity=2)' if tree else 'DistributedBroadcast'}, "
            f"{nproc} processes on {self.dev}, {algo} w={N}, {GLOO_ROUNDS} rounds of "
            f"{GLOO_BURST}-event bursts: every rank at epoch {results[0]['epoch']}, fingerprint "
            f"{results[0]['fingerprint']}, lookup CRC of {KEYS} keys {results[0]['lookup_crc']}; "
            "launches a rank " + ", ".join(json.dumps(r["launches"]) for r in results)
            + "; snapshot round ms by rank " + ", ".join(f"{r[0]:.3f}" for r in rounds)
            + "; burst round ms by rank, median " + ", ".join(
                f"{self.np.median(r[1:]):.3f}" for r in rounds)
            + f"; snapshot frame {max(r['snapshot_bytes'] for r in results)} bytes; "
            f"{time.perf_counter() - t0:.1f} s")

    # -- phase 11: the telemetry plane -----------------------------------------
    def phase_telemetry(self) -> None:
        """Phase 11: route_batch with telemetry off and on at n = 10^6, a
        telemetered Memento one-shot replay at w = 10^6, every algorithm's
        churn_storm with followers replayed twice with telemetry and once
        without, and a telemetered storm under torch.profiler."""
        from repro_torch.core.protocol import ALGORITHMS

        t_phase = time.perf_counter()
        reset, snapshot, _uncounted = self.launch_counts()
        reset()
        self.tele_routing()
        self.tele_replay()
        self.tele_storms()
        self.tele_profiler()
        launches = snapshot()
        log(f"phase 11 launches: {launches}")
        for name in (["memento_lookup", "memento_diff", "delta_apply"]
                     + [f"{a}_{m}" for a in ALGORITHMS for m in ("lookup", "diff")]):
            if launches[name] <= 0:
                raise AssertionError(f"kernel {name} was not launched on the telemetry path")
        log(f"phase 11 wall: {time.perf_counter() - t_phase:.1f} s")

    def tele_routing(self) -> None:
        """(a) Two routers over one host state, one with a MetricRegistry
        injected (and installed as the process default, where the engine
        records), route the same 2^20-id batches in turns (which side goes
        first alternates) on the stable state and on phase 2's one-shot
        state: equal outputs, and the router, store and engine count the
        batches and keys routed."""
        from repro_torch import obs
        from repro_torch.core.protocol import make_hash
        from repro_torch.serve.router import SessionRouter

        np = self.np
        rng = np.random.default_rng([SEED, 11])
        batches = [rng.integers(0, 2**63, size=KEYS, dtype=np.uint64)
                   for _ in range(TELEMETRY_BATCHES)]
        stable = make_hash("memento", N, variant="32")
        for label, h in (("stable", stable), ("one-shot", self.kept["memento"][0])):
            reg = obs.MetricRegistry()
            off = SessionRouter(0, algo=h, device=self.dev)
            on = SessionRouter(0, algo=h, device=self.dev, registry=reg)
            off.route_batch(batches[0])  # warm
            on.image_store()
            ms = {"off": [], "on": []}

            def route(side, ids):
                prev = obs.set_default_registry(reg if side == "on" else None)
                try:
                    t0 = time.perf_counter()
                    out = (on if side == "on" else off).route_batch(ids)
                    ms[side].append((time.perf_counter() - t0) * 1e3)
                finally:
                    obs.set_default_registry(prev)
                return out

            for i, ids in enumerate(batches):
                # the side that runs second finds the ids warm: alternate
                order = ("off", "on") if i % 2 == 0 else ("on", "off")
                outs = {side: route(side, ids) for side in order}
                got, want = outs["on"], outs["off"]
                if not np.array_equal(got, want):
                    raise AssertionError(f"phase 11 {label}: route_batch with telemetry != off")
            c = reg.snapshot()["counters"]
            n, keys = len(batches), len(batches) * KEYS
            counts = {name: c.get(name) for name in (
                "router.batch_keys", "store.lookups", "store.lookup_keys", "engine.lookups",
                "engine.dispatches", "engine.keys")}
            if counts != {"router.batch_keys": keys, "store.lookups": n,
                          "store.lookup_keys": keys, "engine.lookups": n,
                          "engine.dispatches": n, "engine.keys": keys}:
                raise AssertionError(f"phase 11 {label}: counters {counts} != {n} batches of "
                                     f"{KEYS} keys")
            p50 = {k: float(np.median(v)) for k, v in ms.items()}
            log(f"phase 11 route_batch {label} (w={h.working}): {n} batches of {KEYS} ids "
                f"in turns (off first on even batches), equal with telemetry on and off; "
                f"p50 batch ms off "
                f"{p50['off']:.3f}, on {p50['on']:.3f}, on/off {p50['on'] / p50['off']:.4f} "
                f"(all ms off {[round(x, 3) for x in ms['off']]}, on "
                f"{[round(x, 3) for x in ms['on']]}); counters {counts}")

    def tele_replay(self) -> None:
        """(b) Memento one-shot at w = 10^6 with 2^20 keys, telemetered: the
        fingerprint of phase 4's replay, and the sim's delta words equal to
        the store's."""
        from repro_torch.sim import make_trace, replay

        t0 = time.perf_counter()
        res = replay(make_trace("oneshot", SEED, w=N, n_keys=KEYS), algo="memento",
                     probe_keys=KEYS, telemetry=True)
        want = self.fingerprints[("oneshot", "memento", "full")]
        c = res.summary()["telemetry"]["counters"]
        if not res.ok or res.fingerprint != want:
            raise AssertionError(f"phase 11 one-shot replay: {res.fingerprint} != phase 4's "
                                 f"{want}, {res.violations[:2]}")
        if c["sim.delta_words"] != c.get("store.delta_words", 0) or \
                c["sim.snapshot_words"] != c.get("store.snapshot_words", 0):
            raise AssertionError(f"phase 11 one-shot replay: sim and store words differ: {c}")
        log(f"phase 11 replay memento one-shot w={N}, {KEYS} keys, telemetry=True: fingerprint "
            f"{res.fingerprint} == phase 4's, sim.delta_words {c['sim.delta_words']} == "
            f"store.delta_words, sim.snapshot_words {c['sim.snapshot_words']} == "
            f"store.snapshot_words; engine dispatches {c['engine.dispatches']}, keys "
            f"{c['engine.keys']}, moved keys {c.get('engine.moved_keys', 0)}; "
            f"{time.perf_counter() - t0:.1f} s")

    def tele_storms(self) -> None:
        """(c) Every algorithm's churn_storm at its default size with two
        followers, twice with telemetry and once without: one fingerprint,
        equal counter and gauge snapshots and histogram counts, and the
        Prometheus text of each parsing back to its counters."""
        from repro_torch import obs
        from repro_torch.core.protocol import ALGORITHMS
        from repro_torch.sim import make_trace, replay

        t0 = time.perf_counter()
        for algo in ALGORITHMS:
            trace = make_trace("churn_storm", SEED)
            runs = [replay(trace, algo=algo, followers=2, telemetry=tele)
                    for tele in (True, True, False)]
            prints = {r.fingerprint for r in runs}
            if len(prints) != 1 or not all(r.ok for r in runs):
                raise AssertionError(f"phase 11 churn_storm {algo}: fingerprints {prints}")
            snaps = [r.metrics.obs.snapshot() for r in runs[:2]]
            for part in ("counters", "gauges"):
                if snaps[0][part] != snaps[1][part]:
                    raise AssertionError(f"phase 11 churn_storm {algo}: {part} differ")
            counts = [{k: v["count"] for k, v in s["histograms"].items()} for s in snaps]
            if counts[0] != counts[1]:
                raise AssertionError(f"phase 11 churn_storm {algo}: histogram counts differ")
            for r, snap in zip(runs, snaps):
                parsed = prom_counters(obs.render_prometheus(r.metrics.obs))
                want = {obs.export.prom_name(k.partition("{")[0]) + (
                    "{" + k.partition("{")[2] if "{" in k else ""): v
                        for k, v in snap["counters"].items()}
                if parsed != want:
                    raise AssertionError(f"phase 11 churn_storm {algo}: the exposition's "
                                         f"counters != the snapshot's")
            c = snaps[0]["counters"]
            log(f"phase 11 churn_storm {algo} (w={trace.initial_nodes}, 2 followers): "
                f"fingerprint {runs[0].fingerprint} x3, counters ({len(c)}), gauges "
                f"({len(snaps[0]['gauges'])}) and histogram counts ({len(counts[0])}) equal "
                f"run to run, exposition == snapshot; store.syncs {c['store.syncs']}, "
                f"repl.publishes {c['repl.publishes']}, repl.wire_bytes {c['repl.wire_bytes']}, "
                f"engine.dispatches {c['engine.dispatches']}, spans "
                f"{len(runs[0].metrics.obs.tracer.completed())}")
        log(f"phase 11 churn_storms: {time.perf_counter() - t0:.1f} s")

    def tele_profiler(self) -> None:
        """(d) A telemetered Memento storm under torch.profiler: every span
        of the tracer's ring is a CPU event of the profile.  Logs the
        profile's device events by name in three groups (the spans' ranges
        on the device, copies, kernels: whether kernels launched through
        the ctypes library show up is the finding; nothing about them is
        asserted) and the card's busy share over the replay's wall, the
        union of its kernel and copy intervals."""
        from torch.profiler import ProfilerActivity, profile

        from repro_torch.sim import make_trace, replay

        torch = self.torch
        activities = [ProfilerActivity.CPU]
        if self.dev.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        trace = make_trace("churn_storm", SEED)
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            res = replay(trace, algo="memento", followers=2, telemetry=True)
            if self.dev.type == "cuda":
                torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        events = prof.events()
        cpu_names = {e.name for e in events}
        spans = {s.name for s in res.metrics.obs.tracer.completed()}
        if not spans or not spans <= cpu_names:
            raise AssertionError(f"phase 11 profiler: spans {sorted(spans - cpu_names)} are "
                                 "not CPU events of the profile")
        # the profile's device events: the spans' own ranges on the device
        # (kineto's GPU user annotations, named as the spans), copies, kernels
        groups: dict = {"span ranges": {}, "copies": {}, "kernels": {}}
        busy = []
        for e in events:
            if "CUDA" not in str(getattr(e, "device_type", "")):
                continue
            group = ("span ranges" if e.name in spans else
                     "copies" if e.name.startswith(("Memcpy", "Memset")) else "kernels")
            n, us = groups[group].get(e.name, (0, 0.0))
            groups[group][e.name] = (n + 1, us + e.time_range.elapsed_us())
            if group != "span ranges":
                busy.append((e.time_range.start, e.time_range.end))
        busy_us, reach = 0.0, -math.inf
        for a, b in sorted(busy):
            busy_us += max(0.0, b - max(a, reach))
            reach = max(reach, b)
        parts = []
        for group, names in groups.items():
            total = sum(us for _n, us in names.values())
            parts.append(f"{group}: {len(names)} names, {sum(n for n, _us in names.values())} "
                         f"events, {total:.3f} device us ({total / wall_us:.4%} of the wall)"
                         + "".join(f"; {name[:120]} x{n} {us:.3f} us" for name, (n, us) in sorted(
                             names.items(), key=lambda kv: -kv[1][1])))
        log(f"phase 11 profiler: memento churn_storm with 2 followers, telemetry=True, "
            f"{wall_us / 1e3:.3f} ms of wall; {len(spans)} span names, all among the "
            f"{len(cpu_names)} CPU event names; the card busy (the union of its kernel and "
            f"copy intervals, CUPTI stamps) {busy_us:.3f} us, {busy_us / wall_us:.4%} of the "
            f"wall; CUDA events by group: " + " | ".join(parts))


if __name__ == "__main__":
    sys.exit(main())
