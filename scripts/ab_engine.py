#!/usr/bin/env python3
"""Time two builds of ``csrc/engine.cu`` and ``csrc/delta_apply.cu`` on one
GPU, in turns, on the same states, through the port's public wrappers:
another commit's sources (a ``git archive`` of its ``csrc`` unpacked into a
directory that ``.gitignore`` lists) and this tree's; or more builds, each
a directory of sources named LABEL=DIR (variants of one design choice).

    git archive PARENT src/repro_torch/kernels/csrc | tar -x -C archive/parent
    python3 scripts/ab_engine.py archive/parent/src/repro_torch/kernels/csrc \
        [LABEL=DIR ...] [--json PATH] [--only ENTRY,ENTRY,...] [--ptxas NAME,...]

Each case is an entry, a state, one call of its wrapper and the plain
version to hold it against (:func:`cases`); a redesign of another entry
adds its cases there.  Each case runs old, new, new, old (with more
builds: old, each LABEL in order, new, then back; CUDA-event means over
REPS launches, as ``chip_smoke.py`` times them); every build's outputs
must equal the old build's over the whole batch, and the plain version
on the first ``check`` keys.  Every build must export the same entries
with the same arguments, or lack an entry: that entry's cases then run on
the builds that have it, held against the first of them.

Prints one JSON line a case; ``--json PATH`` also writes them all to
PATH; ``--only`` runs only the cases of the named entries, and builds only
the states of their group (:data:`GROUPS`); ``--ptxas`` prints each
build's ``ptxas -v`` lines of the kernels whose names hold one of the
NAMEs.  Needs a GPU and ``nvcc``.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.core.memento import MementoHash  # noqa: E402
from repro_torch.core.packing import pack_image  # noqa: E402
from repro_torch.core.protocol import ALGORITHMS, DeviceImage, make_hash  # noqa: E402
from repro_torch.kernels import build, engine  # noqa: E402
from repro_torch.kernels import delta_apply as da  # noqa: E402
from repro_torch.serve.router import SessionRouter  # noqa: E402

REPS = 20
PREFIX = 2**14  # keys held against a plain version that takes minutes on all
SOURCES = ("engine", "delta_apply")  # the csrc files each build takes from its directory
APPLY_LENGTHS = (128, 2**12, 2**15, 2**17, 2**20)  # the delta applies' sweep of table lengths
APPLY_SWEEP_UPDATES = 8  # updates drawn for each length of the sweep


def dx_states(smoke):
    """DxHash at a = 4·10^6 on the card: stable (w = 10^6), w = 5·10^5
    (the incremental scenario's last stage) and one-shot 90 % (w = 10^5),
    each of the last two also one removal later: (name, (tables, scalars,
    table bytes, image))."""
    h = make_hash("dx", cs.N, capacity=cs.CAPACITY_FACTOR * cs.N, variant="32")

    def remove(count):
        for b in smoke.rng.permutation(sorted(h.working_set()))[:count].tolist():
            h.remove(b)

    yield "stable", smoke.operands(h)
    for name, working in (("w=5*10^5", cs.N // 2), ("one-shot", cs.N // 10)):
        remove(h.working - working)
        yield name, smoke.operands(h)
        remove(1)
        yield f"{name} + 1 removal", smoke.operands(h)


def _narrowed(smoke, h, dtype=torch.int8):
    """``h``'s packed image with its slots (Memento) or A/K (AnchorHash)
    cast to ``dtype`` by hand (the values fit), on the card."""
    img = pack_image(h.device_image())
    names = ("slot_b", "slot_c") if img.algo == "memento" else ("A", "K")
    arrays = {k: (v.to(dtype) if k in names else v).to(smoke.dev)
              for k, v in img.arrays.items()}
    return DeviceImage(img.algo, img.n, arrays, dict(img.scalars), img.epoch, packed=True)


def packed_states(smoke):
    """(name, image, working, dense image or None) of every packed Memento
    state, on the card: n = 10^6 stable, after 1024 removals and one-shot
    90 % (int32 slots; with their dense images), n = 10^4 (int16) and a
    hand-narrowed n = 100 (int8)."""
    router = SessionRouter(cs.N, compact_images=True)
    store, h = router.image_store(), router.ch
    yield "int32 stable", store.image(), h.working, smoke.on_card(h.device_image())
    smoke.remove_random(h, cs.PACKED_REMOVALS)
    store.sync()
    yield (f"int32 {cs.PACKED_REMOVALS} removals", store.image(), h.working,
           smoke.on_card(h.device_image()))
    smoke.remove_random(h, int(cs.ONESHOT_FRACTION * cs.N) - cs.PACKED_REMOVALS)
    store.sync()
    yield "int32 one-shot", store.image(), h.working, smoke.on_card(h.device_image())
    small = MementoHash(cs.SMALL_N, variant="32")
    smoke.remove_random(small, cs.SMALL_EVENTS[0])
    yield "int16 n=10^4", smoke.on_card(pack_image(small.device_image())), small.working, None
    tiny = MementoHash(cs.TINY_N, variant="32")
    smoke.remove_random(tiny, cs.TINY_N // 2)
    yield "int8 n=100", _narrowed(smoke, tiny), tiny.working, None


def packed_pairs(smoke, states):
    """(name, old image, new image) of packed Memento epoch pairs on the
    card: ``chip_smoke.py``'s three, all of equal n (int32 stable -> one-shot
    at n = 10^6, int16 n = 10^4 -> 20 removals later, int8 n = 100 -> one
    removal later), the n = 10^4 pair with its old epoch's slots widened to
    int32, and n = 10^6 unchurned -> its last bucket removed (n - 1)."""
    yield "int32 stable -> one-shot", states["int32 stable"], states["int32 one-shot"]
    small = MementoHash(cs.SMALL_N, variant="32")
    old = smoke.on_card(pack_image(small.device_image()))
    wide = _narrowed(smoke, small, torch.int32)
    smoke.remove_random(small, cs.SMALL_EVENTS[0])
    new = smoke.on_card(pack_image(small.device_image()))
    yield "int16 n=10^4 -> 20 removals", old, new
    yield "int32 -> int16 n=10^4 -> 20 removals", wide, new
    tiny = MementoHash(cs.TINY_N, variant="32")
    smoke.remove_random(tiny, cs.TINY_N // 2)
    old = _narrowed(smoke, tiny)
    smoke.remove_random(tiny, 1)
    yield "int8 n=100 -> 1 removal", old, _narrowed(smoke, tiny)
    m = MementoHash(cs.N, variant="32")
    old = smoke.on_card(pack_image(m.device_image()))
    m.remove(cs.N - 1)
    yield "int32 n=10^6 -> last bucket removed", old, smoke.on_card(pack_image(m.device_image()))


def anchor_states(smoke):
    """AnchorHash at a = 4·10^6 on the card: stable (w = 10^6), one-shot
    90 % (w = 10^5), one removal later, and that removal restored and
    another bucket removed (a stack that parts from the one before it):
    (name, (tables, scalars, table bytes, image, working))."""
    h = make_hash("anchor", cs.N, capacity=cs.CAPACITY_FACTOR * cs.N, variant="32")
    yield "stable", (*smoke.operands(h), h.working)
    smoke.remove_fraction(h, cs.ONESHOT_FRACTION)
    yield "one-shot", (*smoke.operands(h), h.working)
    x, y = (int(b) for b in smoke.rng.choice(sorted(h.working_set()), 2, replace=False))
    h.remove(x)
    yield "one-shot + 1 removal", (*smoke.operands(h), h.working)
    h.add()
    h.remove(y)
    yield "one-shot + another removal", (*smoke.operands(h), h.working)


def anchor_small_states(smoke):
    """AnchorHash's narrow packed images on the card: a = 32000, w = 8000
    after 20 removals (int16), and a = 100 after 50 removals, narrowed to
    int8 by hand."""
    small = make_hash("anchor", cs.ANCHOR_W, capacity=cs.ANCHOR_A, variant="32")
    for v in smoke.rng.permutation(sorted(small.working_set()))[:cs.SMALL_EVENTS[0]].tolist():
        small.remove(v)
    yield "int16 a=32000", smoke.on_card(pack_image(small.device_image()))
    tiny = make_hash("anchor", cs.TINY_N, capacity=cs.TINY_N, variant="32")
    smoke.remove_fraction(tiny, 0.5)
    yield "int8 a=100", _narrowed(smoke, tiny)


def anchor_packed_pairs(smoke):
    """``chip_smoke.py``'s packed AnchorHash epoch pairs on the card, each
    (name, old operands, new operands): at int16, a = 32000 with w = 8000
    -> 20 removals and 5 restores later, and at int8 (by hand), a = 100
    with 50 removed -> one removal later, both nesting; and after each, a
    pair whose stacks part (:meth:`chip_smoke.Smoke.diverging_pair`)."""
    def packed(img, dtype):
        p = pack_image(img)
        return engine.image_operands(DeviceImage(
            p.algo, p.n, {k: (v.to(dtype) if k in ("A", "K") else v).to(smoke.dev)
                          for k, v in p.arrays.items()}, dict(p.scalars), p.epoch, packed=True))

    small = make_hash("anchor", cs.ANCHOR_W, capacity=cs.ANCHOR_A, variant="32")
    old = packed(small.device_image(), torch.int16)
    removals, restores = cs.SMALL_EVENTS
    for v in smoke.rng.permutation(sorted(small.working_set()))[:removals].tolist():
        small.remove(v)
    for _ in range(restores):
        small.add()
    yield (f"int16 a=32000 -> {removals} removals, {restores} restores", old,
           packed(small.device_image(), torch.int16))
    yield "int16 a=32000 parted", *(packed(i, torch.int16) for i in smoke.diverging_pair(small))
    tiny = make_hash("anchor", cs.TINY_N, capacity=cs.TINY_N, variant="32")
    smoke.remove_fraction(tiny, 0.5)
    old = packed(tiny.device_image(), torch.int8)
    tiny.remove(sorted(tiny.working_set())[3])
    yield "int8 a=100 -> 1 removal", old, packed(tiny.device_image(), torch.int8)
    yield "int8 a=100 parted", *(packed(i, torch.int8) for i in smoke.diverging_pair(tiny))


def nest_check_case(entry: str, state: str, old, new, table: str):
    """The case of the check alone (``engine.anchor_nest_check``, C entry
    ``entry``) over two epochs: its (verdict, N_S) against the plain
    check's."""
    want = torch.tensor(engine.anchor_nest_plain(old, new), dtype=torch.int32,
                        device=old[0][0].device)
    return (entry, state, lambda keys: engine.anchor_nest_check(old, new, table=table),
            lambda keys: want, None)


def anchor_cases(smoke, keys_np, anchor):
    """The cases of the entries that share ``anchor_one``, beyond the
    replica sets' (:func:`shared_walk_sets`): ``anchor_lookup`` stable and
    one-shot at a = 4·10^6, ``anchor_diff`` stable -> one-shot and one-shot
    -> one removal later, ``anchor_walk`` one-shot (half the lanes and every
    lane pending, ``bounded_assign``'s load and cap, each beside its warp
    and slot model), ``anchor_replica_diff`` k = 3 from one-shot back to
    stable (a restore: the newer epoch the shallower) and between two
    one-shot states whose stacks part (two walks), each beside its check's
    verdict and words a key (also printed for stable -> one-shot, whose case
    is :func:`shared_walk_sets`'), and its check alone (``anchor_nest_check``)
    stable -> one-shot and on the parted pair; ``anchor_packed_lookup`` and
    ``anchor_packed_walk`` (half the lanes pending) at int16 and int8; and
    ``anchor_packed_diff``, ``anchor_packed_replica_diff`` (k = 3) and their
    check alone (``anchor_packed_nest_check``) on :func:`anchor_packed_pairs`,
    each pair beside its check's verdict and words a key."""
    for name in ("stable", "one-shot"):
        yield ("anchor_lookup", name,
               lambda keys, t=anchor[name][:2]: engine.kernel_lookup("anchor", keys, *t),
               lambda keys, t=anchor[name][:2]: engine.lookup_plain("anchor", keys, *t), PREFIX)
    for old, new in (("stable", "one-shot"), ("one-shot", "one-shot + 1 removal")):
        e = (anchor[old][:2], anchor[new][:2])
        yield ("anchor_diff", f"{old} -> {new}",
               lambda keys, e=e: engine.kernel_diff("anchor", keys, *e),
               lambda keys, e=e: engine.diff_plain("anchor", keys, *e), PREFIX)
    tables, scalars, _, img, working = anchor["one-shot"]
    walk = (tables, scalars, *_bounded_load(smoke, keys_np, img, working))
    probe = torch.zeros(cs.KEYS, dtype=torch.int32, device=smoke.dev)
    mixed = torch.from_numpy(smoke.rng.random(cs.KEYS) < 0.5).to(smoke.dev)
    chain = engine.key_tensor(keys_np, smoke.dev)
    for label, pending in (("half the lanes", mixed),
                           ("every lane", torch.ones_like(mixed))):
        anchor_walk_model(chain, probe, pending, walk, label)
        yield ("anchor_walk", f"one-shot cap={walk[3]}, {label} pending",
               lambda keys, p=pending: engine.kernel_walk("anchor", keys, probe[:len(keys)],
                                                          p[:len(keys)], *walk),
               lambda keys, p=pending: engine.walk_plain("anchor", keys, probe[:len(keys)],
                                                         p[:len(keys)], *walk), PREFIX)
    for old, new in (("stable", "one-shot"), ("one-shot", "stable"),
                     ("one-shot + 1 removal", "one-shot + another removal")):
        e = (anchor[old][:2], anchor[new][:2])
        anchor_pair_model(keys_np, *e, f"{old} -> {new}", cs.REPLICAS_K)
        if old != "one-shot":
            yield nest_check_case("anchor_nest_check", f"{old} -> {new}", *e, "dense")
        if old == "stable":
            continue  # that case is shared_walk_sets'
        yield ("anchor_replica_diff", f"{old} -> {new} k={cs.REPLICAS_K}",
               lambda keys, e=e: engine.kernel_replica_diff("anchor", keys, cs.REPLICAS_K, *e),
               lambda keys, e=e: engine.replica_diff_plain("anchor", keys, cs.REPLICAS_K, *e),
               PREFIX)
    for name, img in anchor_small_states(smoke):
        t = engine.image_operands(img)
        yield ("anchor_packed_lookup", name,
               lambda keys, t=t: engine.kernel_lookup("anchor", keys, *t, table="packed"),
               lambda keys, t=t: engine.lookup_plain("anchor", keys, *t, table="packed"), None)
        w = (*t, *_bounded_load(smoke, keys_np, img, _working(img)))
        yield ("anchor_packed_walk", f"{name} cap={w[3]}, half the lanes pending",
               lambda keys, w=w: engine.kernel_walk("anchor", keys, probe[:len(keys)],
                                                    mixed[:len(keys)], *w, table="packed"),
               lambda keys, w=w: engine.walk_plain("anchor", keys, probe[:len(keys)],
                                                   mixed[:len(keys)], *w, table="packed"),
               None)
    kw = {"table": "packed"}
    for name, *e in anchor_packed_pairs(smoke):
        for k in (1, cs.REPLICAS_K):
            anchor_pair_model(keys_np, *e, name, k)
        yield nest_check_case("anchor_packed_nest_check", name, *e, "packed")
        yield ("anchor_packed_diff", name,
               lambda keys, e=e: engine.kernel_diff("anchor", keys, *e, **kw),
               lambda keys, e=e: engine.diff_plain("anchor", keys, *e, **kw), None)
        yield ("anchor_packed_replica_diff", f"{name} k={cs.REPLICAS_K}",
               lambda keys, e=e: engine.kernel_replica_diff("anchor", keys, cs.REPLICAS_K, *e,
                                                            **kw),
               lambda keys, e=e: engine.replica_diff_plain("anchor", keys, cs.REPLICAS_K, *e,
                                                           **kw), None)


def anchor_walk_model(chain, probe, pending, walk, label: str) -> None:
    """Print ``anchor_walk``'s warp and slot model (``chip_smoke.walk_slots``)
    of this case: lookup rounds a warp and the round trips a block holds
    its slots, one thread a lane."""
    (A, K), (a,), load, cap = walk
    trips = cs.walk_step_trips(chain, probe, pending, load, cap,
                               lambda k: cs.anchor_lookup_trips(k, A, K, a)).cpu()
    print(f"anchor_walk model, {label} pending, {cs.WALK_BLOCK} lanes a block: "
          + json.dumps(cs.walk_slots(trips)), flush=True)


def anchor_pair_model(keys_np, old, new, label: str, k: int) -> None:
    """Print the check's verdict (the plain check) of an AnchorHash diff at k
    slots (dense or packed epochs) and the words a key of its walks
    (``chip_smoke.anchor_words``): the pair model's one walk where the
    epochs nest, each epoch's walk where they do not, over the first PREFIX
    keys."""
    keys = engine.key_tensor(keys_np[:PREFIX], old[0][0].device)
    verdict = engine.anchor_nest_plain(old, new)
    work: dict = {}
    if verdict[0] == engine.NEST_NONE and k == 1:
        engine.diff_plain("anchor", keys, old, new, work)
    elif verdict[0] == engine.NEST_NONE:
        engine.replica_diff_plain("anchor", keys, k, old, new, work)
    elif k == 1:
        engine.anchor_pair_diff_plain(keys, old, new, work)
    else:
        engine.anchor_pair_replica_diff_plain(keys, k, old, new, work)
    walks = PREFIX if verdict[0] != engine.NEST_NONE else 2 * PREFIX
    print(f"anchor diff k={k} {label}: check {verdict}; "
          f"{cs.anchor_words(work, walks) / PREFIX:.4f} words a key in its walks "
          f"({ {k: round(v / PREFIX, 4) for k, v in work.items()} } a key)", flush=True)


def _working(img) -> int:
    """The working buckets of an AnchorHash image: those with A = 0."""
    return int((img.arrays["A"][:img.n] == 0).sum())


def _bounded_load(smoke, keys_np, img, working):
    """``bounded_assign``'s load of ``keys_np`` on ``img`` at c = CAP_C, on
    the card, and its cap."""
    cap = int(np.ceil(cs.CAP_C * cs.KEYS / working))
    _, load = engine.bounded_assign(keys_np, img,
                                    np.zeros(engine.bounded_load_len(img), np.int32), cap)
    return torch.from_numpy(load).to(smoke.dev), cap


def compact_lookup_case(state, img):
    """The case of ``memento_compact_lookup`` on the compact table of a dense
    image."""
    ops = engine.image_operands(img, "compact")
    return ("memento_compact_lookup", state,
            lambda keys: engine.kernel_lookup("memento", keys, *ops, table="compact"),
            lambda keys: engine.lookup_plain("memento", keys, *ops, table="compact"), PREFIX)


def memento_sets(smoke, keys_np, state, img, working):
    """The cases of ``memento_replica`` on a dense image (k = 3; one-shot
    also bounded k = 2 under ``bounded_assign``'s load and cap) and, one-shot,
    of ``memento_compact_lookup`` and ``memento_compact_replica`` (k = 3,
    bounded k = 2) on its compact table."""
    sets = [(cs.REPLICAS_K, None, None)]
    if state == "one-shot":
        sets.append((cs.BOUNDED_K, *_bounded_load(smoke, keys_np, img, working)))
    layouts = [("memento_replica", "dense", None)]
    if state == "one-shot":
        layouts.append(("memento_compact_replica", "compact", PREFIX))
        yield compact_lookup_case(state, img)
    for entry, table, check in layouts:
        tables, scalars = engine.image_operands(img, table)
        for k, ld, c in sets:
            args = (k, tables, scalars, ld, c)
            yield (entry, f"{state} {'bounded ' if ld is not None else ''}k={k}",
                   lambda keys, a=args, t=table: engine.kernel_replica("memento", keys, *a,
                                                                       table=t),
                   lambda keys, a=args, t=table: engine.replica_plain("memento", keys, *a,
                                                                      table=t), check)


def walk_case(algo: str, state: str, walk, pending):
    """The case of ``{algo}_walk`` on ``walk`` = (tables, scalars, load, cap)
    from probe 0, ``pending`` lanes pending."""
    probe = torch.zeros(cs.KEYS, dtype=torch.int32, device=pending.device)
    return (f"{algo}_walk", f"{state} cap={walk[3]}",
            lambda keys: engine.kernel_walk(algo, keys, probe[:len(keys)],
                                            pending[:len(keys)], *walk),
            lambda keys: engine.walk_plain(algo, keys, probe[:len(keys)],
                                           pending[:len(keys)], *walk), PREFIX)


def shared_walk_sets(smoke, keys_np, anchor):
    """The cases of the other entries that share ``replica_row`` with
    Memento's sets: AnchorHash (a = 4·10^6, ``anchor``'s states; also
    stable k = 3), JumpHash and PowerHash at w = 10^6, one-shot k = 3 and
    bounded k = 2 (``bounded_assign``'s load and cap), and the k = 3 diff
    stable -> one-shot; and of ``jump_walk`` and ``power_walk``, stable
    (w = 10^6) and one-shot, half the lanes pending, ``bounded_assign``'s
    load and cap."""
    pending = torch.from_numpy(np.random.default_rng(cs.SEED).random(cs.KEYS) < 0.5).to(
        smoke.dev)
    for algo in (a for a in ALGORITHMS if a not in ("memento", "dx")):
        if algo == "anchor":
            stable, (tables, scalars, _, img, working) = anchor["stable"][:2], anchor["one-shot"]
        else:
            h = make_hash(algo, cs.N, capacity=cs.CAPACITY_FACTOR * cs.N, variant="32")
            tables, scalars, _, img = smoke.operands(h)
            stable = (tables, scalars)
            yield walk_case(algo, "stable", (*stable, *_bounded_load(
                smoke, keys_np, img, h.working)), pending)
            smoke.remove_fraction(h, cs.ONESHOT_FRACTION)
            (tables, scalars, _, img), working = smoke.operands(h), h.working
            yield walk_case(algo, "one-shot", (tables, scalars, *_bounded_load(
                smoke, keys_np, img, working)), pending)
        sets = [("one-shot", tables, scalars, cs.REPLICAS_K, None, None),
                ("one-shot", tables, scalars, cs.BOUNDED_K,
                 *_bounded_load(smoke, keys_np, img, working))]
        if algo == "anchor":
            sets.insert(0, ("stable", *stable, cs.REPLICAS_K, None, None))
        for state, t, sc, k, ld, c in sets:
            args = (k, t, sc, ld, c)
            yield (f"{algo}_replica", f"{state} {'bounded ' if ld is not None else ''}k={k}",
                   lambda keys, a=args, al=algo: engine.kernel_replica(al, keys, *a),
                   lambda keys, a=args, al=algo: engine.replica_plain(al, keys, *a), PREFIX)
        epochs = (stable, (tables, scalars))
        yield (f"{algo}_replica_diff", f"stable -> one-shot k={cs.REPLICAS_K}",
               lambda keys, e=epochs, al=algo: engine.kernel_replica_diff(
                   al, keys, cs.REPLICAS_K, *e),
               lambda keys, e=epochs, al=algo: engine.replica_diff_plain(
                   al, keys, cs.REPLICAS_K, *e), PREFIX)


def dx_cases(smoke, keys_np):
    """The DxHash entries' cases at a = 4·10^6 (:func:`dx_states`)."""
    dx = dict(dx_states(smoke))
    for name in ("stable", "one-shot"):
        yield ("dx_lookup", name,
               lambda keys, t=dx[name][:2]: engine.kernel_lookup("dx", keys, *t),
               lambda keys, t=dx[name][:2]: engine.lookup_plain("dx", keys, *t), PREFIX)
    for old, new in (("stable", "one-shot"), ("w=5*10^5", "w=5*10^5 + 1 removal"),
                     ("one-shot", "one-shot + 1 removal")):
        yield ("dx_diff", f"{old} -> {new}",
               lambda keys, e=(dx[old][:2], dx[new][:2]): engine.kernel_diff("dx", keys, *e),
               lambda keys, e=(dx[old][:2], dx[new][:2]): engine.diff_plain("dx", keys, *e),
               PREFIX)
    load, cap = _bounded_load(smoke, keys_np, dx["one-shot"][3], cs.N // 10)
    for name, k, ld, c in (("stable", cs.REPLICAS_K, None, None),
                           ("one-shot", cs.REPLICAS_K, None, None),
                           ("one-shot", cs.BOUNDED_K, load, cap)):
        args = (k, *dx[name][:2], ld, c)
        yield ("dx_replica", f"{name} {'bounded ' if ld is not None else ''}k={k}",
               lambda keys, a=args: engine.kernel_replica("dx", keys, *a),
               lambda keys, a=args: engine.replica_plain("dx", keys, *a), PREFIX)
    for old, new in (("stable", "one-shot"), ("w=5*10^5", "w=5*10^5 + 1 removal"),
                     ("one-shot", "one-shot + 1 removal")):
        e = (dx[old][:2], dx[new][:2])
        yield ("dx_replica_diff", f"{old} -> {new} k={cs.REPLICAS_K}",
               lambda keys, e=e: engine.kernel_replica_diff("dx", keys, cs.REPLICAS_K, *e),
               lambda keys, e=e: engine.replica_diff_plain("dx", keys, cs.REPLICAS_K, *e),
               PREFIX)
    probe = torch.zeros(cs.KEYS, dtype=torch.int32, device=smoke.dev)
    pending = torch.from_numpy(smoke.rng.random(cs.KEYS) < 0.5).to(smoke.dev)
    for name, working in (("stable", cs.N), ("one-shot", cs.N // 10)):
        walk = (*dx[name][:2], *_bounded_load(smoke, keys_np, dx[name][3], working))
        yield ("dx_walk", f"{name} cap={walk[3]}",
               lambda keys, w=walk: engine.kernel_walk("dx", keys, probe[:len(keys)],
                                                       pending[:len(keys)], *w),
               lambda keys, w=walk: engine.walk_plain("dx", keys, probe[:len(keys)],
                                                      pending[:len(keys)], *w), PREFIX)


def memento_cases(smoke, keys_np):
    """The Memento entries' cases on every packed state (:func:`packed_states`),
    their dense images (after 1024 removals only ``memento_compact_lookup``
    and ``memento_walk``, whose dense cases take the packed walk's lanes and
    their own image's ``bounded_assign`` load and cap), and the epoch pairs
    (:func:`packed_pairs`, and the dense n = 10^6 -> n - 1)."""
    states, dense = {}, {}
    for name, img, working, dense_img in packed_states(smoke):
        states[name] = img
        tables, scalars = engine.image_operands(img)
        if name == f"int32 {cs.PACKED_REMOVALS} removals":
            yield compact_lookup_case(name.split(" ", 1)[1], dense_img)
        elif dense_img is not None:
            dense[name] = engine.image_operands(dense_img)
            state = name.split(" ", 1)[1]
            for entry, ops, kw in (("memento_lookup", dense[name], {}),
                                   ("memento_packed_lookup", (tables, scalars),
                                    {"table": "packed"})):
                yield (entry, state,
                       lambda keys, o=ops, kw=kw: engine.kernel_lookup("memento", keys, *o, **kw),
                       lambda keys, o=ops, kw=kw: engine.lookup_plain("memento", keys, *o, **kw),
                       PREFIX)
            yield from memento_sets(smoke, keys_np, state, dense_img, working)
        load, cap = _bounded_load(smoke, keys_np, img, working)
        for k, ld, c in ((cs.REPLICAS_K, None, None), (cs.BOUNDED_K, load, cap)):
            args = (k, tables, scalars, ld, c)
            state = f"{name} {'bounded ' if ld is not None else ''}k={k}"
            yield ("memento_packed_replica", state,
                   lambda keys, a=args: engine.kernel_replica("memento", keys, *a, table="packed"),
                   lambda keys, a=args: engine.replica_plain("memento", keys, *a, table="packed"),
                   None)
        probe = torch.zeros(cs.KEYS, dtype=torch.int32, device=smoke.dev)
        pending = torch.from_numpy(smoke.rng.random(cs.KEYS) < 0.5).to(smoke.dev)
        walk = (tables, scalars, load, cap)
        yield ("memento_packed_walk", f"{name} cap={cap}",
               lambda keys, w=walk, p=probe, q=pending: engine.kernel_walk(
                   "memento", keys, p[:len(keys)], q[:len(keys)], *w, table="packed"),
               lambda keys, w=walk, p=probe, q=pending: engine.walk_plain(
                   "memento", keys, p[:len(keys)], q[:len(keys)], *w, table="packed"), None)
        if name.startswith("int32"):  # the dense walk on the same lanes
            walk = (*engine.image_operands(dense_img),
                    *_bounded_load(smoke, keys_np, dense_img, working))
            yield ("memento_walk", f"{name.split(' ', 1)[1]} cap={walk[3]}",
                   lambda keys, w=walk, p=probe, q=pending: engine.kernel_walk(
                       "memento", keys, p[:len(keys)], q[:len(keys)], *w),
                   lambda keys, w=walk, p=probe, q=pending: engine.walk_plain(
                       "memento", keys, p[:len(keys)], q[:len(keys)], *w), PREFIX)
    m = MementoHash(cs.N, variant="32")
    last = smoke.on_card(m.device_image())
    m.remove(cs.N - 1)
    pairs = [("stable -> one-shot", (dense["int32 stable"], dense["int32 one-shot"]), {}),
             ("n=10^6 -> last bucket removed",
              (engine.image_operands(last), engine.image_operands(smoke.on_card(
                  m.device_image()))), {})]
    pairs += [(name, (engine.image_operands(old), engine.image_operands(new)),
               {"table": "packed"}) for name, old, new in packed_pairs(smoke, states)]
    for state, epochs, kw in pairs:  # the k = 1 diffs
        yield (engine.kernel_name("memento", "diff", kw.get("table", "dense")), state,
               lambda keys, e=epochs, kw=kw: engine.kernel_diff("memento", keys, *e, **kw),
               lambda keys, e=epochs, kw=kw: engine.diff_plain("memento", keys, *e, **kw),
               PREFIX)
    for state, epochs, kw in pairs[:1] + pairs[2:]:  # the k = 3 diffs
        yield (engine.kernel_name("memento", "replica_diff", kw.get("table", "dense")),
               f"{state} k={cs.REPLICAS_K}",
               lambda keys, e=epochs, kw=kw: engine.kernel_replica_diff(
                   "memento", keys, cs.REPLICAS_K, *e, **kw),
               lambda keys, e=epochs, kw=kw: engine.replica_diff_plain(
                   "memento", keys, cs.REPLICAS_K, *e, **kw), PREFIX)


def anchor_sizes(smoke, keys_np, anchor):
    """``anchor_replica`` one-shot k = 3 at a = 10^6, 2·10^6 and (``anchor``'s
    state) 4·10^6, each with w = a/4 before a 90 % one-shot removal: the
    entry against its footprint (A and K, 8 bytes a bucket).  Logs each
    state's words a key (``chip_smoke.anchor_words`` of the plain counters
    on the first PREFIX keys), whose rate at the kernel's time each row
    gives."""
    states = []
    for a in (10**6, 2 * 10**6):
        h = make_hash("anchor", a // 4, capacity=a, variant="32")
        smoke.remove_fraction(h, cs.ONESHOT_FRACTION)
        states.append((f"a={a // 10**6}*10^6", smoke.operands(h)[:2]))
    states.append(("a=4*10^6", anchor["one-shot"][:2]))
    for label, (tables, scalars) in states:
        work: dict = {}
        engine.replica_plain("anchor", engine.key_tensor(keys_np[:PREFIX], smoke.dev),
                             cs.REPLICAS_K, tables, scalars, work=work)
        words = cs.anchor_words(work, PREFIX)
        print(f"anchor_replica one-shot k={cs.REPLICAS_K} {label}: {words / PREFIX:.4f} words "
              f"a key (plain counters, {PREFIX} keys), footprint "
              f"{sum(4 * t.numel() for t in tables) / 1e6:.1f} MB", flush=True)
        if label != "a=4*10^6":  # that state's case is shared_walk_sets'
            args = (cs.REPLICAS_K, tables, scalars, None, None)
            yield ("anchor_replica", f"one-shot k={cs.REPLICAS_K} {label}",
                   lambda keys, a=args: engine.kernel_replica("anchor", keys, *a),
                   lambda keys, a=args: engine.replica_plain("anchor", keys, *a), PREFIX)


#: power_diff's epoch pairs (n_old, n_new): stable -> one-shot (top levels
#: 19 -> 16), one removal at w = 10^6 and at one-shot's 10^5 (one level
#: each), the band crossing 2^17 + 1 -> 2^17, and one n twice
POWER_DIFF_PAIRS = ((cs.N, cs.N // 10), (cs.N, cs.N - 1), (cs.N // 10, cs.N // 10 - 1),
                    (2**17 + 1, 2**17), (cs.N, cs.N))


def power_cases(smoke, keys_np):
    """``power_lookup`` stable (w = 10^6) and one-shot (w = 10^5, 90 %
    removed), and ``power_diff`` on each pair of POWER_DIFF_PAIRS."""
    ops = {}
    for n in sorted({n for pair in POWER_DIFF_PAIRS for n in pair}):
        ops[n] = smoke.operands(make_hash("power", n, variant="32"))[:2]
    for name, n in (("stable", cs.N), ("one-shot", cs.N // 10)):
        yield ("power_lookup", f"{name} n={n}",
               lambda keys, t=ops[n]: engine.kernel_lookup("power", keys, *t),
               lambda keys, t=ops[n]: engine.lookup_plain("power", keys, *t), None)
    for old, new in POWER_DIFF_PAIRS:
        e = (ops[old], ops[new])
        yield ("power_diff", f"n={old} -> {new}",
               lambda keys, e=e: engine.kernel_diff("power", keys, *e),
               lambda keys, e=e: engine.diff_plain("power", keys, *e), None)


def anchor_and_shared_cases(smoke, keys_np):
    """The AnchorHash entries' cases and the other entries that share
    ``replica_row`` (:func:`anchor_cases`, :func:`shared_walk_sets`,
    :func:`anchor_sizes`), and PowerHash's lookup and diff
    (:func:`power_cases`)."""
    yield from power_cases(smoke, keys_np)
    anchor = dict(anchor_states(smoke))
    yield from anchor_cases(smoke, keys_np, anchor)
    yield from shared_walk_sets(smoke, keys_np, anchor)
    yield from anchor_sizes(smoke, keys_np, anchor)


def apply_case(smoke, dtype, length: int, idx, vals, label: str):
    """The case of ``dtype``'s delta apply of (idx, vals), deduplicated
    keep-last and padded as ``scatter_update`` does, into a random table of
    ``length`` elements on the card."""
    info = torch.iinfo(dtype)
    table = torch.from_numpy(smoke.rng.integers(info.min, info.max, size=length,
                                                endpoint=True)).to(dtype).to(smoke.dev)
    pidx, pval, count = da._pad_updates(*da.dedup_last(idx, vals), sentinel=-1)
    meta = torch.from_numpy(np.concatenate([pidx, pval])).to(smoke.dev)
    return (da.KERNELS[dtype],
            f"{label}: {count} updates into {length} {str(dtype).split('.')[1]} "
            f"({da.apply_form(length, dtype)})",
            lambda keys: da.delta_apply(table, meta, count),
            lambda keys: da.delta_apply_plain(table, meta, count), None)


def apply_cases(smoke, keys_np):
    """The delta applies' cases: each width at its path's shape
    (``chip_smoke.py``'s: 4096 updates, 512 of them repeated, into the
    2·10^6-word int32 store table; 8 draws into 128 int16 and int8 slots),
    then at every length of APPLY_LENGTHS with APPLY_SWEEP_UPDATES draws."""
    idx = smoke.rng.integers(0, cs.DELTA_TABLE, size=cs.DELTA_UPDATES)
    idx[-512:] = idx[:512]
    yield apply_case(smoke, torch.int32, cs.DELTA_TABLE, idx,
                     smoke.rng.integers(-1, cs.N, size=cs.DELTA_UPDATES), "path")
    for dtype in (torch.int16, torch.int8):
        yield apply_case(smoke, dtype, 128, smoke.rng.integers(0, 128, size=8),
                         smoke.rng.integers(-2, cs.TINY_N, size=8), "path")
    for dtype in (torch.int32, torch.int16, torch.int8):
        for length in APPLY_LENGTHS:
            yield apply_case(smoke, dtype, length,
                             smoke.rng.integers(0, length, size=APPLY_SWEEP_UPDATES),
                             smoke.rng.integers(-2, cs.TINY_N, size=APPLY_SWEEP_UPDATES),
                             "sweep")


#: each group of cases, and the entry prefixes it serves
GROUPS = ((dx_cases, ("dx_",)), (memento_cases, ("memento_",)),
          (anchor_and_shared_cases, ("anchor_", "jump_", "power_")),
          (apply_cases, ("delta_apply",)))


def cases(smoke, keys_np, only=None):
    """(entry, state, call, plain, check) for every case: ``call(keys)``
    runs the entry's public wrapper, ``plain(keys)`` its plain version,
    held on the first ``check`` keys (None: all).  A bounded set's load,
    and a walk's, is ``bounded_assign``'s of ``keys_np``; a walk has half
    its lanes pending.  Each group draws its states from its own seed, so
    they are the same whichever groups run; a group none of whose entries
    are in ``only`` is not built."""
    for g, (group, prefixes) in enumerate(GROUPS):
        if only is None or any(e.startswith(prefixes) for e in only):
            smoke.rng = np.random.default_rng(cs.SEED + 1 + g)
            yield from group(smoke, keys_np)


def _equal(a, b) -> bool:
    """Outputs equal: tensors, or tuples of them (a diff, a walk)."""
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _head(out, check):
    """The first ``check`` rows of an output or of each of its tensors."""
    return out[:check] if isinstance(out, torch.Tensor) else tuple(o[:check] for o in out)


def _kernel_lines(ptxas: str, names: list[str]) -> list[str]:
    """The ``ptxas -v`` lines (entry, registers, spills) of the kernels whose
    mangled names hold one of ``names``."""
    lines, keep = [], False
    for line in ptxas.splitlines():
        if "Compiling entry" in line:
            keep = any(n in line for n in names)
        if keep and ("Compiling entry" in line or "registers" in line or "spill" in line):
            lines.append(line.strip())
    return lines


def _exports(csrc: Path, entry: str) -> bool:
    """Whether the build of directory ``csrc`` has the C entry ``entry`` (a
    case of an entry that an older build lacks runs on the others)."""
    with using(csrc):
        return any(hasattr(build.load(name, sigs), entry)
                   for name, sigs in (("engine", engine._SIGNATURES),
                                      ("delta_apply", da._SIGNATURES)))


@contextlib.contextmanager
def using(csrc: Path):
    """Within the block, the wrappers run the SOURCES of directory ``csrc``."""
    with contextlib.ExitStack() as stack:
        for name in SOURCES:
            stack.enter_context(build.built_from(name, csrc / f"{name}.cu"))
        yield


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("ab_engine: no CUDA device", file=sys.stderr)
        return 2
    flags = ("--json", "--only", "--ptxas")
    dirs = [a for i, a in enumerate(argv[1:], 1)
            if not a.startswith("--") and argv[i - 1] not in flags]
    builds = {"old": Path(dirs[0]), **dict((label, Path(d)) for label, d in
                                           (a.split("=", 1) for a in dirs[1:])),
              "new": build.CSRC}
    out = Path(argv[argv.index("--json") + 1]) if "--json" in argv else None
    only = set(argv[argv.index("--only") + 1].split(",")) if "--only" in argv else None
    ptxas = argv[argv.index("--ptxas") + 1].split(",") if "--ptxas" in argv else []
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    t0 = time.perf_counter()
    for label, src in builds.items():
        with using(src):
            built = build.build(list(SOURCES))
        print(f"built {label} in " + ", ".join(f"{n} {b.seconds:.1f} s"
                                               for n, b in built.items()), flush=True)
        for line in _kernel_lines(built["engine"].ptxas, ptxas):
            print(f"  ptxas {label}: {line}", flush=True)
    print(f"all built in {time.perf_counter() - t0:.1f} s", flush=True)
    smoke = cs.Smoke(torch)
    keys_np, keys = smoke.keys()
    rows = []
    for entry, state, call, plain, check in cases(smoke, keys_np, only):
        if only is not None and entry not in only:
            continue
        runs = {label: src for label, src in builds.items() if _exports(src, entry)}
        got = {}
        for label, src in runs.items():
            with using(src):
                got[label] = call(keys)
        first = next(iter(got.values()))
        want = plain(keys[:check])
        for label, o in got.items():
            if not _equal(o, first) or not _equal(_head(o, check), want):
                raise AssertionError(f"{entry} {state}: {label} != {next(iter(got))} / plain")
        ms: dict = {label: [] for label in runs}
        for label in [*runs, *reversed(runs)]:
            with using(runs[label]):
                ms[label].append(smoke.time_ms(lambda: call(keys), reps=REPS))
        row = {"entry": entry, "state": state, "ms": ms}
        rows.append(row)
        print(json.dumps(row), flush=True)
    if out is not None:
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"device": smi, "rows": rows}, indent=1))
        print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
