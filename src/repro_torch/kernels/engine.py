"""The lookup engine of the port: batched lookups, k-replica sets,
bounded-load walks and epoch diffs of every algorithm on the device.

The reference runs every lookup-shaped operation as one configuration of
one Pallas kernel (``src/repro/kernels/engine.py``, :class:`EngineOp`).
This port serves every configuration, for all five algorithms and every
table layout, each as a CUDA kernel in ``csrc/engine.cu``:

  =========================================== ===========================
  configuration                               kernel
  =========================================== ===========================
  ``EngineOp(algo)``                          ``{algo}_lookup``: keys →
                                              buckets
  ``EngineOp(algo, diff=True)``               ``{algo}_diff``: buckets
                                              under two epochs and the
                                              moved mask, in one launch
  ``EngineOp(algo, k=k)``, ``bounded=True``   ``{algo}_replica``: k
                                              distinct buckets per key by
                                              the salted walk; bounded, the
                                              walk also skips buckets at or
                                              above a load cap
  ``EngineOp(algo, k=k, diff=True)``, k > 1   ``{algo}_replica_diff``:
                                              replica sets under two
                                              epochs, moved if any slot
                                              differs
  ``EngineOp(algo, mode="walk")``             ``{algo}_walk``: one
                                              bounded-load chain-walk step,
                                              the round of
                                              :func:`bounded_assign`
  =========================================== ===========================

Table layouts (``EngineOp.table``): ``"dense"``; ``"packed"``, the layout
of a ``packed=True`` image (:mod:`repro_torch.core.packing`), served in
every mode: Memento's bitmap and open-addressing slots by
``memento_packed_{mode}``, AnchorHash's narrowed A/K by
``anchor_packed_{mode}`` (both with a ``width`` argument of 1, 2 or 4
bytes), and DxHash, JumpHash and PowerHash, whose packed layout is their
dense one, by their dense kernels; and ``"compact"``, Memento's Θ(r)
open-addressing table built per call from a dense image, served in lookup
mode (the k = 1 lookup by ``memento_compact_lookup``, k-replica and
bounded sets by ``memento_compact_replica``; no diffs, no walks, as in the
reference).

Each kernel has a plain torch version beside it (:func:`lookup_plain`,
:func:`diff_plain`, :func:`replica_plain`, :func:`replica_diff_plain`,
:func:`walk_plain`, over the lane-synchronous bodies below, as the
reference writes them).  A wrapper takes the plain version only for
tensors on the CPU; for CUDA tensors it launches the kernel or raises.
``LAUNCHES`` counts the kernel launches, one entry per kernel.
"""
from __future__ import annotations

import ctypes
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.bounded import accept_in_index_order, walk_probe_bound
from repro_torch.core.hashing import GOLDEN32, MASK32
from repro_torch.core.packing import EMPTY, PACKED_LAYOUT, build_slots
from repro_torch.core.protocol import (ALGORITHM_REGISTRY, ALGORITHMS,
                                      IMAGE_LAYOUT, REPLICA_SALT_CAP,
                                      image_scalar_vec, required_lengths,
                                      round_up)
from repro_torch.device import resolve_device
from repro_torch.obs.metrics import default_registry as _obs_registry
from . import build
from .primitives import as_u32, fmix32, gather1d, hash2, jump32, power32

#: kernel modes: the number of tensor pointers before ``count``, the
#: mode's own arguments after it, and the epochs whose operands follow
_MODES = {
    "lookup": (2, [], 1),                                    # keys, out
    "diff": (4, [], 2),                                      # keys, old, new, moved
    "replica": (2, [ctypes.c_int, ctypes.c_void_p, ctypes.c_int], 1),  # k, load, cap
    "replica_diff": (4, [ctypes.c_int], 2),                  # k
    "walk": (6, [ctypes.c_void_p, ctypes.c_int, ctypes.c_int], 1),  # load, cap, max_probe
}

#: algorithms whose packed tables differ from their dense ones, so their
#: packed images run kernels of their own (``{algo}_packed_{mode}``)
PACKED_KERNELS = ("memento", "anchor")

#: every kernel: its C entry → (algo, mode, table layout)
KERNELS: dict[str, tuple[str, str, str]] = {
    **{f"{a}_{m}": (a, m, "dense") for a in ALGORITHMS for m in _MODES},
    **{f"{a}_packed_{m}": (a, m, "packed") for a in PACKED_KERNELS for m in _MODES},
    **{f"memento_compact_{m}": ("memento", m, "compact") for m in ("lookup", "replica")},
}

#: kernel launches per kernel since the last reset (set the values to 0)
LAUNCHES: dict[str, int] = {name: 0 for name in KERNELS}

_P, _N, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int

#: the walk's probe bound 64·L + 64 stays below 2**31 for loads shorter
#: than this
MAX_WALK_LOAD = 2**25

#: element types of narrowed tables (packed slots, packed A/K)
_NARROW = (torch.int8, torch.int16, torch.int32)


def table_names(algo: str, table: str = "dense") -> tuple[str, ...]:
    """An epoch's kernel tables in operand order, for a table layout."""
    if table == "compact":
        return ("slot_b", "slot_c")
    return (PACKED_LAYOUT if table == "packed" else IMAGE_LAYOUT)[algo][1]


def kernel_name(algo: str, mode: str, table: str = "dense") -> str:
    """The C entry serving ``algo`` in ``mode`` over a table layout."""
    if table == "compact":
        return f"memento_compact_{mode}"
    if table == "packed" and algo in PACKED_KERNELS:
        return f"{algo}_packed_{mode}"
    return f"{algo}_{mode}"


def _layout_ints(algo: str, table: str) -> tuple[str, ...]:
    """The ints that follow an epoch's table pointers before its scalars:
    the slot count of a compact table; the element width in bytes and the
    slot count of packed Memento slots; the width of packed A/K."""
    if table == "compact":
        return ("nslots",)
    if table == "packed" and algo in PACKED_KERNELS:
        return ("width", "nslots") if algo == "memento" else ("width",)
    return ()


def _signature(algo: str, mode: str, table: str) -> list:
    """The C entry's argtypes: the tensors, the count, the mode's own
    arguments, then each epoch's table pointers, layout ints and scalars
    in registry order, then the stream."""
    epoch = ([_P] * len(table_names(algo, table)) + [_I] * len(_layout_ints(algo, table))
             + [_I] * len(ALGORITHM_REGISTRY[algo].scalars))
    ptrs, extra, epochs = _MODES[mode]
    return [_P] * ptrs + [_N] + extra + epoch * epochs + [_P]


_SIGNATURES = {name: _signature(*entry) for name, entry in KERNELS.items()}


@dataclass(frozen=True)
class EngineOp:
    """Static engine configuration, checked as the reference checks it.

    * ``algo``    — a name in :data:`ALGORITHMS`,
    * ``mode``    — "lookup" or "walk",
    * ``k``       — replica slots per key,
    * ``bounded`` — lookup mode: skip buckets at or above a load cap,
    * ``diff``    — lookup mode: run under two epoch images at once,
    * ``table``   — "dense", "packed" (a ``packed=True`` image; any
      algorithm, any mode) or "compact" (Memento only, lookup mode).

    A configuration the reference rejects raises ``ValueError``.
    """

    algo: str
    mode: str = "lookup"
    k: int = 1
    bounded: bool = False
    diff: bool = False
    table: str = "dense"

    def __post_init__(self):
        if self.algo not in ALGORITHMS:
            raise ValueError(f"unknown algo {self.algo!r}")
        if self.mode not in ("lookup", "walk"):
            raise ValueError(f"unknown mode {self.mode!r}")
        if self.k < 1:
            raise ValueError("k must be ≥ 1")
        if self.mode == "walk" and (self.k != 1 or self.diff or self.bounded):
            raise ValueError("walk mode is k=1, no diff, cap-implicit")
        if self.table not in ("dense", "compact", "packed"):
            raise ValueError(f"unknown table kind {self.table!r}")
        if self.table == "compact" and self.algo != "memento":
            raise ValueError("compact tables are Memento-only")
        if self.table == "compact" and (self.diff or self.mode == "walk"):
            raise ValueError("compact tables serve lookup mode only")

    @property
    def table_names(self) -> tuple[str, ...]:
        return table_names(self.algo, self.table)


def op_tag(op: EngineOp) -> str:
    """Stable textual identity of an :class:`EngineOp` (the reference's
    ``autotune.op_tag``), e.g. ``memento.lookup.k1.dense``: the ``op``
    label of the ``engine.dispatch.us`` histogram."""
    tag = f"{op.algo}.{op.mode}.k{op.k}"
    if op.bounded:
        tag += ".bounded"
    if op.diff:
        tag += ".diff"
    return f"{tag}.{op.table}"


def _obs_dispatch(reg, op: EngineOp, n_keys: int, t0_ns: int) -> None:
    """Fold one engine dispatch into the live telemetry registry: the
    dispatches served, their keys, the batch-size distribution, and the
    host time of the call a :func:`op_tag` (on the card, its dispatch
    time: nothing here waits for the device).  One API call is one
    dispatch, whatever kernels it launches."""
    reg.counter("engine.dispatches").inc()
    reg.counter("engine.keys").inc(n_keys)
    reg.histogram("engine.batch_keys").observe(n_keys)
    reg.histogram("engine.dispatch.us", op=op_tag(op)).observe(
        (time.perf_counter_ns() - t0_ns) / 1e3)


# ---------------------------------------------------------------------------
# Plain torch versions (lane-synchronous, like the reference's bodies).
# Keys are int64-carried uint32 words; every body returns int64 buckets.
# ``work``, if given, counts the lane-iterations the batch needed (what
# chip_smoke.py's bounds read).
# ---------------------------------------------------------------------------

def _count(work: dict | None, name: str, lanes) -> None:
    if work is not None:
        work[name] = work.get(name, 0) + int(lanes)


def memento_body(keys: torch.Tensor, read, n: int,
                 work: dict | None = None) -> torch.Tensor:
    """Paper Alg. 4 over a table reader ``read(idx) -> repl[idx]`` (−1 =
    working).  Lanes are evaluated only while they walk, so ``read`` sees
    the reads the reference's loop makes.  The kernel makes one fewer a
    pass, taking the chain's last read of repl(d) as the next pass's, so
    that read is left out of ``work`` (a reader's counters), which gains
    ``"step"`` (jump32 steps), ``"outer"`` (Alg. 4 iterations) and
    ``"read"`` (chain reads): the reads the kernel makes."""
    b = jump32(keys, n, work)
    c = read(b)
    act = torch.nonzero(c >= 0).reshape(-1)
    wb = c[act].clamp_min(1)  # a valid image never holds 0
    while act.numel():
        _count(work, "outer", act.numel())
        d = hash2(keys[act], b[act]) % wb
        u = read(d)
        follow = torch.nonzero(u >= wb).reshape(-1)  # follow only while u ≥ w_b
        while follow.numel():
            _count(work, "read", follow.numel())
            d[follow] = u[follow]
            u[follow] = read(d[follow])
            follow = follow[u[follow] >= wb[follow]]
        b[act] = d
        kept = None if work is None else dict(work)
        c = read(d)  # == u, which the kernel takes: not counted
        if kept is not None:
            work.clear()
            work.update(kept)
        keep = c >= 0
        act, wb = act[keep], c[keep].clamp_min(1)
    return b


def dense_body(keys: torch.Tensor, repl: torch.Tensor, n: int,
               work: dict | None = None) -> torch.Tensor:
    """Memento over the dense repl table."""
    return memento_body(keys, lambda idx: gather1d(repl, idx), n, work)


def _probe(idx: torch.Tensor, lanes: torch.Tensor, slot_b: torch.Tensor,
           slot_c: torch.Tensor, stop, work: dict | None) -> torch.Tensor:
    """``repl[idx]`` read from an open-addressing table for the ``lanes``
    of ``idx`` (−1, working, for every other lane): linear probing from
    ``fmix32(idx·GOLDEN32 + 5) & mask`` until ``slot_b`` holds idx (→
    ``slot_c``) or ``stop(slot_b)``, at most ``len(slot_b)`` slots (a
    valid image has an empty slot long before).  Slot words of any width
    widen at the gather.  ``work`` gains ``"start"`` (probes started) and
    ``"slot"`` (slots read)."""
    val = torch.full_like(idx, -1)
    mask = slot_b.numel() - 1
    want = idx[lanes]
    pos = fmix32(want * GOLDEN32 + 5) & mask
    _count(work, "start", lanes.numel())
    for _ in range(slot_b.numel()):
        if not lanes.numel():
            break
        _count(work, "slot", lanes.numel())
        sb = gather1d(slot_b, pos)
        hit = sb == want
        val[lanes[hit]] = gather1d(slot_c, pos[hit])
        go = ~(hit | stop(sb))
        lanes, want, pos = lanes[go], want[go], (pos[go] + 1) & mask
    return val


def compact_reader(slot_b: torch.Tensor, slot_c: torch.Tensor,
                   work: dict | None = None):
    """``read(idx)`` over the Θ(r) open-addressing table: every read
    probes, and any negative slot ends the probe (K1g)."""
    def read(idx):
        lanes = torch.arange(idx.numel(), device=idx.device)
        return _probe(idx, lanes, slot_b, slot_c, lambda sb: sb < 0, work)

    return read


def packed_reader(state: torch.Tensor, slot_b: torch.Tensor, slot_c: torch.Tensor,
                  work: dict | None = None):
    """``read(idx)`` over the packed Memento image (K1b): a set bit of the
    ``state`` bitmap (int32 bit patterns of uint32 words) means working,
    with no probe; a removed bucket probes the slots and stops only on
    EMPTY, so the TOMBSTONEs that restores leave keep a chain going.
    ``work`` gains ``"bit"`` (bitmap words read)."""
    def read(idx):
        _count(work, "bit", idx.numel())
        word = gather1d(state, idx >> 5) & MASK32
        lanes = torch.nonzero(((word >> (idx & 31)) & 1) == 0).reshape(-1)
        return _probe(idx, lanes, slot_b, slot_c, lambda sb: sb == EMPTY, work)

    return read


def anchor_body(keys: torch.Tensor, A: torch.Tensor, K: torch.Tensor, a: int,
                work: dict | None = None) -> torch.Tensor:
    """AnchorHash: start at ``fmix32(key) % a``; while ``A[b] > 0`` draw
    ``h = hash2(key, b) % A[b]`` and follow ``K[h]`` while ``A[h] ≥ A[b]``.
    ``work`` gains ``"outer"`` (removed buckets met) and ``"read"``
    (successor reads)."""
    b = fmix32(keys) % a
    return _anchor_walk(keys, A, K, b, gather1d(A, b), 1, work)[0]


def _anchor_walk(keys, A, K, b, Ab, removed: int, work: dict | None,
                 lanes: torch.Tensor | None = None):
    """AnchorHash's walk of ``keys`` from buckets ``b`` (``Ab = A[b]``)
    while ``A[b] ≥ removed`` (lanes in the mask ``lanes`` only, if given):
    the buckets where it stops and their A."""
    active = Ab >= removed if lanes is None else lanes & (Ab >= removed)
    while bool(active.any()):
        if work is not None:
            work["outer"] = work.get("outer", 0) + int(active.sum())
        h = hash2(keys, b) % torch.where(active, Ab, 1)
        follow = active & (gather1d(A, h) >= Ab)  # removed at or after b
        while bool(follow.any()):
            if work is not None:
                work["read"] = work.get("read", 0) + int(follow.sum())
            h = torch.where(follow, gather1d(K, h), h)
            follow = active & (gather1d(A, h) >= Ab)
        b = torch.where(active, h, b)
        Ab = torch.where(active, gather1d(A, b), Ab)
        active = active & (Ab >= removed)
    return b, Ab


#: ``anchor_nest_plain``'s verdicts, as ``anchor_nest_kernel`` writes them:
#: the epochs do not nest, the older one is the shallower, the newer one is
NEST_NONE, NEST_OLD_SHALLOW, NEST_NEW_SHALLOW = 0, 1, 2
#: int32 words of the check's per-call workspace (``NestWork``, kNestWords):
#: the ``moved`` of each of ``NEST_KERNELS`` carries them past its count,
#: its first two the verdict and N_S
NEST_WORDS = 201
#: the diff entries that run the check, then a pair kernel
NEST_KERNELS = ("anchor_packed_diff", "anchor_replica_diff", "anchor_packed_replica_diff")
#: the largest a of the parted check (kNestBlockMax: one bucket a thread,
#: no memset), which reads both epochs' A and K in full; above it the
#: check's grid reads the Ks only where an epoch removed the bucket
NEST_BLOCK_MAX = 2**15


def anchor_nest_plain(old, new) -> tuple[int, int]:
    """Plain version of the check of the AnchorHash diffs in
    ``NEST_KERNELS`` (``anchor_nest_kernel``, ``anchor_nest_part_kernel``)
    over two AnchorHash epochs, each ``(tables, scalars)``, dense or packed
    (A and K of any width, read up to a): whether one epoch S removed only
    buckets the other D also removed, with equal A and K, and D stamped
    every other bucket below S's working count N_S = min(a, the least
    positive A of S) → (verdict, N_S), N_S 0 with ``NEST_NONE``.  Two equal
    epochs give the older one as S; epochs of two a do not nest.  A model
    for the tests: the card runs the kernel."""
    (A_o, K_o), (A_n, K_n) = old[0][:2], new[0][:2]
    a = int(old[1][0])
    if a != int(new[1][0]):
        return NEST_NONE, 0
    A_o, K_o, A_n, K_n = (t[:a].long() for t in (A_o, K_o, A_n, K_n))
    verdict, n_shallow = NEST_NONE, 0
    for v, (AS, KS, AD, KD) in ((NEST_NEW_SHALLOW, (A_n, K_n, A_o, K_o)),
                                (NEST_OLD_SHALLOW, (A_o, K_o, A_n, K_n))):
        pos = AS > 0
        least = int(AS[pos].min()) if bool(pos.any()) else 2**31 - 1
        n = min(a, least)
        most = int(AD[~pos].max()) if bool((~pos).any()) else -2**31
        differs = bool(((AD != AS) | (KD != KS))[pos].any())
        if not differs and most < n:
            verdict, n_shallow = v, n
    return verdict, n_shallow


def anchor_nested_plain(keys: torch.Tensor, A: torch.Tensor, K: torch.Tensor, a: int,
                        n_shallow: int, deep: torch.Tensor | None = None,
                        work: dict | None = None):
    """Plain version of ``anchor_nested``: both lookups of int64-carried
    uint32 ``keys`` under two nesting AnchorHash epochs (``anchor_nest_plain``)
    on one walk through the deeper epoch's ``A`` and ``K``.  The walk's
    first bucket with ``A < n_shallow`` is the shallower epoch's lookup; the
    lanes of the mask ``deep`` (default all) walk on while ``A > 0`` to the
    deeper epoch's.  Returns int64 (shallower, deeper), the deeper equal to
    the shallower on the other lanes.  ``work`` counts the one walk."""
    b = fmix32(keys) % a
    b, Ab = _anchor_walk(keys, A, K, b, gather1d(A, b), max(1, n_shallow), work)
    return b, _anchor_walk(keys, A, K, b, Ab, 1, work, deep)[0]


def anchor_pair_diff_plain(keys: torch.Tensor, old, new, work: dict | None = None):
    """A model of ``anchor_packed_diff``'s kernels: the check
    (``anchor_nest_plain``), then, for nesting epochs, both lookups of every
    key on one ``anchor_nested_plain`` walk through the deeper epoch's
    tables; epochs that do not nest take ``diff_plain``.  → (old, new,
    moved), as ``diff_plain`` gives them.  ``work`` counts ``"lookups"``
    (keys looked up, once for both epochs) and the walk's ``"outer"`` and
    ``"read"``.  A model for the tests and ``chip_smoke.py``'s bound: the
    card runs the kernel."""
    verdict, n_shallow = anchor_nest_plain(old, new)
    if verdict == NEST_NONE:
        return diff_plain("anchor", keys, old, new, work)
    A, K = (new if verdict == NEST_OLD_SHALLOW else old)[0][:2]
    keys = as_u32(keys)
    shallow, deep = anchor_nested_plain(keys, A, K, int(old[1][0]), n_shallow, work=work)
    _count(work, "lookups", keys.numel())
    o, n = (t.to(torch.int32) for t in ((shallow, deep) if verdict == NEST_OLD_SHALLOW
                                        else (deep, shallow)))
    return o, n, o != n


def anchor_pair_replica_diff_plain(keys: torch.Tensor, k: int, old, new,
                                   work: dict | None = None):
    """A model of ``anchor_replica_diff``'s and ``anchor_packed_replica_diff``'s
    kernels (A and K of any width): the check
    (``anchor_nest_plain``), then, for nesting epochs, both epochs' unbounded
    k-slot rows on one salt walk, each salt's candidate key (salt 0 the key
    itself) looked up in both by one ``anchor_nested_plain`` walk through the
    deeper epoch's tables, which stops at the shallower answer on lanes only
    the shallower row still needs; each row fills as ``replica_body``'s
    (salt s at its s-th try, a bucket of an earlier slot rejected, the
    first lookup in every slot a row's salts leave open).  Epochs that do
    not nest take ``replica_diff_plain``.  → (old [K, k], new [K, k],
    moved), as ``replica_diff_plain`` gives them.  ``work`` counts
    ``"lookups"`` (keys looked up: each salt drawn once), ``"try"``
    (salted keys drawn), ``"try_shallow"`` and ``"try_deep"`` (the salted
    tries of each row, as ``replica_body`` counts an epoch's), and the
    walks' ``"outer"`` and ``"read"``.  A model for the tests and
    ``chip_smoke.py``'s bound: the card runs the kernel."""
    verdict, n_shallow = anchor_nest_plain(old, new)
    if verdict == NEST_NONE:
        return replica_diff_plain("anchor", keys, k, old, new)
    A, K = (new if verdict == NEST_OLD_SHALLOW else old)[0][:2]
    a = int(old[1][0])
    keys = as_u32(keys)
    firsts = anchor_nested_plain(keys, A, K, a, n_shallow, work=work)
    _count(work, "lookups", keys.numel())
    rows = [f[:, None].repeat(1, k) for f in firsts]
    filled = [torch.ones_like(keys) for _ in firsts]
    slots = torch.arange(k, device=keys.device)
    for salt in range(1, REPLICA_SALT_CAP + 1):
        wants = [f < k for f in filled]
        idx = torch.nonzero(wants[0] | wants[1]).reshape(-1)
        if not idx.numel():
            break
        cand = hash2(keys[idx], salt)
        got = anchor_nested_plain(cand, A, K, a, n_shallow, wants[1][idx], work)
        _count(work, "lookups", idx.numel())
        _count(work, "try", idx.numel())
        for row, fill, want, b, role in zip(rows, filled, wants, got, ("shallow", "deep")):
            sub = want[idx]
            _count(work, f"try_{role}", sub.sum())
            lanes, b = idx[sub], b[sub]
            j = fill[lanes]
            taken = ((row[lanes] == b[:, None]) & (slots < j[:, None])).any(dim=1)
            lanes, j, b = lanes[~taken], j[~taken], b[~taken]
            row[lanes, j] = b
            fill[lanes] += 1
    o, n = (r.to(torch.int32) for r in (rows if verdict == NEST_OLD_SHALLOW else rows[::-1]))
    return o, n, (o != n).any(dim=1)


def dx_body(keys: torch.Tensor, words: torch.Tensor, a: int, max_probes: int,
            fallback: int, work: dict | None = None) -> torch.Tensor:
    """DxHash: probe ``hash2(key, i) % a`` in the bitmap for ``i <
    max_probes``; a lane that finds no working bucket returns
    ``fallback``.  ``work`` gains ``"probe"`` (probes made)."""
    b = torch.zeros(keys.shape, dtype=torch.int64, device=keys.device)
    found = torch.zeros(keys.shape, dtype=torch.bool, device=keys.device)
    i = 0
    while i < max_probes and not bool(found.all()):
        if work is not None:
            work["probe"] = work.get("probe", 0) + int((~found).sum())
        cand = hash2(keys, i) % a
        word = gather1d(words, cand >> 5) & MASK32
        hit = ~found & (((word >> (cand & 31)) & 1) == 1)
        b = torch.where(hit, cand, b)
        found = found | hit
        i += 1
    return torch.where(found, b, fallback)


#: algorithm → plain body over (keys, tables, scalars, work); one per line
_BODIES = {
    "memento": lambda k, t, s, w: dense_body(k, t[0], s[0], w),
    "anchor": lambda k, t, s, w: anchor_body(k, t[0], t[1], s[0], w),
    "dx": lambda k, t, s, w: dx_body(k, t[0], s[0], s[1], s[2], w),
    "jump": lambda k, t, s, w: jump32(k, s[0], w),
    "power": lambda k, t, s, w: power32(k, s[0], w),
}


def _body(algo: str, table: str = "dense"):
    """The plain body of ``algo`` over a table layout.  Packed AnchorHash
    needs no body of its own: ``gather1d`` widens narrowed A/K."""
    if algo == "memento" and table == "packed":
        return lambda k, t, s, w: memento_body(k, packed_reader(t[0], t[1], t[2], w), s[0], w)
    if algo == "memento" and table == "compact":
        return lambda k, t, s, w: memento_body(k, compact_reader(t[0], t[1], w), s[0], w)
    return _BODIES[algo]


def lookup_plain(algo: str, keys: torch.Tensor, tables, scalars,
                 work: dict | None = None, *, table: str = "dense") -> torch.Tensor:
    """Plain version of the ``{algo}_lookup`` kernel (of
    ``kernel_name(algo, "lookup", table)``): int32 keys (uint32 bit
    patterns) → int32 buckets, on the keys' device."""
    return _body(algo, table)(as_u32(keys), list(tables), list(scalars),
                              work).to(torch.int32)


def diff_plain(algo: str, keys: torch.Tensor, old, new, work: dict | None = None, *,
               table: str = "dense"):
    """Plain version of the ``{algo}_diff`` kernel: ``old``/``new`` are
    ``(tables, scalars)`` of the two epochs → (old, new, moved).  ``work``
    counts both lookups."""
    o = lookup_plain(algo, keys, *old, work, table=table)
    n = lookup_plain(algo, keys, *new, work, table=table)
    return o, n, o != n


def replica_body(keys: torch.Tensor, k: int, single_lookup, load=None, cap=None,
                 work: dict | None = None) -> list[torch.Tensor]:
    """k distinct buckets a lane by the salted walk; with ``load``/``cap``
    the walk also rejects buckets at or above the cap.

    The candidate at salt 0 is the plain lookup ``first``, salt s ≥ 1
    looks up ``hash2(key, s)``; the lane's salt counter advances on every
    try, accepted or not, and carries across slots, so the walk equals the
    host's ``lookup_k_filtered``.  Unbounded, slot 0 is ``first``,
    accepted outside the loop, and the salt starts at 1; bounded, slot 0
    walks too from salt 0.  A lane stays in a slot's loop while its salt
    is at most ``REPLICA_SALT_CAP``; a slot that exhausts the budget keeps
    ``first``.  Lanes are evaluated only while they are still walking,
    which gives every lane the reference's value.  Returns k int64
    tensors.  ``work`` gains ``"lookups"`` (lane lookups), ``"try"``
    (candidates examined) and ``"compare"`` (duplicate compares)."""
    first = single_lookup(keys)
    _count(work, "lookups", keys.numel())
    if load is None:
        if k == 1:
            return [first]
        outs, start = [first], 1
    else:
        outs, start = [], 0
    salt = torch.full(keys.shape, start, dtype=torch.int64, device=keys.device)
    for _ in range(k - len(outs)):
        slot = first.clone()
        idx = torch.nonzero(salt <= REPLICA_SALT_CAP).reshape(-1)
        while idx.numel():
            s = salt[idx]
            cand = first[idx].clone()
            salted = s > 0  # only a bounded lane sits at salt 0
            sub = idx[salted]
            if sub.numel():
                cand[salted] = single_lookup(hash2(keys[sub], s[salted]))
                _count(work, "lookups", sub.numel())
            bad = torch.zeros(cand.shape, dtype=torch.bool, device=keys.device)
            for o in outs:
                bad |= cand == o[idx]
            if load is not None:
                bad |= gather1d(load, cand) >= cap
            _count(work, "try", idx.numel())
            _count(work, "compare", idx.numel() * len(outs))
            salt[idx] = s + 1
            slot[idx[~bad]] = cand[~bad]
            idx = idx[bad & (s + 1 <= REPLICA_SALT_CAP)]
        outs.append(slot)
    return outs


def chain_walk_body(chain: torch.Tensor, probe: torch.Tensor, pending: torch.Tensor,
                    load: torch.Tensor, cap: int, single_lookup,
                    work: dict | None = None):
    """One bounded-load chain-walk step: ``b = lookup(chain)`` for every
    lane; a pending lane then steps ``probe += 1; chain = hash2(chain,
    probe); b = lookup(chain)`` while ``load[b] ≥ cap`` and ``probe <
    walk_probe_bound(len(load))``.  Non-pending lanes keep their chain and
    probe.  Returns int64 ``(b, chain, probe)``.  ``work`` gains
    ``"lookups"`` (lane lookups) and ``"walk"`` (steps taken)."""
    max_probe = walk_probe_bound(load.shape[0])
    chain, probe = chain.clone(), probe.clone()
    b = single_lookup(chain)
    _count(work, "lookups", chain.numel())
    idx = torch.nonzero(pending & (gather1d(load, b) >= cap)
                        & (probe < max_probe)).reshape(-1)
    while idx.numel():
        p = probe[idx] + 1
        c = hash2(chain[idx], p)
        nb = single_lookup(c)
        _count(work, "lookups", idx.numel())
        _count(work, "walk", idx.numel())
        probe[idx], chain[idx], b[idx] = p, c, nb
        idx = idx[(gather1d(load, nb) >= cap) & (p < max_probe)]
    return b, chain, probe


def _as_i32(x: torch.Tensor) -> torch.Tensor:
    """int64-carried uint32 words → their int32 bit patterns."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def replica_plain(algo: str, keys: torch.Tensor, k: int, tables, scalars, load=None,
                  cap=None, work: dict | None = None, *, table: str = "dense") -> torch.Tensor:
    """Plain version of the ``{algo}_replica`` kernel: int32 keys → int32
    replica sets [K, k], column 0 the plain lookup (unbounded)."""
    tables, scalars, body = list(tables), list(scalars), _body(algo, table)
    outs = replica_body(as_u32(keys), k, lambda kk: body(kk, tables, scalars, work),
                        load, cap, work)
    return torch.stack(outs, dim=1).to(torch.int32)


def replica_diff_plain(algo: str, keys: torch.Tensor, k: int, old, new,
                       work: dict | None = None, *, table: str = "dense"):
    """Plain version of the ``{algo}_replica_diff`` kernel: replica sets
    under the epochs ``old`` and ``new`` (each ``(tables, scalars)``) →
    (old [K, k], new [K, k], moved: any slot differs).  ``work`` counts
    both epochs."""
    o = replica_plain(algo, keys, k, *old, work=work, table=table)
    n = replica_plain(algo, keys, k, *new, work=work, table=table)
    return o, n, (o != n).any(dim=1)


def walk_plain(algo: str, chain: torch.Tensor, probe: torch.Tensor,
               pending: torch.Tensor, tables, scalars, load: torch.Tensor, cap: int,
               work: dict | None = None, *, table: str = "dense"):
    """Plain version of the ``{algo}_walk`` kernel: int32 chain (uint32
    bit patterns), int32 probe, bool pending → int32 (b, chain, probe)."""
    tables, scalars, body = list(tables), list(scalars), _body(algo, table)
    b, ch, pr = chain_walk_body(as_u32(chain), probe.to(torch.int64), pending, load,
                                cap, lambda kk: body(kk, tables, scalars, work), work)
    return b.to(torch.int32), _as_i32(ch), pr.to(torch.int32)


def memento_lookup_plain(keys: torch.Tensor, repl: torch.Tensor, n: int,
                         work: dict | None = None) -> torch.Tensor:
    """Plain version of the ``memento_lookup`` kernel."""
    return lookup_plain("memento", keys, [repl], [n], work)


def memento_diff_plain(keys: torch.Tensor, repl_old: torch.Tensor, n_old: int,
                       repl_new: torch.Tensor, n_new: int):
    """Plain version of the ``memento_diff`` kernel: (old, new, moved)."""
    return diff_plain("memento", keys, ([repl_old], [n_old]), ([repl_new], [n_new]))


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check_vector(t: torch.Tensor, like: torch.Tensor, dtype, what: str,
                  length: int | None = None) -> None:
    """Raise unless ``t`` is a contiguous 1-D ``dtype`` tensor on
    ``like``'s device (of ``length`` elements, if given)."""
    if t.device != like.device:
        raise ValueError(f"{what} on {t.device}, keys on {like.device}")
    if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous 1-D {dtype} tensor")
    if length is not None and t.numel() != length:
        raise ValueError(f"{what} has {t.numel()} elements, not {length}")


def _check_layout(algo: str, table: str, keys: torch.Tensor, tables, n: int) -> None:
    """Raise unless an epoch's tables are what the layout's kernel reads:
    int32 dense tables long enough for ``n``; compact slots int32 and
    packed slots int8/int16/int32, a power of two in length, the two of
    one dtype and length, behind a ``state`` bitmap of at least ⌈n/32⌉
    int32 words; packed A/K of one dtype, int8/int16/int32, at least
    ``n`` long."""
    names = table_names(algo, table)
    if table == "dense" or (table == "packed" and algo not in PACKED_KERNELS):
        need = required_lengths(algo, n)
        for name, t in zip(names, tables):
            _check_vector(t, keys, torch.int32, name)
            if t.numel() < need[name]:
                raise ValueError(f"n={n} needs {name} of {need[name]} words, "
                                 f"not {t.numel()}")
        return
    if table == "packed" and algo == "memento":
        _check_vector(tables[0], keys, torch.int32, "state")
        if tables[0].numel() < -(-n // 32):
            raise ValueError(f"n={n} needs {-(-n // 32)} state words, "
                             f"not {tables[0].numel()}")
        tables = tables[1:]
    dtype = tables[0].dtype
    if dtype not in ((torch.int32,) if table == "compact" else _NARROW):
        raise ValueError(f"{names[-1]} of {dtype}: the {table} layout takes "
                         f"{'int32' if table == 'compact' else 'int8, int16 or int32'}")
    for name, t in zip(names[-2:], tables):
        _check_vector(t, keys, dtype, name, tables[0].numel())
    count = tables[0].numel()
    if algo == "anchor" and count < n:
        raise ValueError(f"n={n} needs A and K of {n} words, not {count}")
    if algo == "memento" and (count < 1 or count & (count - 1)):
        raise ValueError(f"{count} slots: not a power of two")


def _check_operands(algo: str, keys: torch.Tensor, epochs, table: str = "dense") -> None:
    """Raise on what the kernels do not take: keys must be contiguous 1-D
    int32; each epoch's tables contiguous 1-D tensors on the keys' device
    that the layout's kernel reads (:func:`_check_layout`); scalars in
    range."""
    if keys.dtype != torch.int32 or keys.dim() != 1 or not keys.is_contiguous():
        raise ValueError("keys must be a contiguous 1-D int32 tensor")
    if keys.numel() >= 2**31:
        raise ValueError("at most 2**31 - 1 keys per launch")
    if table not in ("dense", "packed", "compact") or (
            table == "compact" and algo != "memento"):
        raise ValueError(f"no {table!r} table layout for {algo!r}")
    names = table_names(algo, table)
    scalar_names = ALGORITHM_REGISTRY[algo].scalars
    for tables, scalars in epochs:
        n = scalars[0]
        if not 1 <= n < 2**31:
            raise ValueError(f"n={n} outside [1, 2**31)")
        if len(tables) != len(names) or len(scalars) != len(scalar_names):
            raise ValueError(f"{algo} ({table}) takes tables {names} and scalars "
                             f"{scalar_names}")
        _check_layout(algo, table, keys, tables, n)
        if algo == "dx" and not (scalars[1] >= 0 and 0 <= scalars[2] < n):
            raise ValueError(f"dx scalars max_probes={scalars[1]}, "
                             f"fallback={scalars[2]} out of range")


def _load_len(algo: str, tables, n: int, table: str = "dense") -> int:
    """Load words that cover ``algo``'s bucket ids: the length of the
    bucket-indexed table for Memento and AnchorHash (32 ids a bitmap word
    for packed Memento; ``n`` for a compact table, whose slots are not
    bucket-indexed), the 128-padded id space for the others (Dx packs
    bits, Jump and Power have no table)."""
    if table == "compact":
        return n
    if algo == "memento" and table == "packed":
        return 32 * int(tables[0].numel())
    if algo in ("memento", "anchor"):
        return int(tables[0].numel())
    return round_up(n)


def _check_load(algo: str, keys: torch.Tensor, tables, scalars, load: torch.Tensor,
                cap, table: str = "dense") -> None:
    """Raise unless ``load`` is a contiguous 1-D int32 tensor on the keys'
    device covering every bucket id (a short one would be read out of
    bounds on the card) and ``cap`` an int32."""
    _check_vector(load, keys, torch.int32, "load")
    need = _load_len(algo, tables, scalars[0], table)
    if load.numel() < need:
        raise ValueError(f"load has {load.numel()} words, the image needs {need}")
    if cap is None or not -2**31 <= int(cap) < 2**31:
        raise ValueError(f"cap={cap} is not an int32")


def _epoch_args(algo: str, table: str, tables, scalars) -> list[int]:
    """One epoch's kernel arguments: table pointers, the layout's ints
    (:func:`_layout_ints`, read off the last table: ``slot_c`` or ``K``),
    then the scalars."""
    ints = {"width": lambda t: t.element_size(), "nslots": lambda t: t.numel()}
    return ([t.data_ptr() for t in tables]
            + [ints[name](tables[-1]) for name in _layout_ints(algo, table)]
            + [int(s) for s in scalars])


def _launch(algo: str, mode: str, table: str, tensors, count: int, mode_args,
            epochs) -> None:
    """Launch the kernel of ``algo``/``mode`` over a table layout on the
    stream of the first tensor's device, and count it."""
    name = kernel_name(algo, mode, table)
    lib = build.load("engine", _SIGNATURES)
    args = [t.data_ptr() for t in tensors] + [count] + list(mode_args)
    for tables, scalars in epochs:
        args += _epoch_args(algo, table, tables, scalars)
    with torch.cuda.device(tensors[0].device):
        rc = getattr(lib, name)(*args, torch.cuda.current_stream().cuda_stream)
    build.check(lib, rc, name)
    LAUNCHES[name] += 1


def _on_card(t: torch.Tensor) -> bool:
    """CPU tensors take the plain versions, CUDA tensors the kernels;
    anything else raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")
    return True


def kernel_lookup(algo: str, keys: torch.Tensor, tables, scalars, *,
                  table: str = "dense") -> torch.Tensor:
    """Lookup of int32 keys (uint32 bit patterns) → int32 buckets under
    one epoch's ``tables`` (in the layout ``table``) and ``scalars``
    (registry order).  CPU tensors take the plain version; CUDA tensors
    launch ``kernel_name(algo, "lookup", table)``."""
    tables, scalars = list(tables), [int(s) for s in scalars]
    _check_operands(algo, keys, [(tables, scalars)], table)
    if not _on_card(keys):
        return lookup_plain(algo, keys, tables, scalars, table=table)
    out = torch.empty_like(keys)
    if keys.numel():
        _launch(algo, "lookup", table, [keys, out], keys.numel(), [], [(tables, scalars)])
    return out


def _not_compact(table: str, what: str) -> None:
    if table == "compact":
        raise ValueError(f"compact tables serve lookups and replica sets, not {what}")


def _with_nest(out: tuple, name: str, epochs, moved: torch.Tensor | None, count: int,
               with_nest: bool) -> tuple:
    """A diff's outputs, and with ``with_nest`` the branch its kernel took:
    int32 (verdict, N_S), read from the call's workspace past ``count`` in
    ``moved`` on the card (``anchor_nest_plain``'s on the CPU, where
    ``moved`` is None); (``NEST_NONE``, 0) for the kernels not in
    ``NEST_KERNELS``."""
    if not with_nest:
        return out
    if name not in NEST_KERNELS:
        return (*out, torch.zeros(2, dtype=torch.int32, device=out[0].device))
    if moved is None:
        return (*out, torch.tensor(anchor_nest_plain(*epochs), dtype=torch.int32))
    return (*out, moved[count:][:2])


def _diff_moved(name: str, keys: torch.Tensor) -> torch.Tensor:
    """A diff's ``moved`` on the card: one int32 word a key, and for the
    kernels in ``NEST_KERNELS`` the check's workspace past them
    (``NEST_WORDS``), zeroed when no key launches the kernel."""
    nests = name in NEST_KERNELS
    moved = torch.empty(keys.numel() + NEST_WORDS * nests, dtype=torch.int32,
                        device=keys.device)
    if not keys.numel():
        moved.zero_()
    return moved


def kernel_diff(algo: str, keys: torch.Tensor, old, new, *, table: str = "dense",
                with_nest: bool = False):
    """Lookup under two epochs (each ``(tables, scalars)``, one layout) in
    one pass → (old, new, moved bool).  CUDA tensors launch the layout's
    ``diff`` kernel.  ``with_nest`` adds the branch ``anchor_packed_diff``
    took (see :func:`kernel_replica_diff`)."""
    _not_compact(table, "diffs")
    epochs = [(list(t), [int(s) for s in sc]) for t, sc in (old, new)]
    _check_operands(algo, keys, epochs, table)
    name = kernel_name(algo, "diff", table)
    if not _on_card(keys):
        out = diff_plain(algo, keys, *epochs, table=table)
        return _with_nest(out, name, epochs, None, keys.numel(), with_nest)
    o, n = (torch.empty_like(keys) for _ in range(2))
    moved = _diff_moved(name, keys)
    if keys.numel():
        _launch(algo, "diff", table, [keys, o, n, moved], keys.numel(), [], epochs)
    return _with_nest((o, n, moved[:keys.numel()].bool()), name, epochs, moved,
                      keys.numel(), with_nest)


def _check_k(k: int) -> int:
    if not 1 <= int(k) < 2**31:
        raise ValueError(f"k={k} outside [1, 2**31)")
    return int(k)


def kernel_replica(algo: str, keys: torch.Tensor, k: int, tables, scalars,
                   load: torch.Tensor | None = None, cap: int | None = None, *,
                   table: str = "dense") -> torch.Tensor:
    """k-replica sets of int32 keys → int32 [K, k] under one epoch; with
    ``load`` (int32 words, bucket-indexed) and ``cap`` every slot, slot 0
    included, skips buckets with ``load ≥ cap``.  CUDA tensors launch the
    layout's ``replica`` kernel; a lane that exhausts the salt budget
    keeps its plain lookup, as in the reference (:func:`engine_lookup`
    checks)."""
    tables, scalars, k = list(tables), [int(s) for s in scalars], _check_k(k)
    _check_operands(algo, keys, [(tables, scalars)], table)
    if load is not None:
        _check_load(algo, keys, tables, scalars, load, cap, table)
    if not _on_card(keys):
        return replica_plain(algo, keys, k, tables, scalars, load, cap, table=table)
    out = torch.empty((keys.numel(), k), dtype=torch.int32, device=keys.device)
    if keys.numel():
        _launch(algo, "replica", table, [keys, out], keys.numel(),
                [k, None if load is None else load.data_ptr(),
                 0 if load is None else int(cap)], [(tables, scalars)])
    return out


def kernel_replica_diff(algo: str, keys: torch.Tensor, k: int, old, new, *,
                        table: str = "dense", with_nest: bool = False):
    """Unbounded k-replica sets under two epochs (each ``(tables,
    scalars)``, one layout) in one pass → (old [K, k], new [K, k], moved
    bool [K]).  CUDA tensors launch the layout's ``replica_diff`` kernel.
    ``with_nest`` adds the branch that a kernel of ``NEST_KERNELS``
    (``anchor_replica_diff``, ``anchor_packed_replica_diff``) took, int32
    (verdict, N_S) as :func:`anchor_nest_plain` gives them (``NEST_NONE``,
    0 for every other kernel); on the card it stays there, read from the
    call's own workspace."""
    _not_compact(table, "diffs")
    epochs = [(list(t), [int(s) for s in sc]) for t, sc in (old, new)]
    k = _check_k(k)
    _check_operands(algo, keys, epochs, table)
    name = kernel_name(algo, "replica_diff", table)
    if not _on_card(keys):
        out = replica_diff_plain(algo, keys, k, *epochs, table=table)
        return _with_nest(out, name, epochs, None, keys.numel(), with_nest)
    o, n = (torch.empty((keys.numel(), k), dtype=torch.int32, device=keys.device)
            for _ in range(2))
    moved = _diff_moved(name, keys)
    if keys.numel():
        _launch(algo, "replica_diff", table, [keys, o, n, moved], keys.numel(), [k],
                epochs)
    return _with_nest((o, n, moved[:keys.numel()].bool()), name, epochs, moved,
                      keys.numel(), with_nest)


def kernel_walk(algo: str, chain: torch.Tensor, probe: torch.Tensor,
                pending: torch.Tensor, tables, scalars, load: torch.Tensor, cap: int, *,
                table: str = "dense"):
    """One chain-walk step of int32 ``chain`` (uint32 bit patterns), int32
    ``probe`` and bool ``pending`` under one epoch and the load cap →
    int32 (b, chain, probe).  CUDA tensors launch the layout's ``walk``
    kernel."""
    _not_compact(table, "walks")
    tables, scalars = list(tables), [int(s) for s in scalars]
    _check_operands(algo, chain, [(tables, scalars)], table)
    _check_vector(probe, chain, torch.int32, "probe", chain.numel())
    _check_vector(pending, chain, torch.bool, "pending", chain.numel())
    _check_load(algo, chain, tables, scalars, load, cap, table)
    if load.numel() >= MAX_WALK_LOAD:
        raise ValueError(f"load of {load.numel()} words: the walk takes fewer "
                         f"than {MAX_WALK_LOAD}")
    if not _on_card(chain):
        return walk_plain(algo, chain, probe, pending, tables, scalars, load, int(cap),
                          table=table)
    b, ch, pr = (torch.empty_like(chain) for _ in range(3))
    if chain.numel():
        _launch(algo, "walk", table, [chain, probe, pending, b, ch, pr], chain.numel(),
                [load.data_ptr(), int(cap), walk_probe_bound(load.numel())],
                [(tables, scalars)])
    return b, ch, pr


def dx_lane_group(max_probes: int) -> int:
    """The lanes ``dx_lookup`` spreads a key's probes over at this probe
    bound (1: one thread a key), as the built kernel library picks them."""
    return build.load("engine", _SIGNATURES).dx_lane_group(ctypes.c_int(int(max_probes)))


def dx_diff_lane_group(max_probes_old: int, max_probes_new: int) -> int:
    """The lanes ``dx_diff`` spreads a key's probes over, in both epochs,
    for these probe bounds (1: one thread a key), as the built kernel
    library picks them."""
    return build.load("engine", _SIGNATURES).dx_diff_lane_group(
        ctypes.c_int(int(max_probes_old)), ctypes.c_int(int(max_probes_new)))


def dx_replica_lane_group(max_probes: int) -> int:
    """The lanes ``dx_replica`` spreads each salted lookup of a key over at
    this probe bound (1: one thread a key), as the built kernel library
    picks them."""
    return build.load("engine", _SIGNATURES).dx_replica_lane_group(ctypes.c_int(int(max_probes)))


def dx_walk_lane_group(max_probes: int) -> int:
    """The lanes ``dx_walk`` spreads each lookup of a walk lane over at this
    probe bound (1: one thread a lane), as the built kernel library picks
    them."""
    return build.load("engine", _SIGNATURES).dx_walk_lane_group(ctypes.c_int(int(max_probes)))


def dx_replica_diff_lane_group(max_probes_old: int, max_probes_new: int) -> int:
    """The lanes ``dx_replica_diff`` gives a key in the epoch with more
    probes, for these probe bounds (1: one thread a key for both epochs;
    else each epoch's rows run as ``dx_replica`` runs them), as the built
    kernel library picks them."""
    return build.load("engine", _SIGNATURES).dx_replica_diff_lane_group(
        ctypes.c_int(int(max_probes_old)), ctypes.c_int(int(max_probes_new)))


def anchor_nest_check(old, new, *, table: str = "dense") -> torch.Tensor:
    """Launch the check of the kernels in ``NEST_KERNELS`` alone over two
    AnchorHash epochs of one a on the card, each ``(tables, scalars)``:
    dense (``anchor_nest_check``) or packed, A and K of each epoch of its
    own width (``anchor_packed_nest_check``), into a workspace of its own →
    its int32 (verdict, N_S) on the card (:func:`anchor_nest_plain`).  For
    timing the check on its own; not counted in :data:`LAUNCHES`."""
    epochs = [(list(t), [int(x) for x in sc]) for t, sc in (old, new)]
    A = epochs[0][0][0]
    _check_operands("anchor", A.new_empty(0, dtype=torch.int32), epochs, table)
    if epochs[0][1][0] != epochs[1][1][0]:
        raise ValueError("the check takes two epochs of one a")
    work = torch.empty(NEST_WORDS, dtype=torch.int32, device=A.device)
    lib = build.load("engine", _SIGNATURES)
    name = "anchor_packed_nest_check" if table == "packed" else "anchor_nest_check"
    args = [ctypes.c_void_p(t.data_ptr()) for t in (*epochs[0][0], *epochs[1][0])]
    if name == "anchor_packed_nest_check":  # each epoch's width after its tables
        widths = [ctypes.c_int(e[0][0].element_size()) for e in epochs]
        args = args[:2] + widths[:1] + args[2:] + widths[1:]
    with torch.cuda.device(A.device):
        rc = getattr(lib, name)(
            *args, ctypes.c_int(epochs[0][1][0]), ctypes.c_void_p(work.data_ptr()),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    build.check(lib, rc, name)
    return work[:2]


def memento_lookup(keys: torch.Tensor, repl: torch.Tensor, n: int) -> torch.Tensor:
    """The ``memento_lookup`` kernel (see :func:`kernel_lookup`)."""
    return kernel_lookup("memento", keys, [repl], [n])


def memento_diff(keys: torch.Tensor, repl_old: torch.Tensor, n_old: int,
                 repl_new: torch.Tensor, n_new: int):
    """The ``memento_diff`` kernel (see :func:`kernel_diff`)."""
    return kernel_diff("memento", keys, ([repl_old], [n_old]), ([repl_new], [n_new]))


def compact_lookup(keys: torch.Tensor, slot_b: torch.Tensor, slot_c: torch.Tensor,
                   n: int) -> torch.Tensor:
    """The ``memento_compact_lookup`` kernel: Memento over the Θ(r)
    open-addressing table of :func:`build_compact_table` (see
    :func:`kernel_lookup`)."""
    return kernel_lookup("memento", keys, [slot_b, slot_c], [n], table="compact")


def build_compact_table(repl) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense repl table → the open-addressing (slot_b, slot_c) int32
    tables on its device, built on the host: a power of two ≥ max(2r,
    128) slots, so the load factor stays ≤ 0.5 and a probe ends on an
    empty slot (:func:`repro_torch.core.packing.build_slots`)."""
    device = repl.device if isinstance(repl, torch.Tensor) else torch.device("cpu")
    return tuple(torch.from_numpy(t).to(device) for t in build_slots(repl))


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------

def key_tensor(keys, device) -> torch.Tensor:
    """uint32 keys (numpy array, sequence, or int32/uint32 tensor) → a
    contiguous int32 tensor of the same bit patterns on ``device``."""
    if isinstance(keys, torch.Tensor):
        if keys.dtype not in (torch.int32, torch.uint32):
            raise ValueError(f"key tensors must be int32 or uint32, not {keys.dtype}")
        t = keys.view(torch.int32)
    else:
        t = torch.from_numpy(np.ascontiguousarray(
            np.asarray(keys).astype(np.uint32)).view(np.int32))
    return t.reshape(-1).to(device).contiguous()


def op_table(image, table: str = "dense") -> str:
    """The table layout an image serves: a ``packed=True`` image always
    runs the packed kernels; a dense one ``table`` ("dense", or "compact"
    for Memento's table built per call)."""
    if image.packed:
        if table not in ("dense", "packed"):
            raise ValueError(f"packed image cannot serve table={table!r}")
        return "packed"
    if table == "packed":
        raise ValueError("table='packed' op cannot read a dense image")
    return table


def image_operands(image, table: str = "dense") -> tuple[list[torch.Tensor], list[int]]:
    """An image's kernel operands in the layout :func:`op_table` picks:
    its tables (for "compact", built from ``repl``) and scalars in layout
    order."""
    table = op_table(image, table)
    if table == "compact":
        tables = list(build_compact_table(image.arrays["repl"]))
    else:
        tables = [image.arrays[name] for name in table_names(image.algo, table)]
    return tables, image_scalar_vec(image)


def _image_device(images, device) -> torch.device:
    """Where the images' tables lie.  A tableless image (Jump, Power) lies
    nowhere: it runs on ``device`` (default: the GPU)."""
    found = {t.device for img in images for t in img.arrays.values()}
    if len(found) > 1:
        raise ValueError(f"images span devices {sorted(map(str, found))}")
    if not found:
        return resolve_device(device)
    (dev,) = found
    if device is not None and resolve_device(device) != dev:
        raise ValueError(f"image tables on {dev}, asked for {device}")
    return dev


def _int32_tensor(x, device) -> torch.Tensor:
    """An int32 operand on ``device``: a tensor passes as it is (the
    wrappers check it); anything else is converted as the reference
    converts it (``np.asarray(x, np.int32)``)."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.int32))).to(device)


def _check_bounded(out: torch.Tensor, load: torch.Tensor, cap: int, k: int) -> None:
    """The reference's exhaustion check of a bounded lookup: slots are
    accepted only when distinct and below the cap, so a slot at or above
    the cap, or a duplicate in a row, means that lane ran out of salts
    (fewer than k distinct buckets below the cap).  Raises instead of
    keeping such a result."""
    bad = (gather1d(load, out.long()) >= cap).any()
    for i in range(1, k):
        for j in range(i):
            bad |= (out[:, i] == out[:, j]).any()
    if bool(bad):
        raise RuntimeError(
            "replica salt budget exhausted (infeasible cap: fewer than "
            f"k={k} distinct working buckets below cap={cap})")


def engine_lookup(keys, image, *, k: int = 1, load=None, cap: int | None = None,
                  table: str = "dense", device=None) -> torch.Tensor:
    """The batched lookup: keys [K] → int32 [K] (k = 1) or replica sets
    [K, k] (column 0 the plain lookup), on the image's device (``device``
    for a tableless image).  ``load``/``cap`` make it bounded: every
    returned bucket has ``load < cap``, slot 0 included, and a lane that
    cannot find k such buckets raises ``RuntimeError``.  A packed image
    runs its packed kernels; ``table="compact"`` runs a dense Memento
    image's lookup, k-replica or bounded, over its Θ(r) table.
    Bit-identical to the host ``lookup``/``lookup_k`` of a
    ``variant="32"`` state.  With a live telemetry registry, counts one
    ``engine.lookups`` and one dispatch."""
    reg = _obs_registry()
    t0 = time.perf_counter_ns() if reg.active else 0
    return _engine_lookup(keys, image, k=k, load=load, cap=cap, table=table,
                          device=device, reg=reg, t0=t0)


def _engine_lookup(keys, image, *, k: int = 1, load=None, cap: int | None = None,
                   table: str = "dense", device=None, reg=None, t0: int = 0) -> torch.Tensor:
    """:func:`engine_lookup`, recorded on ``reg`` when it is live (as the
    reference records: after the launch, before the bounded check).  With
    no ``reg`` nothing is recorded: the sharded plane's per-device chunks
    and a cross-algorithm diff's two lookups are not API calls of their
    own."""
    bounded = load is not None
    if bounded and cap is None:
        raise ValueError("bounded lookup needs a cap")
    table = op_table(image, table)
    op = EngineOp(algo=image.algo, k=k, bounded=bounded, table=table)
    dev = _image_device([image], device)
    kt = key_tensor(keys, dev)
    tables, scalars = image_operands(image, table)
    if k == 1 and not bounded:
        out = kernel_lookup(image.algo, kt, tables, scalars, table=table)
    else:
        load_t = _int32_tensor(load, dev) if bounded else None
        out = kernel_replica(image.algo, kt, k, tables, scalars, load_t, cap, table=table)
    if reg is not None and reg.active:
        reg.counter("engine.lookups").inc()
        _obs_dispatch(reg, op, kt.numel(), t0)
    if bounded:
        _check_bounded(out, load_t, int(cap), k)
    return out.reshape(-1) if k == 1 else out


def replica_lookup(keys, image, k: int, **kw) -> torch.Tensor:
    """k-replica sets with a stable 2-D shape: keys [K] → int32 [K, k],
    also for k = 1."""
    return engine_lookup(keys, image, k=k, **kw).reshape(-1, k)


@dataclass
class EngineDiff:
    """Per-key placement under two epochs plus the moved mask (tensors on
    the images' device): ``old``/``new`` are [K] for k = 1 and [K, k]
    replica sets for k > 1, where a key moved if any slot differs."""

    old: torch.Tensor
    new: torch.Tensor
    moved: torch.Tensor

    @property
    def num_moved(self) -> int:
        return int(self.moved.sum())


def engine_diff(keys, old_image, new_image, *, k: int = 1, device=None) -> EngineDiff:
    """Fused epoch diff: look a key batch up under two images of one
    layout in one launch (both epochs' tables resident); k > 1 diffs
    whole replica sets.  Images of two algorithms (a migration between
    them) take one lookup each, on each algorithm's kernel in its own
    layout, as the reference's jnp plane does.  With a live telemetry
    registry, counts one ``engine.diffs``, the moved keys (one readback
    of the moved count, as the reference's) and one dispatch."""
    reg = _obs_registry()
    if not reg.active:
        return _engine_diff(keys, old_image, new_image, k=k, device=device)
    t0 = time.perf_counter_ns()
    out = _engine_diff(keys, old_image, new_image, k=k, device=device)
    reg.counter("engine.diffs").inc()
    reg.counter("engine.moved_keys").inc(out.num_moved)
    _obs_dispatch(reg, EngineOp(algo=new_image.algo, k=k, diff=True,
                                table=op_table(new_image)), out.moved.shape[0], t0)
    return out


def _engine_diff(keys, old_image, new_image, *, k: int = 1, device=None) -> EngineDiff:
    if old_image.algo != new_image.algo:
        dev = _image_device([old_image, new_image], device)
        kt = key_tensor(keys, dev)
        old, new = (_engine_lookup(kt, img, k=k, device=dev) for img in (old_image, new_image))
        return EngineDiff(old, new, old != new if k == 1 else (old != new).any(dim=1))
    if old_image.packed != new_image.packed:
        raise ValueError("epoch diff needs both images in one layout")
    table = op_table(old_image)
    EngineOp(algo=old_image.algo, k=k, diff=True, table=table)
    dev = _image_device([old_image, new_image], device)
    kt = key_tensor(keys, dev)
    old, new = image_operands(old_image), image_operands(new_image)
    if k == 1:
        return EngineDiff(*kernel_diff(old_image.algo, kt, old, new, table=table))
    return EngineDiff(*kernel_replica_diff(old_image.algo, kt, k, old, new, table=table))


def engine_chain_walk(chain, probe, pending, image, load, cap: int, *, device=None):
    """One bounded-load chain-walk step (the round of
    :func:`bounded_assign`): every pending lane advances to the first
    bucket of its rehash chain with ``load[b] < cap``.  Returns numpy
    ``(b int32, chain uint32, probe int32)``; non-pending lanes come back
    with their chain and probe unchanged.  With a live telemetry registry,
    counts one ``engine.walk_steps`` and one dispatch of all the lanes."""
    reg = _obs_registry()
    t0 = time.perf_counter_ns() if reg.active else 0
    table = op_table(image)
    op = EngineOp(algo=image.algo, mode="walk", table=table)
    dev = _image_device([image], device)
    pend = (pending if isinstance(pending, torch.Tensor)
            else torch.from_numpy(np.asarray(pending, dtype=bool)).to(dev))
    ct = key_tensor(chain, dev)
    b, ch, pr = kernel_walk(image.algo, ct, _int32_tensor(probe, dev),
                            pend, *image_operands(image), _int32_tensor(load, dev), cap,
                            table=table)
    if reg.active:
        _obs_walk(reg, op, ct.numel(), t0)
    return (b.cpu().numpy(), ch.cpu().numpy().view(np.uint32), pr.cpu().numpy())


def _obs_walk(reg, op: EngineOp, n_lanes: int, t0_ns: int) -> None:
    reg.counter("engine.walk_steps").inc()
    _obs_dispatch(reg, op, n_lanes, t0_ns)


def bounded_assign(keys, image, load, cap: int, *, device=None, walk=None):
    """Assign a key batch under the load cap on the device.

    Each round, one walk launch advances every pending key to the first
    bucket below the cap on its rehash chain, then races inside the batch
    are settled in key-index order (:func:`accept_in_index_order`) on the
    host: round for round the numpy reference ``bounded_assign_ref``.
    Chain and probe stay on the device between rounds.  ``walk`` is the
    step (default :func:`kernel_walk`; :func:`walk_plain` runs the same
    loop through the plain version).  Returns ``(assignments int32 [m],
    new_load int32)`` as numpy.  With a live telemetry registry each round
    counts as an :func:`engine_chain_walk` (one ``engine.walk_steps`` and
    one dispatch of all m lanes), and the call one
    ``engine.bounded_assigns`` and its ``engine.bounded_rounds``."""
    table = op_table(image)
    op = EngineOp(algo=image.algo, mode="walk", table=table)
    walk = kernel_walk if walk is None else walk
    dev = _image_device([image], device)
    tables, scalars = image_operands(image)
    keys = np.asarray(keys, dtype=np.uint32)
    m = len(keys)
    chain = key_tensor(keys, dev)
    probe = torch.zeros(m, dtype=torch.int32, device=dev)
    out = np.full(m, -1, np.int32)
    pending = np.ones(m, bool)
    load = np.asarray(load, dtype=np.int32).copy()
    reg = _obs_registry()
    rounds = 0
    while pending.any():
        t0 = time.perf_counter_ns() if reg.active else 0
        b, chain, probe = walk(image.algo, chain, probe, torch.from_numpy(pending).to(dev),
                               tables, scalars, torch.from_numpy(load).to(dev), cap,
                               table=table)
        b = b.cpu().numpy()
        if reg.active:
            _obs_walk(reg, op, m, t0)
        if (load[b[pending]] >= cap).any():  # probe bound exhausted
            raise RuntimeError("no bucket below capacity (infeasible cap: "
                               f"cap={cap} cannot hold the pending keys)")
        acc = accept_in_index_order(b, pending, load, cap)
        out[acc] = b[acc]
        np.add.at(load, b[acc], 1)
        pending[acc] = False
        rounds += 1
    if reg.active:
        reg.counter("engine.bounded_assigns").inc()
        reg.counter("engine.bounded_rounds").inc(rounds)
    return out, load


def bounded_load_len(image) -> int:
    """Length of a load-word array covering ``image``'s bucket ids: the
    sizing rule of every bounded operation (the walk and the bounded
    lookup index ``load`` by bucket id)."""
    return _load_len(image.algo, image_operands(image)[0], image.n, op_table(image))


def bounded_replica_sets(h, keys, k: int, load, cap: int) -> np.ndarray:
    """Numpy oracle of the bounded replica lookup: the host salted walk
    (``lookup_k_filtered``) with the load-cap rule applied to every slot,
    slot 0 included."""
    load = np.asarray(load)

    def reject(cand, chosen):
        return cand in chosen or load[cand] >= cap

    keys = np.asarray(keys)
    out = np.empty((len(keys), k), dtype=np.int32)
    for i, key in enumerate(keys):
        out[i] = h.lookup_k_filtered(int(key), k, reject, check_first=True)
    return out
