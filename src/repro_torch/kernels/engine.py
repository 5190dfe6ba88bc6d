"""The lookup engine of the port: batched lookups, k-replica sets,
bounded-load walks and epoch diffs of every algorithm on the device.

The reference runs every lookup-shaped operation as one configuration of
one Pallas kernel (``src/repro/kernels/engine.py``, :class:`EngineOp`).
This port serves every configuration over the dense tables, for all five
algorithms, each as a CUDA kernel in ``csrc/engine.cu``:

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

Packed and compact tables raise ``NotImplementedError`` naming the
``ROADMAP.md`` item that holds them (K1b, K1g).

Each kernel has a plain torch version beside it (:func:`lookup_plain`,
:func:`diff_plain`, :func:`replica_plain`, :func:`replica_diff_plain`,
:func:`walk_plain`, over the lane-synchronous bodies below, as the
reference writes them).  A wrapper takes the plain version only for
tensors on the CPU; for CUDA tensors it launches the kernel or raises.
``LAUNCHES`` counts the kernel launches, one entry per kernel.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.bounded import accept_in_index_order, walk_probe_bound
from repro_torch.core.hashing import MASK32
from repro_torch.core.protocol import (ALGORITHM_REGISTRY, ALGORITHMS,
                                      IMAGE_LAYOUT, REPLICA_SALT_CAP,
                                      image_scalar_vec, required_lengths,
                                      round_up)
from repro_torch.device import resolve_device
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

#: kernel launches per kernel since the last reset (set the values to 0)
LAUNCHES: dict[str, int] = {f"{algo}_{mode}": 0 for algo in ALGORITHMS for mode in _MODES}

_P, _N = ctypes.c_void_p, ctypes.c_longlong

#: the walk's probe bound 64·L + 64 stays below 2**31 for loads shorter
#: than this
MAX_WALK_LOAD = 2**25


def _signature(algo: str, mode: str) -> list:
    """The C entry's argtypes: the tensors, the count, the mode's own
    arguments, then each epoch's tables and scalars in registry order,
    then the stream."""
    info = ALGORITHM_REGISTRY[algo]
    epoch = [_P] * len(info.tables) + [ctypes.c_int] * len(info.scalars)
    ptrs, extra, epochs = _MODES[mode]
    return [_P] * ptrs + [_N] + extra + epoch * epochs + [_P]


_SIGNATURES = {f"{algo}_{mode}": _signature(algo, mode)
               for algo in ALGORITHMS for mode in _MODES}


@dataclass(frozen=True)
class EngineOp:
    """Static engine configuration, checked as the reference checks it.

    * ``algo``    — a name in :data:`ALGORITHMS`,
    * ``mode``    — "lookup" or "walk",
    * ``k``       — replica slots per key,
    * ``bounded`` — lookup mode: skip buckets at or above a load cap,
    * ``diff``    — lookup mode: run under two epoch images at once,
    * ``table``   — "dense", "compact" (Memento only) or "packed".

    A configuration the reference rejects raises ``ValueError``; packed
    and compact tables, which this port does not serve yet, raise
    ``NotImplementedError``.
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
        if self.table != "dense":
            raise NotImplementedError(
                f"{self.table} tables: ROADMAP.md Queue 2, K1b/K1g")


# ---------------------------------------------------------------------------
# Plain torch versions (lane-synchronous, like the reference's bodies).
# Keys are int64-carried uint32 words; every body returns int64 buckets.
# ``work``, if given, counts the lane-iterations the batch needed (what
# chip_smoke.py's bounds read).
# ---------------------------------------------------------------------------

def memento_body(keys: torch.Tensor, read, n: int,
                 work: dict | None = None) -> torch.Tensor:
    """Paper Alg. 4 over a table reader ``read(idx) -> repl[idx]`` (−1 =
    working).  ``work`` gains ``"step"`` (jump32 steps), ``"outer"``
    (Alg. 4 iterations) and ``"read"`` (chain reads)."""
    b = jump32(keys, n, work)
    c = read(b)
    active = c >= 0
    while bool(active.any()):
        wb = torch.where(active, c, 1).clamp_min(1)  # a valid image never holds 0
        d = hash2(keys, b) % wb
        u = read(d)
        follow = active & (u >= wb)  # follow only while u ≥ w_b
        if work is not None:
            work["outer"] = work.get("outer", 0) + int(active.sum())
        while bool(follow.any()):
            if work is not None:
                work["read"] = work.get("read", 0) + int(follow.sum())
            d = torch.where(follow, u, d)
            u = read(d)
            follow = active & (u >= wb)
        b = torch.where(active, d, b)
        c = read(b)
        active = c >= 0
    return b


def dense_body(keys: torch.Tensor, repl: torch.Tensor, n: int,
               work: dict | None = None) -> torch.Tensor:
    """Memento over the dense repl table."""
    return memento_body(keys, lambda idx: gather1d(repl, idx), n, work)


def anchor_body(keys: torch.Tensor, A: torch.Tensor, K: torch.Tensor, a: int,
                work: dict | None = None) -> torch.Tensor:
    """AnchorHash: start at ``fmix32(key) % a``; while ``A[b] > 0`` draw
    ``h = hash2(key, b) % A[b]`` and follow ``K[h]`` while ``A[h] ≥ A[b]``.
    ``work`` gains ``"outer"`` (removed buckets met) and ``"read"``
    (successor reads)."""
    b = fmix32(keys) % a
    Ab = gather1d(A, b)
    active = Ab > 0
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
        Ab = gather1d(A, b)
        active = Ab > 0
    return b


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


def lookup_plain(algo: str, keys: torch.Tensor, tables, scalars,
                 work: dict | None = None) -> torch.Tensor:
    """Plain version of the ``{algo}_lookup`` kernel: int32 keys (uint32
    bit patterns) → int32 buckets, on the keys' device."""
    return _BODIES[algo](as_u32(keys), list(tables), list(scalars), work).to(torch.int32)


def diff_plain(algo: str, keys: torch.Tensor, old, new):
    """Plain version of the ``{algo}_diff`` kernel: ``old``/``new`` are
    ``(tables, scalars)`` of the two epochs → (old, new, moved)."""
    o = lookup_plain(algo, keys, *old)
    n = lookup_plain(algo, keys, *new)
    return o, n, o != n


def _count(work: dict | None, name: str, lanes) -> None:
    if work is not None:
        work[name] = work.get(name, 0) + int(lanes)


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
                  cap=None, work: dict | None = None) -> torch.Tensor:
    """Plain version of the ``{algo}_replica`` kernel: int32 keys → int32
    replica sets [K, k], column 0 the plain lookup (unbounded)."""
    tables, scalars = list(tables), list(scalars)
    outs = replica_body(as_u32(keys), k,
                        lambda kk: _BODIES[algo](kk, tables, scalars, work),
                        load, cap, work)
    return torch.stack(outs, dim=1).to(torch.int32)


def replica_diff_plain(algo: str, keys: torch.Tensor, k: int, old, new):
    """Plain version of the ``{algo}_replica_diff`` kernel: replica sets
    under the epochs ``old`` and ``new`` (each ``(tables, scalars)``) →
    (old [K, k], new [K, k], moved: any slot differs)."""
    o = replica_plain(algo, keys, k, *old)
    n = replica_plain(algo, keys, k, *new)
    return o, n, (o != n).any(dim=1)


def walk_plain(algo: str, chain: torch.Tensor, probe: torch.Tensor,
               pending: torch.Tensor, tables, scalars, load: torch.Tensor, cap: int,
               work: dict | None = None):
    """Plain version of the ``{algo}_walk`` kernel: int32 chain (uint32
    bit patterns), int32 probe, bool pending → int32 (b, chain, probe)."""
    tables, scalars = list(tables), list(scalars)
    b, ch, pr = chain_walk_body(as_u32(chain), probe.to(torch.int64), pending, load,
                                cap, lambda kk: _BODIES[algo](kk, tables, scalars, work),
                                work)
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


def _check_operands(algo: str, keys: torch.Tensor, epochs) -> None:
    """Raise on what the kernels do not take: keys must be contiguous 1-D
    int32; each epoch's tables contiguous 1-D int32 on the keys' device
    and long enough for its ``n``; scalars in range."""
    if keys.dtype != torch.int32 or keys.dim() != 1 or not keys.is_contiguous():
        raise ValueError("keys must be a contiguous 1-D int32 tensor")
    if keys.numel() >= 2**31:
        raise ValueError("at most 2**31 - 1 keys per launch")
    names = ALGORITHM_REGISTRY[algo].tables
    for tables, scalars in epochs:
        n = scalars[0]
        if not 1 <= n < 2**31:
            raise ValueError(f"n={n} outside [1, 2**31)")
        if len(tables) != len(names) or len(scalars) != len(ALGORITHM_REGISTRY[algo].scalars):
            raise ValueError(f"{algo} takes tables {names} and scalars "
                             f"{ALGORITHM_REGISTRY[algo].scalars}")
        need = required_lengths(algo, n)
        for name, t in zip(names, tables):
            _check_vector(t, keys, torch.int32, name)
            if t.numel() < need[name]:
                raise ValueError(f"n={n} needs {name} of {need[name]} words, "
                                 f"not {t.numel()}")
        if algo == "dx" and not (scalars[1] >= 0 and 0 <= scalars[2] < n):
            raise ValueError(f"dx scalars max_probes={scalars[1]}, "
                             f"fallback={scalars[2]} out of range")


def _load_len(algo: str, tables, n: int) -> int:
    """Load words that cover ``algo``'s bucket ids: the length of the
    bucket-indexed table for Memento and AnchorHash, the 128-padded id
    space for the others (Dx packs bits, Jump and Power have no table)."""
    if algo in ("memento", "anchor"):
        return int(tables[0].numel())
    return round_up(n)


def _check_load(algo: str, keys: torch.Tensor, tables, scalars, load: torch.Tensor,
                cap) -> None:
    """Raise unless ``load`` is a contiguous 1-D int32 tensor on the keys'
    device covering every bucket id (a short one would be read out of
    bounds on the card) and ``cap`` an int32."""
    _check_vector(load, keys, torch.int32, "load")
    need = _load_len(algo, tables, scalars[0])
    if load.numel() < need:
        raise ValueError(f"load has {load.numel()} words, the image needs {need}")
    if cap is None or not -2**31 <= int(cap) < 2**31:
        raise ValueError(f"cap={cap} is not an int32")


def _launch(name: str, tensors, count: int, mode_args, epochs) -> None:
    """Launch kernel ``name`` on the stream of the first tensor's device
    and count it."""
    lib = build.load("engine", _SIGNATURES)
    args = [t.data_ptr() for t in tensors] + [count] + list(mode_args)
    for tables, scalars in epochs:
        args += [t.data_ptr() for t in tables] + [int(s) for s in scalars]
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


def kernel_lookup(algo: str, keys: torch.Tensor, tables, scalars) -> torch.Tensor:
    """Lookup of int32 keys (uint32 bit patterns) → int32 buckets under
    one epoch's ``tables`` and ``scalars`` (registry order).  CPU tensors
    take the plain version; CUDA tensors launch ``{algo}_lookup``."""
    tables, scalars = list(tables), [int(s) for s in scalars]
    _check_operands(algo, keys, [(tables, scalars)])
    if not _on_card(keys):
        return lookup_plain(algo, keys, tables, scalars)
    out = torch.empty_like(keys)
    if keys.numel():
        _launch(f"{algo}_lookup", [keys, out], keys.numel(), [], [(tables, scalars)])
    return out


def kernel_diff(algo: str, keys: torch.Tensor, old, new):
    """Lookup under two epochs (each ``(tables, scalars)``) in one pass →
    (old, new, moved bool).  CUDA tensors launch ``{algo}_diff``."""
    epochs = [(list(t), [int(s) for s in sc]) for t, sc in (old, new)]
    _check_operands(algo, keys, epochs)
    if not _on_card(keys):
        return diff_plain(algo, keys, *epochs)
    o, n, moved = (torch.empty_like(keys) for _ in range(3))
    if keys.numel():
        _launch(f"{algo}_diff", [keys, o, n, moved], keys.numel(), [], epochs)
    return o, n, moved.bool()


def _check_k(k: int) -> int:
    if not 1 <= int(k) < 2**31:
        raise ValueError(f"k={k} outside [1, 2**31)")
    return int(k)


def kernel_replica(algo: str, keys: torch.Tensor, k: int, tables, scalars,
                   load: torch.Tensor | None = None, cap: int | None = None) -> torch.Tensor:
    """k-replica sets of int32 keys → int32 [K, k] under one epoch; with
    ``load`` (int32 words, bucket-indexed) and ``cap`` every slot, slot 0
    included, skips buckets with ``load ≥ cap``.  CUDA tensors launch
    ``{algo}_replica``; a lane that exhausts the salt budget keeps its
    plain lookup, as in the reference (:func:`engine_lookup` checks)."""
    tables, scalars, k = list(tables), [int(s) for s in scalars], _check_k(k)
    _check_operands(algo, keys, [(tables, scalars)])
    if load is not None:
        _check_load(algo, keys, tables, scalars, load, cap)
    if not _on_card(keys):
        return replica_plain(algo, keys, k, tables, scalars, load, cap)
    out = torch.empty((keys.numel(), k), dtype=torch.int32, device=keys.device)
    if keys.numel():
        _launch(f"{algo}_replica", [keys, out], keys.numel(),
                [k, None if load is None else load.data_ptr(),
                 0 if load is None else int(cap)], [(tables, scalars)])
    return out


def kernel_replica_diff(algo: str, keys: torch.Tensor, k: int, old, new):
    """Unbounded k-replica sets under two epochs (each ``(tables,
    scalars)``) in one pass → (old [K, k], new [K, k], moved bool [K]).
    CUDA tensors launch ``{algo}_replica_diff``."""
    epochs = [(list(t), [int(s) for s in sc]) for t, sc in (old, new)]
    k = _check_k(k)
    _check_operands(algo, keys, epochs)
    if not _on_card(keys):
        return replica_diff_plain(algo, keys, k, *epochs)
    o, n = (torch.empty((keys.numel(), k), dtype=torch.int32, device=keys.device)
            for _ in range(2))
    moved = torch.empty_like(keys)
    if keys.numel():
        _launch(f"{algo}_replica_diff", [keys, o, n, moved], keys.numel(), [k], epochs)
    return o, n, moved.bool()


def kernel_walk(algo: str, chain: torch.Tensor, probe: torch.Tensor,
                pending: torch.Tensor, tables, scalars, load: torch.Tensor, cap: int):
    """One chain-walk step of int32 ``chain`` (uint32 bit patterns), int32
    ``probe`` and bool ``pending`` under one epoch and the load cap →
    int32 (b, chain, probe).  CUDA tensors launch ``{algo}_walk``."""
    tables, scalars = list(tables), [int(s) for s in scalars]
    _check_operands(algo, chain, [(tables, scalars)])
    _check_vector(probe, chain, torch.int32, "probe", chain.numel())
    _check_vector(pending, chain, torch.bool, "pending", chain.numel())
    _check_load(algo, chain, tables, scalars, load, cap)
    if load.numel() >= MAX_WALK_LOAD:
        raise ValueError(f"load of {load.numel()} words: the walk takes fewer "
                         f"than {MAX_WALK_LOAD}")
    if not _on_card(chain):
        return walk_plain(algo, chain, probe, pending, tables, scalars, load, int(cap))
    b, ch, pr = (torch.empty_like(chain) for _ in range(3))
    if chain.numel():
        _launch(f"{algo}_walk", [chain, probe, pending, b, ch, pr], chain.numel(),
                [load.data_ptr(), int(cap), walk_probe_bound(load.numel())],
                [(tables, scalars)])
    return b, ch, pr


def memento_lookup(keys: torch.Tensor, repl: torch.Tensor, n: int) -> torch.Tensor:
    """The ``memento_lookup`` kernel (see :func:`kernel_lookup`)."""
    return kernel_lookup("memento", keys, [repl], [n])


def memento_diff(keys: torch.Tensor, repl_old: torch.Tensor, n_old: int,
                 repl_new: torch.Tensor, n_new: int):
    """The ``memento_diff`` kernel (see :func:`kernel_diff`)."""
    return kernel_diff("memento", keys, ([repl_old], [n_old]), ([repl_new], [n_new]))


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


def image_operands(image) -> tuple[list[torch.Tensor], list[int]]:
    """An image's kernel operands: its tables and scalars in layout order."""
    return ([image.arrays[name] for name in IMAGE_LAYOUT[image.algo][1]],
            image_scalar_vec(image))


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
                  device=None) -> torch.Tensor:
    """The batched lookup: keys [K] → int32 [K] (k = 1) or replica sets
    [K, k] (column 0 the plain lookup), on the image's device (``device``
    for a tableless image).  ``load``/``cap`` make it bounded: every
    returned bucket has ``load < cap``, slot 0 included, and a lane that
    cannot find k such buckets raises ``RuntimeError``.  Bit-identical to
    the host ``lookup``/``lookup_k`` of a ``variant="32"`` state."""
    bounded = load is not None
    if bounded and cap is None:
        raise ValueError("bounded lookup needs a cap")
    EngineOp(algo=image.algo, k=k, bounded=bounded)
    dev = _image_device([image], device)
    kt = key_tensor(keys, dev)
    tables, scalars = image_operands(image)
    if k == 1 and not bounded:
        return kernel_lookup(image.algo, kt, tables, scalars)
    load_t = _int32_tensor(load, dev) if bounded else None
    out = kernel_replica(image.algo, kt, k, tables, scalars, load_t, cap)
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
    """Fused epoch diff: look a key batch up under two images in one
    launch (both epochs' tables resident); k > 1 diffs whole replica
    sets."""
    if old_image.algo != new_image.algo:
        raise ValueError("epoch diff requires one algorithm "
                         f"({old_image.algo!r} != {new_image.algo!r})")
    EngineOp(algo=old_image.algo, k=k, diff=True)
    dev = _image_device([old_image, new_image], device)
    kt = key_tensor(keys, dev)
    old, new = image_operands(old_image), image_operands(new_image)
    if k == 1:
        return EngineDiff(*kernel_diff(old_image.algo, kt, old, new))
    return EngineDiff(*kernel_replica_diff(old_image.algo, kt, k, old, new))


def engine_chain_walk(chain, probe, pending, image, load, cap: int, *, device=None):
    """One bounded-load chain-walk step (the round of
    :func:`bounded_assign`): every pending lane advances to the first
    bucket of its rehash chain with ``load[b] < cap``.  Returns numpy
    ``(b int32, chain uint32, probe int32)``; non-pending lanes come back
    with their chain and probe unchanged."""
    EngineOp(algo=image.algo, mode="walk")
    dev = _image_device([image], device)
    pend = (pending if isinstance(pending, torch.Tensor)
            else torch.from_numpy(np.asarray(pending, dtype=bool)).to(dev))
    b, ch, pr = kernel_walk(image.algo, key_tensor(chain, dev), _int32_tensor(probe, dev),
                            pend, *image_operands(image), _int32_tensor(load, dev), cap)
    return (b.cpu().numpy(), ch.cpu().numpy().view(np.uint32), pr.cpu().numpy())


def bounded_assign(keys, image, load, cap: int, *, device=None, walk=None):
    """Assign a key batch under the load cap on the device.

    Each round, one walk launch advances every pending key to the first
    bucket below the cap on its rehash chain, then races inside the batch
    are settled in key-index order (:func:`accept_in_index_order`) on the
    host: round for round the numpy reference ``bounded_assign_ref``.
    Chain and probe stay on the device between rounds.  ``walk`` is the
    step (default :func:`kernel_walk`; :func:`walk_plain` runs the same
    loop through the plain version).  Returns ``(assignments int32 [m],
    new_load int32)`` as numpy."""
    EngineOp(algo=image.algo, mode="walk")
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
    while pending.any():
        b, chain, probe = walk(image.algo, chain, probe, torch.from_numpy(pending).to(dev),
                               tables, scalars, torch.from_numpy(load).to(dev), cap)
        b = b.cpu().numpy()
        if (load[b[pending]] >= cap).any():  # probe bound exhausted
            raise RuntimeError("no bucket below capacity (infeasible cap: "
                               f"cap={cap} cannot hold the pending keys)")
        acc = accept_in_index_order(b, pending, load, cap)
        out[acc] = b[acc]
        np.add.at(load, b[acc], 1)
        pending[acc] = False
    return out, load


def bounded_load_len(image) -> int:
    """Length of a load-word array covering ``image``'s bucket ids: the
    sizing rule of every bounded operation (the walk and the bounded
    lookup index ``load`` by bucket id)."""
    return _load_len(image.algo, image_operands(image)[0], image.n)


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
