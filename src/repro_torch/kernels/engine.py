"""The lookup engine of the port: batched MementoHash lookups and epoch
diffs on the device.

The reference runs every lookup-shaped operation as one configuration of
one Pallas kernel (``src/repro/kernels/engine.py``, :class:`EngineOp`).
This slice ports its dense Memento configurations with k = 1:

  ============================ ==========================================
  configuration                kernel (``csrc/engine.cu``)
  ============================ ==========================================
  ``EngineOp("memento")``      ``memento_lookup``: keys → buckets
  ``EngineOp("memento",        ``memento_diff``: keys → buckets under two
  diff=True)``                 epochs and the moved mask, in one launch
  ============================ ==========================================

Every other configuration raises ``NotImplementedError`` naming the
``ROADMAP.md`` item that holds it.

Each kernel has a plain torch version beside it (:func:`memento_lookup_plain`,
:func:`memento_diff_plain`), the lane-synchronous body of the reference.
A wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.  ``LAUNCHES`` counts the kernel
launches.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.protocol import (ALGORITHMS, IMAGE_LAYOUT, NOT_PORTED,
                                      image_scalar_vec)
from . import build
from .primitives import as_u32, gather1d, hash2, jump32

#: kernel launches per kernel since the last reset (set the values to 0)
LAUNCHES: dict[str, int] = {"memento_lookup": 0, "memento_diff": 0}

_P, _N = ctypes.c_void_p, ctypes.c_longlong
_SIGNATURES = {
    "memento_lookup": [_P, _P, _N, _P, ctypes.c_int, _P],
    "memento_diff": [_P, _P, _P, _P, _N, _P, ctypes.c_int, _P, ctypes.c_int, _P],
}


@dataclass(frozen=True)
class EngineOp:
    """Static engine configuration, checked as the reference checks it.

    * ``algo``    — a name in :data:`ALGORITHMS`,
    * ``mode``    — "lookup" or "walk",
    * ``k``       — replica slots per key,
    * ``bounded`` — lookup mode: skip buckets at or above a load cap,
    * ``diff``    — lookup mode: run under two epoch images at once,
    * ``table``   — "dense", "compact" (Memento only) or "packed".

    A configuration the reference rejects raises ``ValueError``; one it
    accepts that this port does not serve yet raises ``NotImplementedError``.
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
        if self.algo in NOT_PORTED:
            raise NotImplementedError(
                f"engine body for {self.algo!r}: {NOT_PORTED[self.algo]}")
        if self.table != "dense":
            raise NotImplementedError(
                f"{self.table} tables: ROADMAP.md Queue 2, K1b/K1g")
        if self.mode == "walk":
            raise NotImplementedError("walk mode: ROADMAP.md Queue 2, K1j")
        if self.k != 1 or self.bounded:
            raise NotImplementedError(
                "k > 1 and bounded lookups: ROADMAP.md Queue 2, K1h")


# ---------------------------------------------------------------------------
# Plain torch versions (lane-synchronous, like the reference's body)
# ---------------------------------------------------------------------------

def memento_body(keys: torch.Tensor, read, n: int,
                 work: dict | None = None) -> torch.Tensor:
    """Paper Alg. 4 over a table reader ``read(idx) -> repl[idx]`` (−1 =
    working).  ``keys`` are int64-carried uint32 words; returns int64.
    ``work``, if given, counts the lane-iterations this batch needed:
    ``"step"`` (jump32 steps), ``"outer"`` (Alg. 4 iterations) and
    ``"read"`` (chain reads)."""
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


def memento_lookup_plain(keys: torch.Tensor, repl: torch.Tensor, n: int,
                         work: dict | None = None) -> torch.Tensor:
    """Plain version of the ``memento_lookup`` kernel: int32 keys (uint32
    bit patterns) → int32 buckets, on the keys' device."""
    return dense_body(as_u32(keys), repl, n, work).to(torch.int32)


def memento_diff_plain(keys: torch.Tensor, repl_old: torch.Tensor, n_old: int,
                       repl_new: torch.Tensor, n_new: int):
    """Plain version of the ``memento_diff`` kernel: (old, new, moved)."""
    k = as_u32(keys)
    old = dense_body(k, repl_old, n_old).to(torch.int32)
    new = dense_body(k, repl_new, n_new).to(torch.int32)
    return old, new, old != new


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check_operands(keys: torch.Tensor, tables: list[tuple[torch.Tensor, int]]):
    if keys.dtype != torch.int32 or keys.dim() != 1 or not keys.is_contiguous():
        raise ValueError("keys must be a contiguous 1-D int32 tensor")
    if keys.numel() >= 2**31:
        raise ValueError("at most 2**31 - 1 keys per launch")
    for repl, n in tables:
        if repl.device != keys.device:
            raise ValueError(f"table on {repl.device}, keys on {keys.device}")
        if repl.dtype != torch.int32 or repl.dim() != 1 or not repl.is_contiguous():
            raise ValueError("repl must be a contiguous 1-D int32 tensor")
        if not 1 <= n <= repl.numel() or n >= 2**31:
            raise ValueError(f"n={n} outside [1, {repl.numel()}]")


def memento_lookup(keys: torch.Tensor, repl: torch.Tensor, n: int) -> torch.Tensor:
    """Memento lookup of int32 keys (uint32 bit patterns) → int32 buckets.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    _check_operands(keys, [(repl, n)])
    if keys.device.type == "cpu":
        return memento_lookup_plain(keys, repl, n)
    if keys.device.type != "cuda":
        raise ValueError(f"no kernel for device {keys.device}")
    out = torch.empty_like(keys)
    if keys.numel():
        lib = build.load("engine", _SIGNATURES)
        with torch.cuda.device(keys.device):
            rc = lib.memento_lookup(keys.data_ptr(), out.data_ptr(), keys.numel(),
                                    repl.data_ptr(), n,
                                    torch.cuda.current_stream().cuda_stream)
        build.check(lib, rc, "memento_lookup")
        LAUNCHES["memento_lookup"] += 1
    return out


def memento_diff(keys: torch.Tensor, repl_old: torch.Tensor, n_old: int,
                 repl_new: torch.Tensor, n_new: int):
    """Lookup under two epochs in one pass → (old, new, moved bool)."""
    _check_operands(keys, [(repl_old, n_old), (repl_new, n_new)])
    if keys.device.type == "cpu":
        return memento_diff_plain(keys, repl_old, n_old, repl_new, n_new)
    if keys.device.type != "cuda":
        raise ValueError(f"no kernel for device {keys.device}")
    old, new, moved = (torch.empty_like(keys) for _ in range(3))
    if keys.numel():
        lib = build.load("engine", _SIGNATURES)
        with torch.cuda.device(keys.device):
            rc = lib.memento_diff(keys.data_ptr(), old.data_ptr(), new.data_ptr(),
                                  moved.data_ptr(), keys.numel(),
                                  repl_old.data_ptr(), n_old,
                                  repl_new.data_ptr(), n_new,
                                  torch.cuda.current_stream().cuda_stream)
        build.check(lib, rc, "memento_diff")
        LAUNCHES["memento_diff"] += 1
    return old, new, moved.bool()


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


def _dense_operands(image) -> tuple[torch.Tensor, int]:
    (repl_name,) = IMAGE_LAYOUT[image.algo][1]
    return image.arrays[repl_name], image_scalar_vec(image)[0]


def engine_lookup(keys, image, *, k: int = 1) -> torch.Tensor:
    """The batched lookup: keys [K] → int32 [K] buckets, on the image's
    device.  Bit-identical to the host ``lookup`` of a ``variant="32"``
    state."""
    EngineOp(algo=image.algo, k=k)
    repl, n = _dense_operands(image)
    return memento_lookup(key_tensor(keys, repl.device), repl, n)


@dataclass
class EngineDiff:
    """Per-key placement under two epochs plus the moved mask (tensors on
    the images' device)."""

    old: torch.Tensor
    new: torch.Tensor
    moved: torch.Tensor

    @property
    def num_moved(self) -> int:
        return int(self.moved.sum())


def engine_diff(keys, old_image, new_image, *, k: int = 1) -> EngineDiff:
    """Fused epoch diff: look a key batch up under two images in one
    launch (both tables resident)."""
    if old_image.algo != new_image.algo:
        raise ValueError("epoch diff requires one algorithm "
                         f"({old_image.algo!r} != {new_image.algo!r})")
    EngineOp(algo=old_image.algo, k=k, diff=True)
    repl_old, n_old = _dense_operands(old_image)
    repl_new, n_new = _dense_operands(new_image)
    old, new, moved = memento_diff(key_tensor(keys, repl_new.device),
                                   repl_old, n_old, repl_new, n_new)
    return EngineDiff(old, new, moved)
