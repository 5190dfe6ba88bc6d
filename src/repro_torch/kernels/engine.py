"""The lookup engine of the port: batched lookups and epoch diffs of every
algorithm on the device.

The reference runs every lookup-shaped operation as one configuration of
one Pallas kernel (``src/repro/kernels/engine.py``, :class:`EngineOp`).
This port serves its dense configurations with k = 1, for all five
algorithms, each as a pair of CUDA kernels in ``csrc/engine.cu``:

  ================================ ======================================
  configuration                    kernel
  ================================ ======================================
  ``EngineOp(algo)``               ``{algo}_lookup``: keys → buckets
  ``EngineOp(algo, diff=True)``    ``{algo}_diff``: keys → buckets under
                                   two epochs and the moved mask, in one
                                   launch
  ================================ ======================================

Every other configuration (packed or compact tables, k > 1, bounded,
walk) raises ``NotImplementedError`` naming the ``ROADMAP.md`` item that
holds it.

Each kernel has a plain torch version beside it (:func:`lookup_plain`,
:func:`diff_plain`, over the lane-synchronous bodies below, as the
reference writes them).  A wrapper takes the plain version only for
tensors on the CPU; for CUDA tensors it launches the kernel or raises.
``LAUNCHES`` counts the kernel launches, one entry per kernel.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.hashing import MASK32
from repro_torch.core.protocol import (ALGORITHM_REGISTRY, ALGORITHMS,
                                      IMAGE_LAYOUT, image_scalar_vec,
                                      required_lengths)
from repro_torch.device import resolve_device
from . import build
from .primitives import as_u32, fmix32, gather1d, hash2, jump32, power32

#: kernel launches per kernel since the last reset (set the values to 0)
LAUNCHES: dict[str, int] = {f"{algo}_{mode}": 0
                            for algo in ALGORITHMS for mode in ("lookup", "diff")}

_P, _N = ctypes.c_void_p, ctypes.c_longlong


def _signature(algo: str, diff: bool) -> list:
    """The C entry's argtypes: keys, outputs, count, then each epoch's
    tables and scalars in registry order, then the stream."""
    info = ALGORITHM_REGISTRY[algo]
    epoch = [_P] * len(info.tables) + [ctypes.c_int] * len(info.scalars)
    if diff:
        return [_P, _P, _P, _P, _N] + epoch * 2 + [_P]
    return [_P, _P, _N] + epoch + [_P]


_SIGNATURES = {f"{algo}_{mode}": _signature(algo, mode == "diff")
               for algo in ALGORITHMS for mode in ("lookup", "diff")}


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
        if self.table != "dense":
            raise NotImplementedError(
                f"{self.table} tables: ROADMAP.md Queue 2, K1b/K1g")
        if self.mode == "walk":
            raise NotImplementedError("walk mode: ROADMAP.md Queue 2, K1j")
        if self.k != 1 or self.bounded:
            raise NotImplementedError(
                "k > 1 and bounded lookups: ROADMAP.md Queue 2, K1h")


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
            if t.device != keys.device:
                raise ValueError(f"table on {t.device}, keys on {keys.device}")
            if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
                raise ValueError(f"{name} must be a contiguous 1-D int32 tensor")
            if t.numel() < need[name]:
                raise ValueError(f"n={n} needs {name} of {need[name]} words, "
                                 f"not {t.numel()}")
        if algo == "dx" and not (scalars[1] >= 0 and 0 <= scalars[2] < n):
            raise ValueError(f"dx scalars max_probes={scalars[1]}, "
                             f"fallback={scalars[2]} out of range")


def _launch(name: str, keys: torch.Tensor, outs, epochs) -> None:
    """Launch kernel ``name`` on the keys' stream and count it."""
    lib = build.load("engine", _SIGNATURES)
    args = [keys.data_ptr(), *(o.data_ptr() for o in outs), keys.numel()]
    for tables, scalars in epochs:
        args += [t.data_ptr() for t in tables] + [int(s) for s in scalars]
    with torch.cuda.device(keys.device):
        rc = getattr(lib, name)(*args, torch.cuda.current_stream().cuda_stream)
    build.check(lib, rc, name)
    LAUNCHES[name] += 1


def kernel_lookup(algo: str, keys: torch.Tensor, tables, scalars) -> torch.Tensor:
    """Lookup of int32 keys (uint32 bit patterns) → int32 buckets under
    one epoch's ``tables`` and ``scalars`` (registry order).  CPU tensors
    take the plain version; CUDA tensors launch ``{algo}_lookup``."""
    tables, scalars = list(tables), [int(s) for s in scalars]
    _check_operands(algo, keys, [(tables, scalars)])
    if keys.device.type == "cpu":
        return lookup_plain(algo, keys, tables, scalars)
    if keys.device.type != "cuda":
        raise ValueError(f"no kernel for device {keys.device}")
    out = torch.empty_like(keys)
    if keys.numel():
        _launch(f"{algo}_lookup", keys, [out], [(tables, scalars)])
    return out


def kernel_diff(algo: str, keys: torch.Tensor, old, new):
    """Lookup under two epochs (each ``(tables, scalars)``) in one pass →
    (old, new, moved bool).  CUDA tensors launch ``{algo}_diff``."""
    epochs = [(list(t), [int(s) for s in sc]) for t, sc in (old, new)]
    _check_operands(algo, keys, epochs)
    if keys.device.type == "cpu":
        return diff_plain(algo, keys, *epochs)
    if keys.device.type != "cuda":
        raise ValueError(f"no kernel for device {keys.device}")
    o, n, moved = (torch.empty_like(keys) for _ in range(3))
    if keys.numel():
        _launch(f"{algo}_diff", keys, [o, n, moved], epochs)
    return o, n, moved.bool()


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


def engine_lookup(keys, image, *, k: int = 1, device=None) -> torch.Tensor:
    """The batched lookup: keys [K] → int32 [K] buckets, on the image's
    device (``device`` for a tableless image).  Bit-identical to the host
    ``lookup`` of a ``variant="32"`` state."""
    EngineOp(algo=image.algo, k=k)
    dev = _image_device([image], device)
    return kernel_lookup(image.algo, key_tensor(keys, dev), *image_operands(image))


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


def engine_diff(keys, old_image, new_image, *, k: int = 1, device=None) -> EngineDiff:
    """Fused epoch diff: look a key batch up under two images in one
    launch (both epochs' tables resident)."""
    if old_image.algo != new_image.algo:
        raise ValueError("epoch diff requires one algorithm "
                         f"({old_image.algo!r} != {new_image.algo!r})")
    EngineOp(algo=old_image.algo, k=k, diff=True)
    dev = _image_device([old_image, new_image], device)
    old, new, moved = kernel_diff(old_image.algo, key_tensor(keys, dev),
                                  image_operands(old_image), image_operands(new_image))
    return EngineDiff(old, new, moved)
