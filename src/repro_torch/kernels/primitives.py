"""Device hash primitives as plain torch ops: the arithmetic of the CUDA
kernels (``csrc/engine.cu``) written lane-synchronously over tensors.

uint32 words are carried as int64 tensors masked to ``[0, 2**32)``: torch
has no ``>>``, ``%`` or ``<`` for ``torch.uint32`` on the CPU, and an int64
product of two such words wraps, but its low 32 bits stay exact.
Bit-identical to the numpy host plane (``repro_torch.core.hashing``,
``repro_torch.core.jump``) and to the kernels.
"""
from __future__ import annotations

import torch

from repro_torch.core.hashing import _C1_32, _C2_32, GOLDEN32, MASK32
from repro_torch.core.jump import STEP_SALT
from repro_torch.core.power import POWER_SALT, POWER_TRY_CAP


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """Integer tensor (int32 bit patterns or int64) → uint32 words carried
    as int64."""
    return x.to(torch.int64) & MASK32


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """Murmur3 32-bit finalizer over int64-carried uint32 words."""
    h = h & MASK32
    h = h ^ (h >> 16)
    h = (h * _C1_32) & MASK32
    h = h ^ (h >> 13)
    h = (h * _C2_32) & MASK32
    return h ^ (h >> 16)


def hash2(keys: torch.Tensor, seed) -> torch.Tensor:
    """(key, seed) hash: paper Alg. 4's ``hash(k, b)``; ``seed`` is an int
    or a tensor of non-negative ints (e.g. bucket ids)."""
    s = fmix32((seed * GOLDEN32 + 1) & MASK32)
    return fmix32(keys ^ s)


def step_u24(keys: torch.Tensor, step: int) -> torch.Tensor:
    """Per-(key, step) uniform 24-bit variate, exactly representable in f32."""
    return fmix32(keys ^ ((step * GOLDEN32 + STEP_SALT) & MASK32)) >> 8


def jump32(keys: torch.Tensor, n: int, work: dict | None = None) -> torch.Tensor:
    """Device JumpHash: ``b ← j; j ← ⌊(b+1)/r⌋`` with ``r`` uniform in
    (0, 1], while ``j < n``.  The divide is a correctly rounded f32 divide
    (no fast math on either side).  Returns int64 buckets.  ``work``, if
    given, gains ``"step"``: the lane-steps this batch ran."""
    nf = torch.tensor(float(n), dtype=torch.float32, device=keys.device)
    b = torch.zeros(keys.shape, dtype=torch.int64, device=keys.device)
    j = torch.zeros(keys.shape, dtype=torch.float32, device=keys.device)
    active = j < nf
    i = 0
    while bool(active.any()):
        if work is not None:
            work["step"] = work.get("step", 0) + int(active.sum())
        b = torch.where(active, j.to(torch.int64), b)
        r = (step_u24(keys, i).to(torch.float32) + 1.0) * 2.0 ** -24
        jn = torch.minimum(torch.floor((b.to(torch.float32) + 1.0) / r), nf)
        j = torch.where(active, jn, j)
        active = j < nf
        i += 1
    return b


def power32(keys: torch.Tensor, n: int, work: dict | None = None) -> torch.Tensor:
    """Device PowerHash: the level descent of ``repro_torch.core.power``,
    lane-synchronous.  The top level ``L = ⌊log2(n−1)⌋`` comes from an
    integer shift loop (no float log); the top level redraws while
    ``v ≥ n``, at most ``POWER_TRY_CAP`` draws in all; lanes still below
    ``2^L`` descend one full level per step.  Returns int64 buckets.
    ``work``, if given, gains ``"draw"`` (extra top-level draws) and
    ``"level"`` (levels descended), counted over lanes."""
    L = 0
    while ((n - 1) >> (L + 1)) > 0:
        L += 1
    hi_mask = (1 << (L + 1)) - 1
    base = POWER_SALT + (L << 6)
    v = hash2(keys, base) & hi_mask
    redo = v >= n
    t = 1
    while t < POWER_TRY_CAP and bool(redo.any()):
        if work is not None:
            work["draw"] = work.get("draw", 0) + int(redo.sum())
        v = torch.where(redo, hash2(keys, base + t) & hi_mask, v)
        redo = v >= n
        t += 1
    out = torch.where((v < n) & (v >= (1 << L)), v, -1)
    j = L - 1
    while j >= 0 and bool((out < 0).any()):
        pending = out < 0
        if work is not None:
            work["level"] = work.get("level", 0) + int(pending.sum())
        cand = hash2(keys, POWER_SALT + (j << 6)) & ((1 << (j + 1)) - 1)
        out = torch.where(pending & (cand >= (1 << j)), cand, out)
        j -= 1
    return torch.where(out < 0, 0, out)


def gather1d(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather of a flat table by an index tensor of any shape (int64 out)."""
    return table.reshape(-1)[idx].to(torch.int64)
