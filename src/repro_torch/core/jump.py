"""JumpHash (Lamping & Veach, 2014), the engine under MementoHash.

* ``jump64``: the paper-faithful 64-bit LCG implementation;
* ``jump32``: the device variant.  Each step's uniform variate comes from a
  murmur3-mixed (key, step) hash and the divide runs in float32, so the
  host agrees bit-for-bit with the CUDA kernel (an IEEE correctly rounded
  f32 divide on both sides).

The stateful ``JumpHash`` class is not part of this slice of the port.
"""
from __future__ import annotations

import numpy as np

from .hashing import GOLDEN32, LCG_MULT, MASK32, MASK64, np_fmix32


def jump64(key: int, num_buckets: int) -> int:
    """Faithful JumpHash: O(ln n), stateless, no memory access."""
    if num_buckets <= 0:
        raise ValueError("num_buckets must be positive")
    key &= MASK64
    b, j = -1, 0
    while j < num_buckets:
        b = j
        key = (key * LCG_MULT + 1) & MASK64
        j = int(float(b + 1) * (float(1 << 31) / float((key >> 33) + 1)))
    return b


def jump32(key: int, num_buckets: int) -> int:
    """Device JumpHash variant (scalar; see :func:`np_jump32`)."""
    out = np_jump32(np.asarray([key & MASK32], dtype=np.uint32), num_buckets)
    return int(out[0])


def _step_u24(keys: np.ndarray, step: int | np.ndarray) -> np.ndarray:
    """Per-(key, step) uniform 24-bit variate (exactly representable in f32)."""
    step = np.asarray(step, dtype=np.uint32)
    with np.errstate(over="ignore"):
        h = np_fmix32(keys ^ (step * np.uint32(GOLDEN32) + np.uint32(0x2545F491)))
    return (h >> np.uint32(8)).astype(np.uint32)


def np_jump32(keys: np.ndarray, num_buckets: int) -> np.ndarray:
    """Vectorized device jump over a uint32 key array.

    ``b ← j; j ← floor((b+1)/r)`` with ``r`` uniform in (0, 1], iterated
    while ``j < n``.  ``r`` is quantized to 24 bits so every intermediate is
    exact in f32.
    """
    if num_buckets <= 0:
        raise ValueError("num_buckets must be positive")
    keys = keys.astype(np.uint32)
    n = np.float32(num_buckets)
    b = np.zeros(keys.shape, dtype=np.int32)
    j = np.zeros(keys.shape, dtype=np.float32)
    i = 0
    active = j < n
    while active.any():
        b = np.where(active, j.astype(np.int32), b)
        u = _step_u24(keys, i)
        r = (u.astype(np.float32) + np.float32(1.0)) * np.float32(2.0 ** -24)
        jn = np.float32(1.0) * (b.astype(np.float32) + np.float32(1.0)) / r
        jn = np.minimum(np.floor(jn), n)  # anything ≥ n terminates
        j = np.where(active, jn, j)
        active = j < n
        i += 1
        if i > 256:  # 24-bit r ⇒ ≤ ~2^24 expansion per step
            raise RuntimeError("jump32 failed to terminate")
    return b
