"""JumpHash (Lamping & Veach, 2014), the engine under MementoHash.

* ``jump64``: the paper-faithful 64-bit LCG implementation;
* ``jump32``: the device variant.  Each step's uniform variate comes from a
  murmur3-mixed (key, step) hash and the divide runs in float32, so the
  host agrees bit-for-bit with the CUDA kernel (an IEEE correctly rounded
  f32 divide on both sides).

``JumpHash`` is the stateful wrapper (LIFO-only resizes) whose device
image is just the dynamic ``n``.
"""
from __future__ import annotations

import numpy as np

from .hashing import GOLDEN32, LCG_MULT, MASK32, MASK64, fmix32, np_fmix32
from .protocol import DeltaEmitter, DeviceImage, ReplicatedLookup

#: per-step salt of the jump32 variate stream
STEP_SALT = 0x2545F491


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
    """Device JumpHash variant for one key: :func:`np_jump32`'s steps on
    numpy float32 scalars (each add, divide and floor rounded as in f32)."""
    if num_buckets <= 0:
        raise ValueError("num_buckets must be positive")
    key &= MASK32
    n = np.float32(num_buckets)
    b, j, i = 0, np.float32(0.0), 0
    while j < n:
        b = int(j)
        u = fmix32(key ^ ((i * GOLDEN32 + STEP_SALT) & MASK32)) >> 8
        r = np.float32(u + 1) * np.float32(2.0 ** -24)  # exact: u + 1 ≤ 2^24
        j = min(np.floor((np.float32(b) + np.float32(1.0)) / r), n)
        i += 1
        if i > 256:
            raise RuntimeError("jump32 failed to terminate")
    return b


def _step_u24(keys: np.ndarray, step: int | np.ndarray) -> np.ndarray:
    """Per-(key, step) uniform 24-bit variate (exactly representable in f32)."""
    step = np.asarray(step, dtype=np.uint32)
    with np.errstate(over="ignore"):
        h = np_fmix32(keys ^ (step * np.uint32(GOLDEN32) + np.uint32(STEP_SALT)))
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


class JumpHash(ReplicatedLookup, DeltaEmitter):
    """Stateful JumpHash with the uniform engine API (LIFO-only resizes)."""

    name = "jump"

    def __init__(self, initial_node_count: int, variant: str = "64"):
        if initial_node_count <= 0:
            raise ValueError("initial_node_count must be positive")
        if variant == "64":
            self._fn = jump64
        elif variant == "32":
            self._fn = jump32
        else:
            raise ValueError(f"unknown variant {variant!r}")
        self.variant = variant
        self.n = initial_node_count
        self._init_delta_log()

    def lookup(self, key: int) -> int:
        return self._fn(key, self.n)

    def lookup_trace(self, key: int) -> tuple[int, int, int]:
        """Jump has no replacement walk: its steps are internal to the
        jump, so both counts are 0."""
        return self.lookup(key), 0, 0

    def add(self) -> int:
        self.n += 1
        self._record({}, self.n)  # the whole delta is the new n
        return self.n - 1

    def remove(self, b: int) -> None:
        if b != self.n - 1:
            raise ValueError("JumpHash only supports LIFO removals")
        if self.n == 1:
            raise ValueError("cannot remove the last bucket")
        self.n -= 1
        self._record({}, self.n)

    def _image_n(self) -> int:
        return self.n

    @property
    def size(self) -> int:
        return self.n

    @property
    def working(self) -> int:
        return self.n

    def working_set(self) -> set[int]:
        return set(range(self.n))

    def memory_bytes(self) -> int:
        return 8  # a single counter

    def device_image(self, capacity: int | None = None) -> DeviceImage:
        """Tableless: the image is the dynamic n (lookup = jump32)."""
        return DeviceImage(algo=self.name, n=self.n, epoch=self._epoch)
