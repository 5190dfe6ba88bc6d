"""AnchorHash (Mendelson et al., 2020), in-place variant (the port's own
copy of the reference module).

Fixed overall capacity ``a``; every bucket, working or removed, is
tracked by four int arrays (Θ(a) memory):

  * ``A[b]``: 0 if ``b`` is working, else the working-set size right
    after ``b`` was removed (removal stamps are strictly decreasing),
  * ``W[0..N-1]``: the working buckets (order kept by swap-removal),
  * ``L[b]``: the index of working bucket ``b`` in ``W``,
  * ``K[b]``: the bucket that replaced ``b`` in ``W`` when ``b`` was
    removed (the successor the lookup's inner loop follows).

Additions restore the most recent removal (a removal stack).  The device
image is ``(A, K)``; ``W`` and ``L`` stay on the host.
"""
from __future__ import annotations

import numpy as np
import torch

from .hashing import MASK32, MASK64, fmix32, fmix64, hash2_32, hash2_64
from .protocol import DeltaEmitter, DeviceImage, ReplicatedLookup, round_up


class AnchorHash(ReplicatedLookup, DeltaEmitter):
    name = "anchor"

    def __init__(self, capacity: int, initial_node_count: int, variant: str = "64"):
        if not (0 < initial_node_count <= capacity):
            raise ValueError("need 0 < initial_node_count <= capacity")
        if variant == "64":
            self._fmix, self._hash2, self._mask = fmix64, hash2_64, MASK64
        elif variant == "32":
            # the kernels' arithmetic: bit-identical to the device
            self._fmix, self._hash2, self._mask = fmix32, hash2_32, MASK32
        else:
            raise ValueError(f"unknown variant {variant!r}")
        self.variant = variant
        a = capacity
        self.a = a
        self.N = a
        self.A = [0] * a
        self.W = list(range(a))
        self.L = list(range(a))
        self.K = list(range(a))
        self.R: list[int] = []  # removal stack
        self._init_delta_log()
        for b in range(a - 1, initial_node_count - 1, -1):
            self.remove(b)

    # -- resource management ---------------------------------------------------
    def remove(self, b: int) -> None:
        if not (0 <= b < self.a) or self.A[b] != 0:
            raise ValueError(f"bucket {b} is not working")
        if self.N == 1:
            raise ValueError("cannot remove the last working bucket")
        self.R.append(b)
        self.N -= 1
        N = self.N
        self.A[b] = N
        moved = self.W[N]
        pos = self.L[b]
        self.W[pos] = moved
        self.L[moved] = pos
        self.K[b] = moved
        self._record({"A": {b: N}, "K": {b: moved}}, self.a)

    def add(self) -> int:
        if not self.R:
            raise ValueError("AnchorHash capacity exhausted (fixed a)")
        b = self.R.pop()
        N = self.N
        moved = self.K[b]
        pos = self.L[moved]
        self.W[N] = moved
        self.L[moved] = N
        self.W[pos] = b
        self.L[b] = pos
        self.A[b] = 0
        self.K[b] = b
        self.N += 1
        self._record({"A": {b: 0}, "K": {b: b}}, self.a)
        return b

    def _image_n(self) -> int:
        return self.a

    # -- lookup -----------------------------------------------------------------
    def lookup(self, key: int) -> int:
        return self.lookup_trace(key)[0]

    def lookup_trace(self, key: int) -> tuple[int, int, int]:
        """Lookup returning (bucket, outer iterations, successor reads)."""
        key &= self._mask
        A, K = self.A, self.K
        b = self._fmix(key) % self.a
        ext = inn = 0
        while A[b] > 0:  # b is removed
            ext += 1
            h = self._hash2(key, b) % A[b]
            while A[h] >= A[b]:  # h removed at or after b: step back in time
                inn += 1
                h = K[h]
            b = h
        return b, ext, inn

    def device_image(self, capacity: int | None = None) -> DeviceImage:
        """The (A, K) image on the CPU.  A lookup reads only indices < a,
        so the 128-padding (``K[pad] = pad``, ``A[pad] = 0``) is never
        read.  ``capacity`` is accepted for the protocol; ``a`` is fixed."""
        pad = round_up(max(self.a, capacity or 0))
        A = np.zeros((pad,), dtype=np.int32)
        A[: self.a] = self.A
        K = np.arange(pad, dtype=np.int32)
        K[: self.a] = self.K
        return DeviceImage(algo=self.name, n=self.a,
                           arrays={"A": torch.from_numpy(A), "K": torch.from_numpy(K)},
                           epoch=self._epoch)

    # -- introspection -------------------------------------------------------------
    @property
    def size(self) -> int:
        return self.a

    @property
    def working(self) -> int:
        return self.N

    def is_working(self, b: int) -> bool:
        return 0 <= b < self.a and self.A[b] == 0

    def working_set(self) -> set[int]:
        return set(self.W[: self.N])

    def memory_bytes(self) -> int:
        """Θ(a): four int32 arrays and the removal stack."""
        return 16 * self.a + 4 * len(self.R) + 8
