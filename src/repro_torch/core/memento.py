"""MementoHash (paper Algs. 1-4), host control plane of the port.

State ``S = ⟨n, R, l⟩``: ``n`` the size of the b-array, ``R`` the
replacement set ``{b: (c, p)}`` (Θ(r) memory), ``l`` the last removed
bucket (``l = n`` when ``R`` is empty).  ``variant="64"`` is the
paper-faithful engine; ``variant="32"`` uses ``jump32``/``hash2_32``, the
arithmetic of the CUDA lookup kernel, so host and device agree exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from .hashing import MASK32, MASK64, hash2_32, hash2_64
from .jump import jump32, jump64
from .protocol import DeltaEmitter, DeviceImage, ReplicatedLookup, round_up


class MementoHash(ReplicatedLookup, DeltaEmitter):
    name = "memento"

    def __init__(self, initial_node_count: int, variant: str = "64"):
        if initial_node_count <= 0:
            raise ValueError("initial_node_count must be positive")
        # Alg. 1 (Init).
        self.n = initial_node_count
        self.l = self.n
        self.R: dict[int, tuple[int, int]] = {}
        self.variant = variant
        self._init_delta_log()
        if variant == "64":
            self._jump, self._hash2, self._mask = jump64, hash2_64, MASK64
        elif variant == "32":
            self._jump, self._hash2, self._mask = jump32, hash2_32, MASK32
        else:
            raise ValueError(f"unknown variant {variant!r}")

    @property
    def size(self) -> int:
        """Size of the b-array (paper's n)."""
        return self.n

    @property
    def working(self) -> int:
        """Number of working buckets w = n − r (Prop. V.6)."""
        return self.n - len(self.R)

    def is_working(self, b: int) -> bool:
        return 0 <= b < self.n and b not in self.R

    def working_set(self) -> set[int]:
        return {b for b in range(self.n) if b not in self.R}

    def memory_bytes(self) -> int:
        """Θ(r): one ⟨b → c, p⟩ tuple per removed bucket (3 × int32) + ⟨n, l⟩."""
        return 8 + 12 * len(self.R)

    # -- Alg. 2 (Remove) ------------------------------------------------------
    def remove(self, b: int) -> None:
        if not self.is_working(b):
            raise ValueError(f"bucket {b} is not a working bucket")
        if self.working == 1:
            raise ValueError("cannot remove the last working bucket")
        if b == self.n - 1 and not self.R:
            # LIFO removal: shrink the b-array; repl[n-1] stays -1, so the
            # delta is just the new n.
            self.n -= 1
            self.l = self.n
            self._record({}, self.n)
        else:
            w = self.working  # before this removal
            self.R[b] = (w - 1, self.l)  # ⟨b → w−1, l⟩ (Prop. V.3: c = new w)
            self.l = b
            self._record({"repl": {b: w - 1}}, self.n)

    # -- Alg. 3 (Add) ---------------------------------------------------------
    def add(self) -> int:
        if not self.R:
            b = self.n  # append to the tail; repl beyond the old n is -1
            self.n += 1
            self.l = self.n
            self._record({}, self.n)
            return b
        b = self.l  # restore the last removed bucket
        _, p = self.R.pop(b)
        self.l = p
        self._record({"repl": {b: -1}}, self.n)
        return b

    def _image_n(self) -> int:
        return self.n

    def device_image(self, capacity: int | None = None) -> DeviceImage:
        """Dense repl image on the CPU: ``repl[b] = |W_b|`` if ``b`` was
        removed, else -1.  ``capacity`` asks for headroom (still
        128-padded) so deltas can grow ``n`` without reallocating."""
        repl = np.full((round_up(max(self.n, capacity or 0)),), -1, dtype=np.int32)
        if self.R:
            idx = np.fromiter(self.R.keys(), np.int64, len(self.R))
            repl[idx] = np.fromiter((c for c, _p in self.R.values()),
                                    np.int32, len(self.R))
        return DeviceImage(algo=self.name, n=self.n,
                           arrays={"repl": torch.from_numpy(repl)},
                           epoch=self._epoch)

    # -- Alg. 4 (Lookup) -------------------------------------------------------
    def lookup(self, key) -> int:
        key &= self._mask
        b = self._jump(key, self.n)
        R = self.R
        while b in R:
            wb = R[b][0]  # working buckets after b was removed (Prop. V.3)
            d = self._hash2(key, b) % wb
            # follow the replacement chain only while u ≥ w_b (balance)
            while d in R and R[d][0] >= wb:
                d = R[d][0]
            b = d
        return b

    def lookup_trace(self, key) -> tuple[int, int, int]:
        """Lookup returning (bucket, Alg. 4 iterations, chain reads)."""
        key &= self._mask
        b = self._jump(key, self.n)
        R = self.R
        ext = inn = 0
        while b in R:
            ext += 1
            wb = R[b][0]
            d = self._hash2(key, b) % wb
            while d in R and R[d][0] >= wb:
                inn += 1
                d = R[d][0]
            b = d
        return b, ext, inn


def random_state(
    rng: np.random.Generator, n0: int, removals: int, variant: str = "64"
) -> MementoHash:
    """A MementoHash after ``removals`` random (not LIFO-biased) removals."""
    m = MementoHash(n0, variant=variant)
    for _ in range(removals):
        working = sorted(m.working_set())
        m.remove(working[int(rng.integers(len(working)))])
    return m
