"""DxHash (Dong & Wang, 2021): a bitmap of working buckets and
pseudo-random probing (the port's own copy of the reference module).

Fixed overall capacity ``a``.  A lookup draws ``hash(key, 0), hash(key,
1), …`` mod ``a`` and returns the first working bucket: O(a/w) expected
probes.  After ``max_probes`` misses it returns ``fallback``, the first
working bucket, which the host keeps up to date and ships as a scalar of
every delta.  A removal stack gives the order in which ``add`` restores.
"""
from __future__ import annotations

import numpy as np
import torch

from .hashing import MASK32, MASK64, hash2_32, hash2_64
from .protocol import DeltaEmitter, DeviceImage, ReplicatedLookup, round_up


class DxHash(ReplicatedLookup, DeltaEmitter):
    name = "dx"

    _MAX_PROBE_FACTOR = 64  # probe bound = factor · ⌈a/w⌉, then fallback

    def __init__(self, capacity: int, initial_node_count: int, variant: str = "64"):
        if not (0 < initial_node_count <= capacity):
            raise ValueError("need 0 < initial_node_count <= capacity")
        if variant == "64":
            self._hash2, self._mask = hash2_64, MASK64
        elif variant == "32":
            # the kernels' arithmetic: bit-identical to the device
            self._hash2, self._mask = hash2_32, MASK32
        else:
            raise ValueError(f"unknown variant {variant!r}")
        self.variant = variant
        self.a = capacity
        self.N = initial_node_count
        self.active = bytearray([1] * initial_node_count + [0] * (capacity - initial_node_count))
        self.R: list[int] = list(range(capacity - 1, initial_node_count - 1, -1))
        self._fallback = 0  # first working bucket (bucket 0 starts active)
        self._init_delta_log()

    def _word(self, wi: int) -> int:
        """Bitmap word ``wi``: bit b&31 of buckets 32wi … 32wi+31."""
        base = wi << 5
        return sum(self.active[j] << (j - base)
                   for j in range(base, min(base + 32, self.a)))

    def remove(self, b: int) -> None:
        if not (0 <= b < self.a) or not self.active[b]:
            raise ValueError(f"bucket {b} is not working")
        if self.N == 1:
            raise ValueError("cannot remove the last working bucket")
        self.active[b] = 0
        self.R.append(b)
        self.N -= 1
        if b == self._fallback:
            # everything below b is inactive: resume the scan at b+1
            self._fallback = self.active.index(1, b + 1)
        self._record({"words": {b >> 5: self._word(b >> 5)}}, self.a,
                     self._image_scalars())

    def add(self) -> int:
        if not self.R:
            raise ValueError("DxHash capacity exhausted (fixed a)")
        b = self.R.pop()
        self.active[b] = 1
        self.N += 1
        self._fallback = min(self._fallback, b)
        self._record({"words": {b >> 5: self._word(b >> 5)}}, self.a,
                     self._image_scalars())
        return b

    def _image_n(self) -> int:
        return self.a

    def _image_scalars(self) -> dict[str, int]:
        return {"max_probes": self.max_probes(), "fallback": self._fallback}

    def max_probes(self) -> int:
        """Probe bound before the first-working fallback: 64·⌈a/w⌉."""
        return self._MAX_PROBE_FACTOR * max(1, (self.a + self.N - 1) // self.N)

    def lookup(self, key: int) -> int:
        return self.lookup_trace(key)[0]

    def lookup_trace(self, key: int) -> tuple[int, int, int]:
        """Lookup returning (bucket, probes past the first, 0)."""
        key &= self._mask
        a, active = self.a, self.active
        for i in range(self.max_probes()):
            b = self._hash2(key, i) % a
            if active[b]:
                return b, i, 0
        return active.index(1), self.max_probes(), 0  # first working bucket

    def device_image(self, capacity: int | None = None) -> DeviceImage:
        """The bitmap (bucket b is bit b&31 of word b>>5; uint32 words held
        as int32 bit patterns) on the CPU, with the probe bound and the
        first working bucket as scalars.  ``capacity`` is accepted for the
        protocol; ``a`` is fixed."""
        bits = np.frombuffer(bytes(self.active), dtype=np.uint8)
        words = np.zeros((round_up(-(-self.a // 32)) * 32,), dtype=np.uint8)
        words[: self.a] = bits
        words = np.packbits(words.reshape(-1, 32), axis=1, bitorder="little")
        return DeviceImage(
            algo=self.name, n=self.a,
            arrays={"words": torch.from_numpy(words.view("<i4").reshape(-1))},
            scalars=self._image_scalars(), epoch=self._epoch)

    @property
    def size(self) -> int:
        return self.a

    @property
    def working(self) -> int:
        return self.N

    def is_working(self, b: int) -> bool:
        return 0 <= b < self.a and bool(self.active[b])

    def working_set(self) -> set[int]:
        return {b for b in range(self.a) if self.active[b]}

    def memory_bytes(self) -> int:
        """Θ(a): the bitmap and the free-slot stack."""
        return (self.a + 7) // 8 + 4 * len(self.R) + 8
