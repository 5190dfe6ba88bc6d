"""PowerHash (Leu 2023, arXiv 2307.12448): O(1) expected lookups with no
fixed cluster capacity (the port's own copy of the reference module).

A power-of-two level descent.  Buckets are the prefix ``[0, n)`` (``add``
appends bucket ``n``, ``remove`` is LIFO only), split into levels: level
``j`` holds ``[2^j, 2^(j+1))`` and the top level ``L = ⌊log2(n−1)⌋`` is
cut at ``n``.  A lookup draws one uniform variate per level from salted
hashes, starting at the top:

* **top level**: redraw ``v ← hash(key, salt(L, t)) & (2^(L+1)−1)`` for
  ``t = 0, 1, …`` until ``v < n`` (at most ``POWER_TRY_CAP`` draws, then
  descend); accept ``v ≥ 2^L``, else descend;
* **full levels** ``j = L−1 … 0``: one draw ``hash(key, salt(j, 0)) &
  (2^(j+1)−1)``; accept ``v ≥ 2^j``, else descend.  Past level 0 the
  bucket is 0.

``variant="32"`` draws from ``hash2_32``, bit-identical to the plain
``power32`` of ``repro_torch.kernels.primitives`` and to the CUDA kernel.
The device image is just the dynamic ``n``.
"""
from __future__ import annotations

from .hashing import hash2_32, hash2_64
from .protocol import DeltaEmitter, DeviceImage, ReplicatedLookup

#: salt offset of the level-descent draws: ``salt = POWER_SALT +
#: (level << 6) + try``
POWER_SALT = 0x506F5748  # "PoWH"

#: top-level rejection draws at most; exhausting them descends instead
POWER_TRY_CAP = 64


def power_lookup_with(h2, key: int, n: int) -> tuple[int, int, int]:
    """One level-descent lookup under hash ``h2(key, salt)``: ``(bucket,
    extra top-level draws, levels descended)``."""
    if n <= 0:
        raise ValueError("n must be positive")
    if n == 1:
        return 0, 0, 0
    L = (n - 1).bit_length() - 1          # top level: buckets [2^L, n)
    hi_mask = (1 << (L + 1)) - 1
    base = POWER_SALT + (L << 6)
    tries = 0
    v = h2(key, base) & hi_mask
    while v >= n and tries + 1 < POWER_TRY_CAP:
        tries += 1
        v = h2(key, base + tries) & hi_mask
    if n > v >= (1 << L):
        return v, tries, 0
    levels = 0
    for j in range(L - 1, -1, -1):
        levels += 1
        v = h2(key, POWER_SALT + (j << 6)) & ((1 << (j + 1)) - 1)
        if v >= (1 << j):
            return v, tries, levels
    return 0, tries, levels


def power64(key: int, num_buckets: int) -> int:
    """64-bit PowerHash lookup (host-only flavour)."""
    return power_lookup_with(hash2_64, key, num_buckets)[0]


def power32(key: int, num_buckets: int) -> int:
    """Device PowerHash lookup, bit-identical to the kernel."""
    return power_lookup_with(hash2_32, key, num_buckets)[0]


class PowerHash(ReplicatedLookup, DeltaEmitter):
    """Stateful PowerHash with the uniform engine API (LIFO-only
    resizes)."""

    name = "power"

    def __init__(self, initial_node_count: int, variant: str = "64"):
        if initial_node_count <= 0:
            raise ValueError("initial_node_count must be positive")
        if variant == "64":
            self._h2 = hash2_64
        elif variant == "32":
            self._h2 = hash2_32
        else:
            raise ValueError(f"unknown variant {variant!r}")
        self.variant = variant
        self.n = initial_node_count
        self._init_delta_log()

    def lookup(self, key: int) -> int:
        return power_lookup_with(self._h2, key, self.n)[0]

    def lookup_trace(self, key: int) -> tuple[int, int, int]:
        """(bucket, extra top-level draws, levels descended)."""
        return power_lookup_with(self._h2, key, self.n)

    def add(self) -> int:
        self.n += 1
        self._record({}, self.n)  # the whole delta is the new n
        return self.n - 1

    def remove(self, b: int) -> None:
        if b != self.n - 1:
            raise ValueError("PowerHash only supports LIFO removals")
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
        """Tableless: the image is the dynamic n (lookup = power32)."""
        return DeviceImage(algo=self.name, n=self.n, epoch=self._epoch)
