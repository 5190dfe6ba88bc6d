"""MementoTables: a dense repl table of a MementoHash state, mirrored on
the host one event at a time (the port's own copy of the reference's
``core/tables.py``).

The host keeps the paper's Θ(r) replacement set ``R = {b: (c, p)}``;
bulk lookups read one flat int32 array instead::

    repl[b] = c   if b was removed   (c = |W_b|, Prop. V.3)
    repl[b] = -1  if b is working

``repl`` has a fixed ``capacity`` ≥ 2n (128-padded), so its shape stays
stable while the cluster grows; ``n`` travels as a scalar.  The device
path keeps its tables through epoch deltas
(:class:`~repro_torch.core.image_store.DeviceImageStore`); this mirror is
what :func:`repro_torch.kernels.ops.lookup_from_tables` reads.
"""
from __future__ import annotations

import numpy as np
import torch

from .memento import MementoHash
from .protocol import DeviceImage, round_up as _round_up


class MementoTables:
    def __init__(self, memento: MementoHash, capacity: int | None = None):
        n = memento.n
        cap = _round_up(max(capacity or 0, 2 * n, 128))
        self.capacity = cap
        self.repl = np.full((cap,), -1, dtype=np.int32)
        for b, (c, _p) in memento.R.items():
            self.repl[b] = c
        self.n = n
        self.version = 0
        self._m = memento

    # -- O(1) mirrors of Alg. 2 / Alg. 3 ----------------------------------------
    def on_remove(self, b: int) -> None:
        """Call right after ``memento.remove(b)``."""
        m = self._m
        if b in m.R:
            self.repl[b] = m.R[b][0]
        self.n = m.n
        self.version += 1

    def on_add(self, b: int) -> None:
        """Call right after ``memento.add()`` returned ``b``."""
        m = self._m
        if self.n == m.n:  # a restored bucket
            self.repl[b] = -1
        elif m.n > self.capacity:  # appended past the capacity
            self._grow()
        self.n = m.n
        self.version += 1

    def _grow(self) -> None:
        new_cap = _round_up(2 * self.capacity)
        repl = np.full((new_cap,), -1, dtype=np.int32)
        repl[: self.capacity] = self.repl
        self.repl = repl
        self.capacity = new_cap
        self.version += 1

    def image(self) -> DeviceImage:
        """The mirrored table as an image on the CPU (shares ``repl``)."""
        return DeviceImage(algo="memento", n=self.n,
                           arrays={"repl": torch.from_numpy(self.repl)})

    def check(self) -> None:
        """Consistency with the host state."""
        m = self._m
        assert self.n == m.n
        for b in range(self.n):
            if b in m.R:
                assert self.repl[b] == m.R[b][0]
            else:
                assert self.repl[b] == -1


def tables_from_state(n: int, R: dict[int, tuple[int, int]],
                      capacity: int | None = None) -> tuple[np.ndarray, int]:
    """A standalone ``(repl, n)`` from a raw state ``⟨n, R⟩``."""
    cap = _round_up(max(capacity or 0, n, 128))
    repl = np.full((cap,), -1, dtype=np.int32)
    for b, (c, _p) in R.items():
        repl[b] = c
    return repl, n
