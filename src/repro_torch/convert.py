"""Carry state across from the reference package, as plain values only.

The port never imports the reference.  These functions take what a caller
reads off a reference object (ints, dicts, numpy arrays) and build the
port's counterpart, so a test can hand the reference's exact state to the
port.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.memento import MementoHash
from repro_torch.core.protocol import DeviceImage


def image_from_arrays(algo: str, n: int, arrays: dict[str, np.ndarray],
                      scalars: dict[str, int] | None = None, epoch: int = 0,
                      device="cpu") -> DeviceImage:
    """A port :class:`DeviceImage` holding copies of ``arrays`` on
    ``device``."""
    return DeviceImage(
        algo=algo, n=int(n),
        arrays={name: torch.from_numpy(np.array(a, copy=True)).to(device)
                for name, a in arrays.items()},
        scalars={k: int(v) for k, v in (scalars or {}).items()},
        epoch=int(epoch))


def memento_from_state(n: int, l: int, R: dict, variant: str = "32",
                       epoch: int = 0) -> MementoHash:
    """A port host :class:`MementoHash` in state ``⟨n, R, l⟩`` at
    ``epoch``, with an empty delta log: a store built on it starts from a
    snapshot."""
    m = MementoHash(int(n), variant=variant)
    m.l = int(l)
    m.R = {int(b): (int(c), int(p)) for b, (c, p) in R.items()}
    m._epoch = int(epoch)
    return m
