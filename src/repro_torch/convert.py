"""Carry state across from the reference package, as plain values only.

The port never imports the reference.  These functions take what a caller
reads off a reference object (ints, lists, dicts, numpy arrays) and build
the port's counterpart, so a test can hand the reference's exact state to
the port.  Each host state starts with an empty delta log at ``epoch``:
a store built on it starts from a snapshot.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.anchor import AnchorHash
from repro_torch.core.bounded import BoundedLoad
from repro_torch.core.dx import DxHash
from repro_torch.core.jump import JumpHash
from repro_torch.core.memento import MementoHash
from repro_torch.core.power import PowerHash
from repro_torch.core.protocol import DeviceImage


def _table(a) -> torch.Tensor:
    """A copy of ``a`` as a tensor; uint32 words become int32 bit patterns
    (a view, never a value conversion)."""
    a = np.array(a, copy=True)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a)


def image_from_arrays(algo: str, n: int, arrays: dict[str, np.ndarray],
                      scalars: dict[str, int] | None = None, epoch: int = 0,
                      device="cpu", packed: bool = False) -> DeviceImage:
    """A port :class:`DeviceImage` holding copies of ``arrays`` on
    ``device``, each in its own dtype (a packed image's int16 or int8
    tables stay narrow; uint32 words become int32 bit patterns)."""
    return DeviceImage(
        algo=algo, n=int(n),
        arrays={name: _table(a).to(device) for name, a in arrays.items()},
        scalars={k: int(v) for k, v in (scalars or {}).items()},
        epoch=int(epoch), packed=bool(packed))


def memento_from_state(n: int, l: int, R: dict, variant: str = "32",
                       epoch: int = 0) -> MementoHash:
    """A port :class:`MementoHash` in state ``⟨n, R, l⟩``."""
    m = MementoHash(int(n), variant=variant)
    m.l = int(l)
    m.R = {int(b): (int(c), int(p)) for b, (c, p) in R.items()}
    m._epoch = int(epoch)
    return m


def anchor_from_state(a: int, A, K, W, L, R, N: int, variant: str = "32",
                      epoch: int = 0) -> AnchorHash:
    """A port :class:`AnchorHash` with capacity ``a`` and the arrays
    ``A``, ``K``, ``W``, ``L``, the removal stack ``R`` and ``N`` working
    buckets."""
    h = AnchorHash(int(a), int(a), variant=variant)  # no removals to replay
    h.A, h.K, h.W, h.L = ([int(x) for x in arr] for arr in (A, K, W, L))
    h.R = [int(b) for b in R]
    h.N = int(N)
    h._epoch = int(epoch)
    return h


def dx_from_state(a: int, active, R, fallback: int, variant: str = "32",
                  epoch: int = 0) -> DxHash:
    """A port :class:`DxHash` with capacity ``a``, the working flags
    ``active``, the removal stack ``R`` and the first working bucket
    ``fallback``."""
    h = DxHash(int(a), int(a), variant=variant)
    h.active = bytearray(bytes(active))
    h.N = sum(h.active)
    h.R = [int(b) for b in R]
    h._fallback = int(fallback)
    h._epoch = int(epoch)
    return h


def jump_from_state(n: int, variant: str = "32", epoch: int = 0) -> JumpHash:
    """A port :class:`JumpHash` of ``n`` buckets."""
    h = JumpHash(int(n), variant=variant)
    h._epoch = int(epoch)
    return h


def power_from_state(n: int, variant: str = "32", epoch: int = 0) -> PowerHash:
    """A port :class:`PowerHash` of ``n`` buckets."""
    h = PowerHash(int(n), variant=variant)
    h._epoch = int(epoch)
    return h


def bounded_from_state(inner, c: float, load, assignment: dict,
                       epoch: int = 0) -> BoundedLoad:
    """A port :class:`BoundedLoad` of load factor ``c`` over ``inner`` (a
    port host state, carried across by the functions above), with the
    load words ``load`` and the key → bucket ``assignment``."""
    bl = BoundedLoad(inner, c)
    bl._load = np.array(load, dtype=np.int32, copy=True)
    bl.assignment = {int(k): int(b) for k, b in assignment.items()}
    bl._epoch = int(epoch)
    return bl
