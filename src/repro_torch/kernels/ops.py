"""Public lookup wrappers of the port (the reference's ``kernels/ops.py``).

:func:`device_lookup` takes any :class:`~repro_torch.core.protocol.DeviceImage`
(every algorithm, dense or packed) and runs the matching engine
configuration: one kernel launch for CUDA tensors, the plain torch
version for CPU tensors.  :func:`memento_lookup` is the raw-array Alg. 4
lookup over a dense ``repl`` table or, with ``table="compact"``, over the
Θ(r) open-addressing table built from it on the host.

Table layouts (``table``): ``"dense"`` (default); ``"packed"``, picked
by a packed image itself; ``"compact"`` (Memento only).  The port has one
execution path per tensor device, so the reference's ``plane=`` and its
autotuner (``plane="auto"``, ``ROADMAP.md`` Queue 1) are not taken; the
reference's ``"jnp"`` table of :func:`memento_lookup` is the dense lookup
(the plain version on CPU tensors, the kernel on CUDA ones).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from . import engine as _engine


def device_lookup(keys, image, *, table: str = "dense", k: int = 1, load=None,
                  cap: int | None = None, device=None) -> torch.Tensor:
    """Batched lookup over any image: keys [K] → working bucket ids int32
    [K], or [K, k] replica sets for ``k > 1``; with ``load``/``cap`` every
    returned bucket is also below the load cap.  On the image's device
    (``device`` for a tableless image)."""
    if table not in ("dense", "packed") and image.algo != "memento":
        raise ValueError(f"unknown table kind {table!r} for {image.algo!r}")
    return _engine.engine_lookup(keys, image, k=k, load=load, cap=cap, table=table,
                                 device=device)


def memento_lookup(keys, repl, n: int, *, table: str = "dense",
                   device=None) -> torch.Tensor:
    """Batched Alg. 4 lookup: uint32 keys [K] → working bucket ids int32
    [K], on ``repl``'s device if it is a tensor, else on ``device``
    (default: the GPU)."""
    if table not in ("jnp", "dense", "compact"):
        raise ValueError(f"unknown table kind {table!r}")
    if isinstance(repl, torch.Tensor):
        dev = repl.device if device is None else resolve_device(device)
        repl = repl.to(dev)
    else:
        dev = resolve_device(device)
        repl = torch.from_numpy(np.ascontiguousarray(np.asarray(repl, np.int32))).to(dev)
    keys = _engine.key_tensor(keys, dev)
    if table == "compact":
        slot_b, slot_c = _engine.build_compact_table(repl)
        return _engine.compact_lookup(keys, slot_b, slot_c, n)
    return _engine.memento_lookup(keys, repl, n)


def lookup_from_tables(keys, tables, **kw) -> torch.Tensor:
    """Route against a host :class:`~repro_torch.core.tables.MementoTables`."""
    return memento_lookup(keys, tables.repl, tables.n, **kw)
