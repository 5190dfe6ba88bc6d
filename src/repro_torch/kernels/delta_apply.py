"""Epoch-delta apply of the port: an out-of-place scatter of O(changed
words) ``(index, value)`` pairs into a flat device table.

Instead of re-sending an O(n) snapshot after every ``remove()``/``add()``,
the host ships the changed words and the device edits a copy of its
table.  Out of place on purpose: the image store double-buffers epochs,
so the epoch-N table must stay intact (and keep serving lookups) while
epoch N+1 is materialized.

The kernels (``csrc/delta_apply.cu``, :func:`delta_apply`) replace the
reference's Pallas kernel ``_apply_scatter_i32`` and, for the int16 and
int8 tables of packed images, its functional scatter, one entry per
element width (``delta_apply``, ``delta_apply_int16``,
``delta_apply_int8``).  A table of up to :data:`ONE_BLOCK_MAX` elements is
copied and scattered by one block in one launch; a longer one takes a
device-to-device copy, then one thread per update (:func:`apply_form`).  Their
plain torch version is :func:`delta_apply_plain` (an ``index_put`` into a
copy).  The Pallas loop applies updates in order, so the last write wins
on a duplicate index; :func:`scatter_update` keeps that rule by
deduplicating keep-last on the host before either runs.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build

#: the kernel of each table element type
KERNELS = {torch.int32: "delta_apply", torch.int16: "delta_apply_int16",
           torch.int8: "delta_apply_int8"}

#: the longest table (elements) of each type whose kernel copies and
#: scatters it in one launch of one block: a copy of ``csrc/delta_apply.cu``'s
#: ``kOneBlockMaxInt32``, ``…Int16``, ``…Int8``, which choose the form; this
#: one only names it in logs and tests, and a tier-1 test that reads the
#: source keeps the two equal
ONE_BLOCK_MAX = {torch.int32: 1 << 12, torch.int16: 1 << 12, torch.int8: 1 << 15}

#: kernel launches since the last reset (set the values to 0)
LAUNCHES: dict[str, int] = {name: 0 for name in KERNELS.values()}

_SIGNATURES = {
    name: [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
           ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    for name in KERNELS.values()
}


def _pad_updates(idx, vals, sentinel: int, pad_to: int = 8):
    """Pad (idx, vals) to a power-of-two width ≥ ``pad_to``; padded slots
    carry ``sentinel`` as their index (-1 here: it never writes)."""
    k = len(idx)
    width = pad_to
    while width < k:
        width *= 2
    pidx = np.full((width,), sentinel, np.int32)
    pval = np.zeros((width,), np.int32)
    pidx[:k] = idx
    pval[:k] = np.asarray(vals).astype(np.int64).astype(np.int32)
    return pidx, pval, k


def compose_updates(update_seq) -> dict:
    """Last-write-wins composition of a sequence of per-array scatter dicts
    (each ``{name: (idx, vals)}``, in epoch order) into one such dict."""
    merged: dict[str, dict[int, int]] = {}
    for updates in update_seq:
        for name, (idx, vals) in updates.items():
            slots = merged.setdefault(name, {})
            for i, v in zip(np.asarray(idx).tolist(),
                            np.asarray(vals).tolist()):
                slots[i] = v
    return {
        name: (np.fromiter(slots.keys(), np.int32, len(slots)),
               np.fromiter(slots.values(), np.int64,
                           len(slots)).astype(np.int32))
        for name, slots in merged.items()
    }


def dedup_last(idx, vals) -> tuple[np.ndarray, np.ndarray]:
    """Keep the last (idx, val) pair of every index, in the order of those
    last writes: what an in-order loop of the pairs leaves behind."""
    idx = np.asarray(idx).astype(np.int64)
    vals = np.asarray(vals)
    _, first_rev = np.unique(idx[::-1], return_index=True)
    keep = np.sort(len(idx) - 1 - first_rev)
    return idx[keep], vals[keep]


def apply_form(length: int, dtype: torch.dtype) -> str:
    """The form the ``delta_apply`` kernel of ``dtype`` takes for a table of
    ``length`` elements: ``"one block"`` (the copy, then the updates, in one
    launch) up to ``ONE_BLOCK_MAX[dtype]``, else ``"copy and scatter"``."""
    return "one block" if length <= ONE_BLOCK_MAX[dtype] else "copy and scatter"


def delta_apply_plain(table: torch.Tensor, meta: torch.Tensor,
                      count: int) -> torch.Tensor:
    """Plain version of the ``delta_apply`` kernels: a copy of ``table``
    with ``meta = [idx ×P, val ×P]``'s first ``count`` pairs written in,
    values narrowed to the table's dtype; indices outside the table never
    write."""
    pad = meta.numel() // 2
    idx = meta[:count].to(torch.int64)
    vals = meta[pad:pad + count].to(table.dtype)
    ok = (idx >= 0) & (idx < table.numel())
    return table.index_put((idx[ok],), vals[ok])


def delta_apply(table: torch.Tensor, meta: torch.Tensor, count: int) -> torch.Tensor:
    """The ``delta_apply`` kernel of the table's element type (int32,
    int16 or int8) on CUDA tensors (the plain version on CPU tensors).
    The indices among ``meta``'s first ``count`` must be unique."""
    if table.dtype not in KERNELS or table.dim() != 1 or not table.is_contiguous():
        raise ValueError("table must be a contiguous 1-D int32, int16 or int8 tensor")
    if (meta.dtype != torch.int32 or meta.dim() != 1 or meta.numel() % 2
            or not meta.is_contiguous()):
        raise ValueError("meta must be a contiguous 1-D int32 [idx ×P, val ×P] tensor")
    if meta.device != table.device:
        raise ValueError(f"meta on {meta.device}, table on {table.device}")
    if not 0 <= count <= meta.numel() // 2:
        raise ValueError(f"count={count} outside [0, {meta.numel() // 2}]")
    if table.device.type == "cpu":
        return delta_apply_plain(table, meta, count)
    if table.device.type != "cuda":
        raise ValueError(f"no kernel for device {table.device}")
    name = KERNELS[table.dtype]
    out = torch.empty_like(table)
    lib = build.load("delta_apply", _SIGNATURES)
    with torch.cuda.device(table.device):
        rc = getattr(lib, name)(table.data_ptr(), out.data_ptr(), table.numel(),
                                meta.data_ptr(), meta.numel() // 2,
                                count, torch.cuda.current_stream().cuda_stream)
    build.check(lib, rc, name)
    LAUNCHES[name] += 1
    return out


def scatter_update(table: torch.Tensor, idx, vals) -> torch.Tensor:
    """Out-of-place ``table[idx] = vals`` → new tensor on the table's
    device, applied in order (last write wins).  The input is preserved:
    the caller keeps it as the previous-epoch half of its double buffer.
    32-bit tables (uint32 words as int32 bit patterns) and the int16 and
    int8 tables of packed images; values are given as their int32 bit
    patterns (numpy uint32 words ≥ 2**31 included)."""
    if table.dtype not in (torch.int32, torch.uint32, torch.int16, torch.int8):
        raise ValueError(f"no scatter for {table.dtype} tables")
    idx, vals = dedup_last(idx, vals)
    pidx, pval, k = _pad_updates(idx, vals, sentinel=-1)
    # the whole delta rides one host→device copy
    meta = torch.from_numpy(np.concatenate([pidx, pval])).to(table.device)
    if table.element_size() == 4:
        return delta_apply(table.view(torch.int32), meta, k).view(table.dtype)
    return delta_apply(table, meta, k)


def apply_updates(arrays: dict, updates: dict) -> dict:
    """Apply per-array ``{name: (idx, vals)}`` scatters to an image's
    ``arrays`` out of place.  Untouched arrays (and empty update lists)
    pass through by reference: they stay shared with the previous epoch's
    image, which keeps double buffering O(changed words)."""
    out = {}
    for name, arr in arrays.items():
        upd = updates.get(name)
        if upd is not None and len(upd[0]):
            out[name] = scatter_update(arr, upd[0], upd[1])
        else:
            out[name] = arr
    return out
