"""Packed device images: the minimal-memory table layouts (the port's own
copy of the reference's ``core/packing.py``).

* **memento** — a uint32 ``state`` bitmap (bit b = 1 ⇔ bucket b working;
  padding bits working, so growth inside the capacity writes no bitmap
  word) plus the Θ(r) open-addressing replacement table (``slot_b``,
  ``slot_c``) in the narrowest dtype that holds every bucket id.  A
  removed bucket b is found by linear probing from ``fmix32(b·GOLDEN32 +
  5) & mask``; a restore leaves a TOMBSTONE that readers probe past, so
  epoch deltas edit the packed table in place.
* **anchor** — A and K narrowed: both are bounded by the capacity ``a``,
  so int16 holds every a ≤ 32767.
* **dx** — already a bitmap; its words are shared as they are.
* **jump**, **power** — no table: nothing to pack.

Images hold torch tensors, each narrow dtype kept (int16 stays int16);
uint32 ``state`` words are int32 bit patterns (a ``.view``, never a value
conversion).  The host side (:func:`build_slots`, the store's mirror,
:func:`packed_delta_updates`) is numpy, with ``state`` as uint32.
"""
from __future__ import annotations

import numpy as np
import torch

from .hashing import GOLDEN32, np_fmix32
from .protocol import (ALGORITHM_REGISTRY, IMAGE_LAYOUT, DeviceImage,
                       ImageDelta, round_up)

#: slot_b sentinels: EMPTY ends a probe chain, TOMBSTONE (a deleted entry)
#: keeps it going; readers probe past tombstones, writers reuse them.
EMPTY = -1
TOMBSTONE = -2

#: per-algorithm packed layout: (scalar names, table names).  The scalars
#: are the dense layout's; algorithms without a packed encoding of their
#: own share their dense tables.
PACKED_LAYOUT: dict[str, tuple[tuple[str, ...], tuple[str, ...]]] = {
    name: (info.scalars, info.packed_tables
           if info.packed_tables is not None else info.tables)
    for name, info in ALGORITHM_REGISTRY.items()
}


def image_table_names(image) -> tuple[str, ...]:
    """Table names of ``image`` in kernel operand order."""
    layout = PACKED_LAYOUT if image.packed else IMAGE_LAYOUT
    return layout[image.algo][1]


def narrow_dtype(max_value: int) -> np.dtype:
    """Smallest signed dtype holding values in [TOMBSTONE, max_value]."""
    if max_value <= np.iinfo(np.int8).max:
        return np.dtype(np.int8)
    if max_value <= np.iinfo(np.int16).max:
        return np.dtype(np.int16)
    return np.dtype(np.int32)


def image_table_bytes(image) -> int:
    """Bytes of an image's tables on the device (scalars excluded)."""
    return sum(int(a.numel() * a.element_size()) for a in image.arrays.values())


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def host_arrays(image) -> dict[str, np.ndarray]:
    """Numpy copies of an image's arrays; a packed Memento ``state`` as
    uint32 words (the host mirror :func:`packed_delta_updates` edits)."""
    out = {k: np.array(_host(v), copy=True) for k, v in image.arrays.items()}
    if image.packed and image.algo == "memento":
        out["state"] = out["state"].view(np.uint32)
    return out


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(device)


# ---------------------------------------------------------------------------
# Memento: bitmap + open-addressing slots
# ---------------------------------------------------------------------------

def _slot_count(r: int, *, headroom: int = 1) -> int:
    """Power-of-two slot count for r removed buckets: load factor ≤ 0.5 at
    ``headroom=1``, ≤ 0.25 at the store's ``headroom=2`` so deltas insert
    in place."""
    nslots = 128
    while nslots < 2 * max(headroom, 1) * max(r, 1):
        nslots *= 2
    return nslots


def build_slots(repl, *, nslots: int | None = None,
                dtype=np.int32) -> tuple[np.ndarray, np.ndarray]:
    """Dense repl table → open-addressing (slot_b, slot_c) numpy arrays.

    Each round every key not yet placed whose current slot is free claims
    it (the first such key of a slot wins); the rest move one slot on.
    Slots only fill, so every slot a key skipped is occupied in the end:
    a probe from its start finds every key before an empty slot.
    """
    repl = _host(repl)
    removed = np.nonzero(repl >= 0)[0].astype(np.int64)
    r = int(removed.size)
    if nslots is None:
        nslots = _slot_count(r)
    if nslots & (nslots - 1):
        raise ValueError(f"nslots must be a power of two, got {nslots}")
    if nslots < 2 * r:
        raise ValueError(f"load factor > 0.5: {r} entries in {nslots} slots")
    slot_b = np.full((nslots,), EMPTY, dtype)
    slot_c = np.full((nslots,), EMPTY, dtype)
    mask = nslots - 1
    with np.errstate(over="ignore"):
        pos = np_fmix32(removed.astype(np.uint32) * np.uint32(GOLDEN32)
                        + np.uint32(5)).astype(np.int64) & mask
    pending = np.arange(r)
    while pending.size:
        p = pos[pending]
        free = slot_b[p] < 0
        cand = pending[free]
        _, first = np.unique(p[free], return_index=True)
        win = cand[first]
        slot_b[pos[win]] = removed[win].astype(dtype)
        slot_c[pos[win]] = repl[removed[win]].astype(dtype)
        pending = np.setdiff1d(pending, win, assume_unique=True)
        pos[pending] = (pos[pending] + 1) & mask
    return slot_b, slot_c


def _probe_start(b: int, mask: int) -> int:
    with np.errstate(over="ignore"):
        return int(np_fmix32(np.uint32(b) * np.uint32(GOLDEN32)
                             + np.uint32(5))) & mask


def _probe_find(slot_b: np.ndarray, b: int) -> int:
    """Slot index of the live entry ``b``, or −1 (probing past
    tombstones, at most ``len(slot_b)`` slots)."""
    nslots = len(slot_b)
    pos = _probe_start(b, nslots - 1)
    for _ in range(nslots):
        sb = int(slot_b[pos])
        if sb == b:
            return pos
        if sb == EMPTY:
            return -1
        pos = (pos + 1) & (nslots - 1)
    return -1


def _probe_upsert(slot_b: np.ndarray, b: int) -> tuple[int, bool]:
    """(slot index, inserted?) for writing entry ``b``: a live entry is
    updated in place; else the first tombstone on the probe path, else
    the empty slot that ends it, is claimed.  (−1, True) when no slot can
    be reused."""
    nslots = len(slot_b)
    pos = _probe_start(b, nslots - 1)
    first_tomb = -1
    for _ in range(nslots):
        sb = int(slot_b[pos])
        if sb == b:
            return pos, False
        if sb == TOMBSTONE and first_tomb < 0:
            first_tomb = pos
        if sb == EMPTY:
            return (first_tomb if first_tomb >= 0 else pos), True
        pos = (pos + 1) & (nslots - 1)
    return first_tomb, True  # every slot live or a tombstone


# ---------------------------------------------------------------------------
# pack / unpack
# ---------------------------------------------------------------------------

def pack_image(image: DeviceImage, *, slot_headroom: int = 1,
               nslots: int | None = None) -> DeviceImage:
    """Dense image → the packed layout (same epoch, same scalars,
    ``packed=True``), on the dense image's device.  Arrays outside the
    dense layout (a bounded-load ``load`` overlay) pass through.
    ``slot_headroom`` over-provisions the Memento slot table (the store
    packs with 2); ``nslots`` pins its size."""
    if image.packed:
        return image
    devices = {t.device for t in image.arrays.values()}
    device = devices.pop() if len(devices) == 1 else torch.device("cpu")
    arrays: dict[str, np.ndarray] = {}
    if image.algo == "memento":
        repl = _host(image.arrays["repl"])
        pad = repl.shape[0]
        nwords = round_up(-(-pad // 32))
        state = np.full((nwords,), 0xFFFFFFFF, np.uint32)  # all working
        removed = np.nonzero(repl >= 0)[0]
        if removed.size:
            bits = np.zeros((nwords,), np.uint32)
            np.bitwise_or.at(bits, removed >> 5,
                             np.uint32(1) << (removed & 31).astype(np.uint32))
            state &= ~bits
        slot_b, slot_c = build_slots(
            repl, nslots=(nslots if nslots is not None
                          else _slot_count(int(removed.size),
                                           headroom=slot_headroom)),
            dtype=narrow_dtype(pad))
        arrays = {"state": state, "slot_b": slot_b, "slot_c": slot_c}
    elif image.algo == "anchor":
        A, K = _host(image.arrays["A"]), _host(image.arrays["K"])
        dtype = narrow_dtype(int(A.shape[0]))  # stamps ≤ a ≤ pad, ids < pad
        arrays = {"A": A.astype(dtype), "K": K.astype(dtype)}
    elif image.algo == "dx":
        arrays = {"words": _host(image.arrays["words"])}
    elif image.algo not in IMAGE_LAYOUT:
        raise ValueError(f"unknown algo {image.algo!r}")
    # jump and power have no table: nothing to pack
    out = {k: _tensor(v, device) for k, v in arrays.items()}
    handled = set(IMAGE_LAYOUT[image.algo][1])
    for name, arr in image.arrays.items():  # overlays (the "load" words)
        if name not in handled:
            out[name] = arr
    return DeviceImage(algo=image.algo, n=image.n, arrays=out,
                       scalars=dict(image.scalars), epoch=image.epoch,
                       packed=True)


def unpack_image(image: DeviceImage) -> DeviceImage:
    """Packed image → an equivalent dense image.  A Memento ``repl`` has
    the bitmap's capacity (32 × words, padding working); AnchorHash and
    DxHash come back bit for bit."""
    if not image.packed:
        return image
    devices = {t.device for t in image.arrays.values()}
    device = devices.pop() if len(devices) == 1 else torch.device("cpu")
    if image.algo == "memento":
        state = _host(image.arrays["state"]).view(np.uint32)
        slot_b = _host(image.arrays["slot_b"])
        slot_c = _host(image.arrays["slot_c"])
        repl = np.full((32 * state.shape[0],), -1, np.int32)
        live = slot_b >= 0
        repl[slot_b[live].astype(np.int64)] = slot_c[live].astype(np.int32)
        ids = np.arange(repl.shape[0])
        bits = (state[ids >> 5] >> (ids & 31).astype(np.uint32)) & 1
        if not np.array_equal(bits == 0, repl >= 0):
            raise ValueError("packed image inconsistent: bitmap vs slots")
        arrays = {"repl": repl}
    elif image.algo == "anchor":
        arrays = {"A": _host(image.arrays["A"]).astype(np.int32),
                  "K": _host(image.arrays["K"]).astype(np.int32)}
    elif image.algo == "dx":
        arrays = {"words": _host(image.arrays["words"])}
    elif image.algo in PACKED_LAYOUT:
        arrays = {}  # jump, power
    else:
        raise ValueError(f"unknown algo {image.algo!r}")
    out = {k: _tensor(v, device) for k, v in arrays.items()}
    handled = set(PACKED_LAYOUT[image.algo][1])
    for name, arr in image.arrays.items():
        if name not in handled:
            out[name] = arr
    return DeviceImage(algo=image.algo, n=image.n, arrays=out,
                       scalars=dict(image.scalars), epoch=image.epoch)


# ---------------------------------------------------------------------------
# Epoch deltas on the packed layout
# ---------------------------------------------------------------------------

def packed_delta_updates(mirror: dict[str, np.ndarray], delta: ImageDelta,
                         ) -> dict[str, tuple[np.ndarray, np.ndarray]] | None:
    """Translate a dense :class:`ImageDelta` into scatters on the packed
    layout, applying them to the numpy ``mirror`` in place (``state`` as
    uint32).  Returns ``{name: (indices, values)}``, or ``None`` when the
    packed image must be rebuilt: the bitmap is outgrown, the slot table
    has no room, live entries and tombstones would pass the 0.5 load
    factor, or a value outgrows a narrowed dtype.

    Memento's ``repl`` scatter becomes bitmap word edits plus slot
    upserts (removals) and tombstones (restores); every other array
    scatters position for position in its own dtype.
    """
    out: dict[str, tuple[np.ndarray, np.ndarray]] = {}
    if delta.algo == "memento" and "repl" in delta.updates:
        idx, vals = delta.updates["repl"]
        state = mirror["state"]
        slot_b, slot_c = mirror["slot_b"], mirror["slot_c"]
        nslots = len(slot_b)
        fill = int(np.count_nonzero(slot_b != EMPTY))  # live + tombstones
        touched_words: dict[int, None] = {}
        touched_slots: dict[int, None] = {}
        for b, v in zip(np.asarray(idx, np.int64), np.asarray(vals, np.int64)):
            b, v = int(b), int(v)
            if b >= 32 * state.shape[0]:
                return None  # outgrew the bitmap: snapshot
            wi, bit = b >> 5, np.uint32(1) << np.uint32(b & 31)
            if v < 0:  # restored → working: set the bit, tombstone the slot
                state[wi] |= bit
                pos = _probe_find(slot_b, b)
                if pos >= 0:
                    slot_b[pos] = TOMBSTONE
                    slot_c[pos] = EMPTY
                    touched_slots[pos] = None
            else:      # removed (or redirected): clear the bit, upsert
                state[wi] &= ~bit
                pos, inserted = _probe_upsert(slot_b, b)
                if pos < 0:
                    return None  # no slot to reuse: repack
                if inserted and int(slot_b[pos]) == EMPTY:
                    fill += 1
                    if 2 * fill > nslots:
                        return None  # probe-chain bound breached: repack
                slot_b[pos] = b
                slot_c[pos] = v
                touched_slots[pos] = None
            touched_words[wi] = None
        if touched_words:
            w = np.fromiter(touched_words, np.int32, len(touched_words))
            out["state"] = (w, state[w].copy())
        if touched_slots:
            s = np.fromiter(touched_slots, np.int32, len(touched_slots))
            out["slot_b"] = (s, slot_b[s].copy())
            out["slot_c"] = (s.copy(), slot_c[s].copy())
    for name, (idx, vals) in delta.updates.items():
        if name == "repl" and delta.algo == "memento":
            continue
        arr = mirror[name]
        idx = np.asarray(idx, np.int32)
        vals = np.asarray(vals)
        if np.issubdtype(arr.dtype, np.signedinteger) and vals.size and \
                int(vals.max(initial=0)) > np.iinfo(arr.dtype).max:
            return None  # the value outgrew the narrowed dtype: repack
        cast = vals.astype(arr.dtype)
        arr[idx] = cast
        out[name] = (idx, cast)
    return out
