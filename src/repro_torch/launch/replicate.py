"""Cross-process delta replication of the port: one membership owner, N
converging followers (the port's own copy of the reference's
``launch/replicate.py``).

The **leader** owns the host consistent-hash state and publishes each
epoch advance as a flat int32 **frame**; **followers** hold no host state,
only a :class:`FollowerImageStore` that replays frames into a device
image through the same out-of-place scatter the leader's
:class:`~repro_torch.core.image_store.DeviceImageStore` runs
(:func:`repro_torch.kernels.delta_apply.apply_updates`: the
``delta_apply`` kernels on the card).  Both sides apply the same words in
the same epoch order, so followers reach the leader's epoch with
bit-identical images (:func:`~repro_torch.core.protocol.image_fingerprint`).

Frame kinds: ``DELTA`` (O(changed words) scatter pairs per array, chained
onto the follower's epoch), ``DELTA_BATCH`` (the same layout over a range
of epochs, composed last-write-wins), ``SNAPSHOT`` (the padded dense
arrays) and ``SNAPSHOT_PACKED`` (the packed layout of
:mod:`repro_torch.core.packing`, installed with no dense decode).  Every
frame carries a CRC32 word; a corrupt or truncated frame is refused before
any word reaches a scatter.

Frames equal the reference package's word for word on the same host
state.  Where the reference holds uint32 words (DxHash's ``words``, a
packed Memento ``state``) the port holds their int32 bit patterns: the
codec ships those arrays with the uint32 tag, and a follower views them
back as int32 tensors.

Fan-out: :class:`LoopbackChannel` and :class:`ReplicationGroup` replicate
in one process (flat, or relayed through a d-ary :class:`TreeTopology`),
with targeted catch-up for a lagging or newly attached follower.
:class:`DistributedBroadcast` and :class:`TreeBroadcast` move frames
between processes with ``torch.distributed.broadcast`` of CPU int32
tensors (gloo) after :func:`repro_torch.launch.mesh.init_distributed`.
Frames are host vectors, so gloo carries them whatever device the images
live on.  There is no NCCL path: an NCCL group needs one card a rank, and
two processes on one card cannot join one.

Telemetry (:mod:`repro_torch.obs`): ``registry=`` on the publisher, the
follower and the group receives the reference's ``repl.*`` instruments:
``repl.encode`` and ``repl.frames_encoded{kind}``, ``repl.catchup_serves``;
``repl.drain`` with the applied, installed, delta and stale counters and
the ``repl.follower_epoch`` gauge, ``repl.follower_lookup_keys``; and the
group's ``repl.publish > repl.encode, repl.relay > repl.apply > repl.drain``
tree, wire counters, ``repl.follower_lag{follower}``/``follower_lag_max``
gauges, a ``publish`` sink event a round, and the catch-up and attach
counters.  A group records even with telemetry off (its lag gauges are
its API), on a private registry.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.image_store import delta_fits
from repro_torch.core.packing import (PACKED_LAYOUT, host_arrays, pack_image,
                                      packed_delta_updates, unpack_image)
from repro_torch.core.protocol import (ALGORITHM_REGISTRY, ALGORITHMS, IMAGE_LAYOUT,
                                       DeviceImage, ImageDelta, image_fingerprint,
                                       round_up)
from repro_torch.device import resolve_device
from repro_torch.kernels.delta_apply import apply_updates, compose_updates
from repro_torch.kernels.engine import engine_lookup
from repro_torch.obs.metrics import default_registry as _default_obs
from repro_torch.obs.metrics import ensure_real

#: frame type tags
KIND_DELTA = 1
KIND_SNAPSHOT = 2
KIND_DELTA_BATCH = 3
KIND_SNAPSHOT_PACKED = 4

_DELTA_KINDS = (KIND_DELTA, KIND_DELTA_BATCH)
_SNAPSHOT_KINDS = (KIND_SNAPSHOT, KIND_SNAPSHOT_PACKED)

_MAGIC = 0x4D454D30  # "MEM0"
# wire algo ids are registry order (append-only, so ids stay stable)
_ALGO_IDS = {name: i for i, name in enumerate(ALGORITHMS)}
_ALGO_NAMES = {v: k for k, v in _ALGO_IDS.items()}

#: wire dtype enum of snapshot blocks (packed layouts narrow below int32)
_DTYPES = {0: np.dtype(np.int32), 1: np.dtype(np.uint32),
           2: np.dtype(np.int16), 3: np.dtype(np.int8)}
_DTYPE_IDS = {v: k for k, v in _DTYPES.items()}

#: header flag bits
_FLAG_PACKED = 1


def _array_names(algo: str, packed: bool = False) -> list[str]:
    """The wire's array-name table (name id = position): the layout's
    tables, then the bounded-load overlay ``load``."""
    layout = PACKED_LAYOUT if packed else IMAGE_LAYOUT
    return list(layout[algo][1]) + ["load"]


def _scalar_names(algo: str) -> tuple[str, ...]:
    return IMAGE_LAYOUT[algo][0]


def _uint32_names(algo: str, packed: bool) -> tuple[str, ...]:
    """Arrays of uint32 words, which the port holds as int32 bit patterns."""
    if algo == "dx":
        return ("words",)
    return ("state",) if packed and algo == "memento" else ()


def _wire_array(algo: str, packed: bool, name: str, arr) -> np.ndarray:
    """An image array as the numpy array the wire encodes (uint32 words
    as uint32)."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    arr = np.ascontiguousarray(arr)
    if name in _uint32_names(algo, packed) and arr.dtype == np.int32:
        arr = arr.view(np.uint32)
    return arr


# -- wire format --------------------------------------------------------------
# frame = [MAGIC, kind, algo_id, base_epoch, epoch, n, n_extra_scalars,
#          n_blocks, flags, crc, extra_scalars..., blocks...]    (all int32)
# DELTA/DELTA_BATCH block: [name_id, count,  idx[count], vals[count]]
# SNAPSHOT block: [name_id, length, dtype, nwords,  words[nwords]]
#   dtype: 0=i32 1=u32 2=i16 3=i8 (narrow arrays are zero-padded to
#   4-byte multiples and shipped as int32 words)
# flags: bit 0 = packed layout (name ids index PACKED_LAYOUT tables).
# crc: CRC32 of the whole frame with the crc word zeroed.
_HDR = 10
_CRC_SLOT = 9


def stamp_crc(frame: np.ndarray) -> np.ndarray:
    """Stamp the header CRC32 word in place (and return the frame); public
    so a test that tampers with a header field can re-stamp it."""
    frame[_CRC_SLOT] = 0
    crc = zlib.crc32(frame.tobytes()) & 0xFFFFFFFF
    frame[_CRC_SLOT] = np.array([crc], np.uint32).view(np.int32)[0]
    return frame


def _check_crc(buf: np.ndarray) -> None:
    stored = int(np.array([buf[_CRC_SLOT]], np.int32).view(np.uint32)[0])
    clean = buf.copy()
    clean[_CRC_SLOT] = 0
    if (zlib.crc32(clean.tobytes()) & 0xFFFFFFFF) != stored:
        raise ValueError("frame CRC mismatch (corrupt or truncated frame)")


def _wire_words(arr: np.ndarray) -> tuple[np.ndarray, int, int]:
    """(int32 words, dtype id, element length) of a snapshot block."""
    arr = np.ascontiguousarray(arr)
    dt = _DTYPE_IDS.get(arr.dtype)
    if dt is None:
        raise ValueError(f"array dtype {arr.dtype} has no wire encoding")
    raw = arr.tobytes()
    if len(raw) % 4:
        raw += b"\0" * (4 - len(raw) % 4)
    return np.frombuffer(raw, np.int32), dt, arr.shape[0]


def encode_delta(delta: ImageDelta, *, packed: bool = False) -> np.ndarray:
    """Delta → one flat int32 frame (O(changed words)): ``DELTA`` for one
    epoch, ``DELTA_BATCH`` for a composition of several.  ``packed=True``
    flags update names of the packed layout."""
    scal = [int(delta.scalars[s]) for s in _scalar_names(delta.algo)[1:]]
    names = _array_names(delta.algo, packed)
    body: list[np.ndarray] = []
    blocks = 0
    for name, (idx, vals) in sorted(delta.updates.items()):
        if not len(idx):
            continue
        blocks += 1
        head = np.asarray([names.index(name), len(idx)], np.int32)
        body += [head, np.asarray(idx, np.int32),
                 np.asarray(vals).astype(np.int64).astype(np.int32)]
    kind = KIND_DELTA_BATCH if delta.events > 1 else KIND_DELTA
    flags = _FLAG_PACKED if packed else 0
    hdr = np.asarray([_MAGIC, kind, _ALGO_IDS[delta.algo],
                      delta.base_epoch, delta.epoch, delta.n,
                      len(scal), blocks, flags, 0] + scal, np.int32)
    return stamp_crc(np.concatenate([hdr] + body) if body else hdr)


def encode_snapshot(image: DeviceImage) -> np.ndarray:
    """Full (padded) image → one flat int32 frame: ``SNAPSHOT``, or
    ``SNAPSHOT_PACKED`` for a packed image (its bitmap and slot tables,
    narrow dtypes riding the block's dtype tag)."""
    scal = [int(image.scalars[s]) for s in _scalar_names(image.algo)[1:]]
    names = _array_names(image.algo, image.packed)
    body: list[np.ndarray] = []
    for name in sorted(image.arrays):
        arr = _wire_array(image.algo, image.packed, name, image.arrays[name])
        words, dt, length = _wire_words(arr)
        body += [np.asarray([names.index(name), length, dt, len(words)], np.int32), words]
    kind = KIND_SNAPSHOT_PACKED if image.packed else KIND_SNAPSHOT
    flags = _FLAG_PACKED if image.packed else 0
    hdr = np.asarray([_MAGIC, kind, _ALGO_IDS[image.algo],
                      0, image.epoch, image.n,
                      len(scal), len(image.arrays), flags, 0] + scal, np.int32)
    return stamp_crc(np.concatenate([hdr] + body))


@dataclass
class Frame:
    """A decoded (CRC-verified) replication frame."""

    kind: int
    algo: str
    base_epoch: int
    epoch: int
    n: int
    scalars: dict[str, int]
    # DELTA/DELTA_BATCH: name → (idx, vals); SNAPSHOT*: name → numpy array
    updates: dict
    arrays: dict
    packed: bool = False


def decode_frame(buf: np.ndarray) -> Frame:
    buf = np.asarray(buf, np.int32)
    if len(buf) < _HDR or buf[0] != _MAGIC:
        raise ValueError("not a replication frame")
    _check_crc(buf)
    kind, algo_id = int(buf[1]), int(buf[2])
    if kind not in _DELTA_KINDS + _SNAPSHOT_KINDS:
        raise ValueError(f"unknown frame kind {kind}")
    if algo_id not in _ALGO_NAMES:
        raise ValueError(f"unknown wire algo id {algo_id} "
                         f"(this build knows 0..{len(_ALGO_NAMES) - 1})")
    algo = _ALGO_NAMES[algo_id]
    base_epoch, epoch, n = int(buf[3]), int(buf[4]), int(buf[5])
    n_scal, n_blocks = int(buf[6]), int(buf[7])
    packed = bool(int(buf[8]) & _FLAG_PACKED)
    scal_names = _scalar_names(algo)[1:]
    scalars = {scal_names[i]: int(buf[_HDR + i]) for i in range(n_scal)}
    names = _array_names(algo, packed)
    pos = _HDR + n_scal
    updates: dict = {}
    arrays: dict = {}
    for _ in range(n_blocks):
        if kind in _DELTA_KINDS:
            name, count = names[int(buf[pos])], int(buf[pos + 1])
            pos += 2
            idx = np.array(buf[pos: pos + count], np.int32)
            vals = np.array(buf[pos + count: pos + 2 * count], np.int32)
            pos += 2 * count
            updates[name] = (idx, vals)
        else:
            name, length, dt, nwords = (names[int(buf[pos])], int(buf[pos + 1]),
                                        int(buf[pos + 2]), int(buf[pos + 3]))
            pos += 4
            dtype = _DTYPES[dt]
            raw = np.ascontiguousarray(buf[pos: pos + nwords]).tobytes()
            arrays[name] = np.frombuffer(raw[: length * dtype.itemsize], dtype).copy()
            pos += nwords
    if pos != len(buf):
        raise ValueError(f"trailing bytes in frame ({pos} != {len(buf)})")
    return Frame(kind=kind, algo=algo, base_epoch=base_epoch, epoch=epoch,
                 n=n, scalars=scalars, updates=updates, arrays=arrays,
                 packed=packed)


def _peek_kind(buf) -> int:
    return int(np.asarray(buf, np.int32)[1])


def _peek_base(buf) -> int:
    return int(np.asarray(buf, np.int32)[3])


# -- leader side --------------------------------------------------------------
class DeltaPublisher:
    """Leader-side cursor over the host state's bounded delta log.

    ``frames()`` returns the frames that advance followers from the last
    published epoch to the host's current one.  ``batch_epochs``: 0 (the
    default) composes all pending epochs into one ``DELTA_BATCH`` a call,
    1 ships one ``DELTA`` an epoch, N chunks the range into batches of at
    most N epochs.  ``packed=True`` keeps a host numpy mirror of the
    packed arrays and turns every dense delta into packed-layout scatters
    (:func:`~repro_torch.core.packing.packed_delta_updates`), so snapshots
    ship as ``SNAPSHOT_PACKED``.  A snapshot goes out on the first
    publish, when the delta log no longer covers the published epoch,
    when growth outruns the capacity the last snapshot announced
    (:func:`~repro_torch.core.image_store.delta_fits`, the leader store's
    own predicate), or when the packed mirror cannot absorb a delta.  The
    publisher, not each follower, decides, so every follower replays the
    same frames.

    Published delta payloads stay in a bounded log: :meth:`catchup_frames`
    composes it into one ``DELTA_BATCH`` for a lagging follower, or falls
    back to a snapshot at the announced capacities.
    """

    _CATCHUP_LOG_CAP = 512

    def __init__(self, ch, *, headroom: int = 2, batch_epochs: int = 0,
                 packed: bool = False, registry=None):
        self._ch = ch
        self._registry = registry  # None → follow the process default
        self.headroom = max(1, headroom)
        self.batch_epochs = max(0, int(batch_epochs))
        self.packed = bool(packed)
        self._epoch: int | None = None  # nothing published yet
        self._caps: dict[str, int] = {}  # capacities the last snapshot shipped
        self._snap_cap: int | None = None  # dense capacity last announced
        self._mirror: dict[str, np.ndarray] | None = None
        # published delta payloads since the last snapshot, oldest first:
        # (base, epoch, wire updates, n, scalars)
        self._log: list[tuple] = []

    def _obs(self):
        """The live telemetry registry (injected, else process default)."""
        return self._registry or _default_obs()

    @property
    def published_epoch(self) -> int | None:  # obs-exempt: pure accessor
        return self._epoch

    @property
    def _algo(self) -> str:
        return getattr(self._ch, "image_algo", self._ch.name)

    def _snapshot_frame(self) -> np.ndarray:
        """Build, announce and encode a stream snapshot (resets the
        capacity announcement, the packed mirror and the catch-up log)."""
        algo = self._algo
        if not ALGORITHM_REGISTRY[algo].fixed_capacity:
            cap = round_up(max(self.headroom * self._ch.size, 128))  # the store's rule
        else:
            cap = None
        img = self._ch.device_image(capacity=cap)
        if self.packed:
            # slot headroom 2: a load factor ≤ 0.25, as the leader store's
            # compact mode, so stream deltas insert in place
            img = pack_image(img, slot_headroom=2)
            self._mirror = host_arrays(img)
        self._caps = {k: int(v.shape[0]) for k, v in img.arrays.items()}
        self._snap_cap = cap
        self._epoch = img.epoch
        self._log.clear()
        return encode_snapshot(img)

    def _range_delta(self, base: int, until: int) -> ImageDelta | None:
        if hasattr(self._ch, "device_delta_range"):
            return self._ch.device_delta_range(base, until)
        if until == getattr(self._ch, "epoch", None):  # an emitter without ranges
            return self._ch.device_delta(base)
        return None

    def frames(self) -> list[np.ndarray]:
        """Frames advancing subscribers to the current host epoch (empty
        when it is published already)."""
        reg = self._obs()
        with reg.span("repl.encode"):
            out = self._encode_frames()
        if reg.active and out:
            for buf in out:
                kind = "snapshot" if _peek_kind(buf) in _SNAPSHOT_KINDS else "delta"
                reg.counter("repl.frames_encoded", kind=kind).inc()
        return out

    def _encode_frames(self) -> list[np.ndarray]:
        cur = getattr(self._ch, "epoch", None)
        if self._epoch is None:
            return [self._snapshot_frame()]
        if cur is None or cur == self._epoch:
            return []
        out: list[np.ndarray] = []
        base = self._epoch
        step = self.batch_epochs or (cur - base)
        while base < cur:
            until = min(base + step, cur)
            delta = self._range_delta(base, until)
            if delta is None or not delta_fits(self._caps, delta, compact=self.packed):
                return [self._snapshot_frame()]  # the leader decides
            if self.packed:
                updates = packed_delta_updates(self._mirror, delta)
                if updates is None:  # slots, bitmap or dtype outgrown: repack
                    return [self._snapshot_frame()]
                wire = ImageDelta(algo=delta.algo, base_epoch=base, epoch=until,
                                  n=delta.n, updates=updates, scalars=dict(delta.scalars))
            else:
                wire = delta
            out.append(encode_delta(wire, packed=self.packed))
            self._log.append((base, until, wire.updates, wire.n, dict(wire.scalars)))
            if len(self._log) > self._CATCHUP_LOG_CAP:
                del self._log[: len(self._log) // 2]
            self._epoch = until
            base = until
        return out

    # -- targeted catch-up (the pull path) -----------------------------------
    def catchup_frames(self, follower_epoch: int) -> list[np.ndarray]:
        """Frames landing a follower at ``follower_epoch`` exactly on the
        published cursor: one composed ``DELTA_BATCH`` when the published
        log still chains from that epoch, else a snapshot at the announced
        capacities (never a new announcement, so the stream's deltas keep
        fitting every follower)."""
        if self._epoch is None:
            raise ValueError("nothing published yet (no cursor to target)")
        cur = getattr(self._ch, "epoch", None)
        if cur is not None and cur != self._epoch:
            raise ValueError("pending epochs unpublished: publish the "
                             "stream (frames()) before serving catch-up")
        if follower_epoch == self._epoch:
            return []
        if follower_epoch > self._epoch:
            raise ValueError(f"follower epoch {follower_epoch} is ahead of "
                             f"the published cursor {self._epoch}")
        self._obs().counter("repl.catchup_serves").inc()
        start = next((i for i, ent in enumerate(self._log) if ent[0] == follower_epoch), None)
        if start is not None:
            tail = self._log[start:]
            updates = compose_updates(u for _b, _e, u, _n, _s in tail)
            _b, until, _u, n, scalars = tail[-1]
            wire = ImageDelta(algo=self._algo, base_epoch=follower_epoch, epoch=until,
                              n=n, updates=updates, scalars=dict(scalars))
            return [encode_delta(wire, packed=self.packed)]
        return [self._catchup_snapshot()]

    def _catchup_snapshot(self) -> np.ndarray:
        """A snapshot at the published cursor and announced capacities.
        Packed, it ships the mirror as it is: the slot table's probe
        layout depends on its history (tombstones), so a new packing would
        differ from what the stream's followers hold."""
        algo = self._algo
        if self.packed and self._mirror is not None:
            ref = self._ch.device_delta(self._epoch)  # empty: n and scalars
            img = DeviceImage(algo=algo, n=ref.n,
                              arrays={k: v.copy() for k, v in self._mirror.items()},
                              scalars=dict(ref.scalars), epoch=self._epoch, packed=True)
            return encode_snapshot(img)
        cap = None if ALGORITHM_REGISTRY[algo].fixed_capacity else self._snap_cap
        return encode_snapshot(self._ch.device_image(capacity=cap))


# -- follower side ------------------------------------------------------------
class FollowerImageStore:
    """A device image driven by replication frames alone, on ``device``
    (default: the GPU; with no GPU it raises unless the caller passes
    ``device="cpu"``).

    Snapshot frames install a new image (a packed one with no dense
    decode); delta frames scatter onto the current one through
    :func:`~repro_torch.kernels.delta_apply.apply_updates`, out of place,
    and the new image replaces the front in one assignment, so a lookup in
    flight keeps its epoch.  :meth:`apply_frames` drains a batch: the
    newest snapshot first, then deltas by ``(base, epoch)``; frames at or
    below the resulting epoch skip as stale; the rest must chain with no
    gap and land as one composed scatter.  ``fingerprint()`` hashes a
    packed image's dense equivalent, so compact and dense followers of one
    leader fingerprint equal.  ``compact``: ``True`` takes packed frames
    only, ``False`` dense only, ``None`` whatever the leader sends.
    ``registry`` is the telemetry registry (``None``: the process default).
    """

    def __init__(self, *, device=None, compact: bool | None = None, registry=None):
        self.device = resolve_device(device)
        self.compact = compact
        self._registry = registry  # None → follow the process default
        self._front: DeviceImage | None = None
        self.frames_applied = 0
        self.snapshots = 0
        self.deltas = 0
        self.batches = 0        # multi-epoch DELTA_BATCH frames applied
        self.stale_skipped = 0  # dropped as stale (epoch ≤ current)

    def _obs(self):
        """The live telemetry registry (injected, else process default)."""
        return self._registry or _default_obs()

    @property
    def epoch(self) -> int:  # obs-exempt: pure accessor
        return -1 if self._front is None else self._front.epoch

    def image(self) -> DeviceImage:  # obs-exempt: pure accessor
        if self._front is None:
            raise ValueError("no snapshot received yet")
        return self._front

    def fingerprint(self) -> str:  # obs-exempt: host-side hash, no wire
        """Convergence fingerprint; a packed image hashes its dense
        equivalent (unpacked on the host)."""
        img = self.image()
        if img.packed:
            img = unpack_image(DeviceImage(
                algo=img.algo, n=img.n, arrays={k: v.cpu() for k, v in img.arrays.items()},
                scalars=dict(img.scalars), epoch=img.epoch, packed=True))
        return image_fingerprint(img)

    # -- frame application ---------------------------------------------------
    def apply_frame(self, buf: np.ndarray) -> None:
        # obs-exempt: delegates to apply_frames (instrumented)
        self.apply_frames([buf])

    def apply_frames(self, bufs: list[np.ndarray]) -> int:
        """Apply one drained batch of frames; returns how many landed.  A
        chain with a real gap (a base epoch no frame of the batch reaches)
        raises: reordering repairs shuffles, not losses."""
        reg = self._obs()
        before = (self.snapshots, self.deltas, self.stale_skipped)
        with reg.span("repl.drain", n_frames=len(bufs)):
            applied = self._drain(bufs)
        if reg.active:
            reg.counter("repl.frames_applied").inc(applied)
            reg.counter("repl.snapshots_installed").inc(self.snapshots - before[0])
            reg.counter("repl.deltas_applied").inc(self.deltas - before[1])
            reg.counter("repl.stale_skipped").inc(self.stale_skipped - before[2])
            reg.gauge("repl.follower_epoch").set(self.epoch)
        return applied

    def _drain(self, bufs: list[np.ndarray]) -> int:
        frames = [decode_frame(b) for b in bufs]
        if not frames:
            return 0
        applied = 0
        snaps = [f for f in frames if f.kind in _SNAPSHOT_KINDS]
        if snaps:
            best = max(snaps, key=lambda f: f.epoch)
            if best.epoch > self.epoch:
                self._install_snapshot(best)
                applied += 1
            self.stale_skipped += len(snaps) - (1 if applied else 0)
        live: list[Frame] = []
        for f in sorted((f for f in frames if f.kind in _DELTA_KINDS),
                        key=lambda f: (f.base_epoch, f.epoch)):
            if f.epoch <= self.epoch:
                self.stale_skipped += 1
                continue
            live.append(f)
        if live:
            applied += self._apply_chain(live)
        self.frames_applied += applied
        return applied

    def _apply_chain(self, live: list[Frame]) -> int:
        if self._front is None:
            raise ValueError("DELTA frame before any SNAPSHOT")
        cur = self._front.epoch
        chain: list[Frame] = []
        for f in live:
            if f.algo != self._front.algo:
                raise ValueError(f"frame algo {f.algo!r} != {self._front.algo!r}")
            if f.packed != self._front.packed:
                raise ValueError(f"frame layout packed={f.packed} != follower "
                                 f"layout packed={self._front.packed}")
            if f.epoch <= cur:  # covered by an earlier frame of this drain
                self.stale_skipped += 1
                continue
            if f.base_epoch > cur:
                raise ValueError(f"frame base epoch {f.base_epoch} != "
                                 f"follower epoch {cur}")
            # base ≤ cur < epoch: an overlap is fine, frames carry absolute
            # values, so a covered prefix is rewritten with newer finals
            chain.append(f)
            cur = f.epoch
        if not chain:
            return 0
        updates = (chain[0].updates if len(chain) == 1
                   else compose_updates(f.updates for f in chain))
        last = chain[-1]
        arrays = apply_updates(self._front.arrays, updates)
        self._front = DeviceImage(algo=last.algo, n=last.n, arrays=arrays,
                                  scalars=last.scalars, epoch=last.epoch,
                                  packed=self._front.packed)
        self.deltas += len(chain)
        self.batches += sum(f.kind == KIND_DELTA_BATCH for f in chain)
        return len(chain)

    def _install_snapshot(self, f: Frame) -> None:
        packed = f.kind == KIND_SNAPSHOT_PACKED
        if self.compact is True and not packed:
            raise ValueError("compact follower received a dense SNAPSHOT")
        if self.compact is False and packed:
            raise ValueError("dense follower received a SNAPSHOT_PACKED")
        arrays = {}
        for name, a in f.arrays.items():
            if a.dtype == np.uint32:
                a = a.view(np.int32)
            arrays[name] = torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
        self._front = DeviceImage(algo=f.algo, n=f.n, arrays=arrays, scalars=f.scalars,
                                  epoch=f.epoch, packed=packed)
        self.snapshots += 1

    def lookup(self, keys, *, k: int = 1, **kw) -> np.ndarray:
        """Bulk lookup against the replicated image on the follower's
        device (``engine_lookup``: a packed image runs its packed
        kernels), as numpy."""
        reg = self._obs()
        kw.setdefault("device", self.device)
        out = engine_lookup(keys, self.image(), k=k, **kw).cpu().numpy()
        if reg.active:
            reg.counter("repl.follower_lookup_keys").inc(int(out.shape[0]))
        return out


# -- topology -----------------------------------------------------------------
class TreeTopology:
    """d-ary relay tree over node ids (heap order): node 0 is the leader,
    follower j is node j+1, ``children(i) = a·i+1 … a·i+a``.  Ascending
    node id is breadth-first order, so delivering in that order lets every
    interior follower apply a round before relaying it to its children.
    The leader pays O(arity) sends a publish instead of O(F)."""

    def __init__(self, num_followers: int, *, arity: int = 2):
        if arity < 1:
            raise ValueError("tree arity must be ≥ 1")
        self.arity = int(arity)
        self.nodes = int(num_followers) + 1  # node 0 = leader

    def children(self, node: int) -> list[int]:
        lo = self.arity * node + 1
        return list(range(lo, min(lo + self.arity, self.nodes)))

    def parent(self, node: int) -> int:
        return (node - 1) // self.arity if node > 0 else -1

    def interior(self) -> list[int]:
        """Nodes with children, in breadth-first order: the relay schedule
        and the round sources of :class:`TreeBroadcast`."""
        return [i for i in range(self.nodes) if self.children(i)]

    @property
    def depth(self) -> int:
        """Relay hops from the leader to the deepest follower."""
        d, node = 0, self.nodes - 1
        while node > 0:
            node = self.parent(node)
            d += 1
        return d


# -- transports ---------------------------------------------------------------
class LoopbackChannel:
    """In-process frame queue."""

    def __init__(self):
        self._q: list[np.ndarray] = []

    def publish(self, frames: list[np.ndarray]) -> None:
        self._q.extend(np.array(f, np.int32) for f in frames)

    def drain(self) -> list[np.ndarray]:
        out, self._q = self._q, []
        return out


def _pack_payload(frames: list[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    """Frames → (fixed-shape header, length-prefixed payload): every rank
    must know a broadcast's shape before the payload size is known, hence
    two hops."""
    frames = [np.asarray(f, np.int32) for f in frames]
    if frames:
        payload = np.concatenate([np.concatenate([np.asarray([len(f)], np.int32), f])
                                  for f in frames])
    else:
        payload = np.zeros((0,), np.int32)
    return np.asarray([len(frames), len(payload)], np.int32), payload


def _split_payload(payload: np.ndarray, n_frames: int) -> list[np.ndarray]:
    out, pos = [], 0
    for _ in range(n_frames):
        ln = int(payload[pos])
        out.append(np.array(payload[pos + 1: pos + 1 + ln]))
        pos += 1 + ln
    return out


def _broadcast_round(frames: list[np.ndarray] | None, src: int) -> list[np.ndarray]:
    """One two-hop round from rank ``src``: the ``[n_frames, total]``
    header, then the exact payload, each a ``torch.distributed.broadcast``
    of a CPU int32 tensor.  Collective: every rank calls it."""
    import torch.distributed as dist

    hdr, payload = _pack_payload(frames or [])
    hdr_t = torch.from_numpy(hdr)
    dist.broadcast(hdr_t, src=src)
    n_frames, total = int(hdr_t[0]), int(hdr_t[1])
    if n_frames == 0:
        return []
    if dist.get_rank() == src:
        pay_t = torch.from_numpy(payload)
    else:
        pay_t = torch.zeros((total,), dtype=torch.int32)
    dist.broadcast(pay_t, src=src)
    return _split_payload(pay_t.numpy(), n_frames)


class DistributedBroadcast:
    """Leader → every process over the ``torch.distributed`` group
    (:func:`repro_torch.launch.mesh.init_distributed` first).
    ``exchange`` is collective: every rank calls it each round, the leader
    with its frames, the others with none, and each gets the leader's."""

    def __init__(self, *, leader: int = 0):
        self.leader = leader

    def exchange(self, frames: list[np.ndarray] | None = None) -> list[np.ndarray]:
        return _broadcast_round(frames, self.leader)


class TreeBroadcast:
    """Tree relay over the ``torch.distributed`` group: rank = tree node
    (rank 0 leads).  ``exchange`` runs one round a interior node, in
    breadth-first order, sourced by that node: the leader seeds its
    children, then each interior follower re-broadcasts the frames it
    received.  Every rank joins every round, but only a round's children
    keep its frames, so each follower applies the flat transport's bytes."""

    def __init__(self, *, arity: int = 2, leader: int = 0):
        if leader != 0:
            raise ValueError("tree transport pins the leader to process 0")
        self.arity = max(1, int(arity))

    def exchange(self, frames: list[np.ndarray] | None = None) -> list[np.ndarray]:
        import torch.distributed as dist

        nproc, pid = dist.get_world_size(), dist.get_rank()
        tree = TreeTopology(nproc - 1, arity=self.arity)
        mine = [np.asarray(f, np.int32) for f in (frames or [])] if pid == 0 else []
        received: list[np.ndarray] = []
        for src in tree.interior():
            got = _broadcast_round(mine if pid == src else [], src)
            if tree.parent(pid) == src:
                received = got
                mine = got  # relayed as it is in this node's own round
        return received


# -- the in-process group -----------------------------------------------------
@dataclass
class WireStats:
    """Cumulative wire accounting of one :class:`ReplicationGroup`: frames
    the publisher encoded, and sends and bytes split into what the leader
    paid and what crossed any link (relays included)."""

    publishes: int = 0
    frames: int = 0          # distinct frames the publisher encoded
    leader_sends: int = 0    # frame transmissions the leader performed
    total_sends: int = 0     # every transmission, relays included
    leader_bytes: int = 0
    total_bytes: int = 0
    catchup_frames: int = 0  # targeted pull-path frames served
    catchup_bytes: int = 0


class ReplicationGroup:
    """Leader and in-process followers in one handle (the scenario
    driver's ``followers=`` mode), the followers on ``device`` (default:
    the GPU).  ``publish()`` ships the pending epochs to every online
    follower and returns each follower's lag (epochs behind before this
    round).  ``topology="tree"`` relays through interior followers;
    ``batch_epochs`` and ``packed`` shape the publisher's stream.
    ``set_online(i, False)`` partitions follower ``i``; once back, the
    next delivery that finds its gap repairs it by the targeted catch-up
    pull (or :meth:`catch_up`).  ``stats`` accumulates the wire
    accounting, ``last_publish`` holds the latest round's.  ``telemetry``
    is the registry the group, its publisher and its followers record on:
    ``registry`` (else the process default) when it is live, else a
    private one, since the lag gauges are part of the group's API."""

    def __init__(self, ch, num_followers: int = 1, *, device=None, headroom: int = 2,
                 topology: str = "flat", arity: int = 2, batch_epochs: int = 0,
                 packed: bool = False, registry=None):
        if topology not in ("flat", "tree"):
            raise ValueError(f"unknown topology {topology!r}")
        self.device = resolve_device(device)
        self.telemetry = ensure_real(registry or _default_obs())
        self.publisher = DeltaPublisher(ch, headroom=headroom, batch_epochs=batch_epochs,
                                        packed=packed, registry=self.telemetry)
        self.followers = [FollowerImageStore(device=self.device, compact=packed or None,
                                             registry=self.telemetry)
                          for _ in range(num_followers)]
        self.tree = TreeTopology(num_followers, arity=arity) if topology == "tree" else None
        self.topology = topology
        self._online = [True] * num_followers
        self._ch = ch
        self.stats = WireStats()
        self.last_publish = {"frames": 0, "bytes": 0, "leader_sends": 0,
                             "catchup_frames": 0}

    @property
    def depth(self) -> int:  # obs-exempt: pure accessor
        """Fan-out depth: relay hops from the leader to the farthest follower."""
        if self.tree is not None:
            return self.tree.depth
        return 1 if self.followers else 0

    def set_online(self, i: int, online: bool = True) -> None:
        """Partition (or heal) follower ``i``: an offline follower gets no
        frames and, in a tree, relays none to its subtree."""
        # obs-exempt: topology toggle, no frames move here
        self._online[i] = bool(online)

    # -- publishing ----------------------------------------------------------
    def publish(self) -> list[int]:
        reg = self.telemetry
        before = (self.stats.frames, self.stats.total_bytes,
                  self.stats.leader_sends, self.stats.catchup_frames)
        with reg.span("repl.publish", topology=self.topology):
            frames = self.publisher.frames()
            target = getattr(self._ch, "epoch", 0)
            lags = [max(0, target - max(f.epoch, 0)) for f in self.followers]
            if frames:
                self.stats.publishes += 1
                self.stats.frames += len(frames)
                with reg.span("repl.relay", n_frames=len(frames)):
                    if self.tree is None:
                        self._deliver_flat(frames)
                    else:
                        self._deliver_tree(frames)
        self.last_publish = {
            "frames": self.stats.frames - before[0],
            "bytes": self.stats.total_bytes - before[1],
            "leader_sends": self.stats.leader_sends - before[2],
            "catchup_frames": self.stats.catchup_frames - before[3],
        }
        if frames:
            reg.counter("repl.publishes").inc()
        reg.counter("repl.wire_frames").inc(self.last_publish["frames"])
        reg.counter("repl.wire_bytes").inc(self.last_publish["bytes"])
        reg.counter("repl.leader_sends").inc(self.last_publish["leader_sends"])
        for i, lag in enumerate(lags):
            reg.gauge("repl.follower_lag", follower=i).set(lag)
        reg.gauge("repl.follower_lag_max").set(max(lags, default=0))
        reg.sink.emit("publish", **self.last_publish,
                      epoch=self.publisher.published_epoch,
                      lag_max=max(lags, default=0))
        return lags

    @staticmethod
    def _nbytes(frames: list[np.ndarray]) -> int:
        return sum(4 * len(f) for f in frames)

    def _send(self, frames: list[np.ndarray], nbytes: int, *, leader: bool) -> None:
        if leader:
            self.stats.leader_sends += len(frames)
            self.stats.leader_bytes += nbytes
        self.stats.total_sends += len(frames)
        self.stats.total_bytes += nbytes

    def _deliver_flat(self, frames: list[np.ndarray]) -> None:
        nbytes = self._nbytes(frames)
        for i in range(len(self.followers)):
            if not self._online[i]:
                continue
            self._send(frames, nbytes, leader=True)
            self._apply(i, frames)

    def _deliver_tree(self, frames: list[np.ndarray]) -> None:
        nbytes = self._nbytes(frames)
        inbox: dict[int, list[np.ndarray]] = {}
        for c in self.tree.children(0):  # the only sends the leader pays
            inbox[c] = frames
            self._send(frames, nbytes, leader=True)
        for node in range(1, self.tree.nodes):  # breadth first: parents first
            got = inbox.pop(node, None)
            if got is None:
                continue
            i = node - 1
            if not self._online[i]:
                continue  # partitioned: its subtree misses this round too
            self._apply(i, got)
            for c in self.tree.children(node):  # relayed as it is
                inbox[c] = got
                self._send(got, nbytes, leader=False)

    def _apply(self, i: int, frames: list[np.ndarray]) -> None:
        """Deliver one round to follower ``i``.  A follower the round
        cannot chain onto (it missed publishes) is first repaired by the
        targeted catch-up pull; the round's own frames then skip as stale."""
        fol = self.followers[i]
        batch = list(frames)
        has_snap = any(_peek_kind(b) in _SNAPSHOT_KINDS for b in batch)
        bases = [_peek_base(b) for b in batch if _peek_kind(b) in _DELTA_KINDS]
        if not has_snap and bases and min(bases) > fol.epoch:
            batch = self._pull_catchup(fol.epoch) + batch
        with self.telemetry.span("repl.apply", follower=i):
            fol.apply_frames(batch)

    def _pull_catchup(self, epoch: int) -> list[np.ndarray]:
        cf = self.publisher.catchup_frames(epoch)
        nbytes = self._nbytes(cf)
        self.stats.catchup_frames += len(cf)
        self.stats.catchup_bytes += nbytes
        self._send(cf, nbytes, leader=True)
        self.telemetry.counter("repl.catchup_repairs").inc()
        self.telemetry.counter("repl.catchup_frames").inc(len(cf))
        self.telemetry.counter("repl.catchup_bytes").inc(nbytes)
        return cf

    # -- the pull path -------------------------------------------------------
    def catch_up(self, i: int) -> int:
        """Repair follower ``i`` to the published cursor by the targeted
        pull (the stream is published to everyone first); returns the
        catch-up frames served."""
        # obs-exempt: delegates to publish/_pull_catchup (instrumented)
        self.publish()
        fol = self.followers[i]
        if fol.epoch == self.publisher.published_epoch:
            return 0
        cf = self._pull_catchup(fol.epoch)
        fol.apply_frames(cf)
        return len(cf)

    def attach_follower(self) -> FollowerImageStore:
        """Join a new follower mid-stream: it pulls a targeted catch-up
        from its empty base at once."""
        self.publish()
        fol = FollowerImageStore(device=self.device, compact=self.publisher.packed or None,
                                 registry=self.telemetry)
        cf = self._pull_catchup(fol.epoch)
        fol.apply_frames(cf)
        self.followers.append(fol)
        self._online.append(True)
        self.telemetry.counter("repl.followers_attached").inc()
        return fol

    def converged(self, leader_image: DeviceImage) -> bool:
        # obs-exempt: host-side fingerprint comparison, no wire
        want = image_fingerprint(leader_image)
        return all(f.epoch == leader_image.epoch and f.fingerprint() == want
                   for f in self.followers)
