"""Checkpointing: Memento-placed shard files, manifest, async writer (the
port's copy of the reference's ``ckpt/store.py``, in its on-disk layout).

Every leaf of the state tree is a checkpoint shard keyed by its tree path;
MementoHash places shards on storage buckets (one ``bucket_XXXX.npz`` per
bucket).  Because the placement is consistent, growing or shrinking the
storage fleet between save and restore relocates only the necessary
shards, and restore needs only the manifest (which records the Memento
state ⟨n, R, l⟩ it was saved with).  The placement is the reference's
(``MementoHash.lookup(key_to_u64(path))``), so either package restores
the other's checkpoints.

A leaf may be a numpy array, a number, or a torch tensor on any device: a
tensor is copied to the host on the caller's thread (``.detach().cpu()``,
a clone on the CPU) and saved as its numpy value.  A tensor whose dtype
numpy lacks (``torch.bfloat16``) raises a ``TypeError`` naming the leaf.
Restores return numpy leaves.

:class:`AsyncCheckpointer` runs serialization and the writes on a writer
thread, so the train loop blocks only on the device→host copy.
"""
from __future__ import annotations

import json
import threading
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.hashing import key_to_u64
from repro_torch.core.memento import MementoHash


def _host_leaf(path: str, leaf) -> np.ndarray:
    """A leaf as numpy on the host.  A tensor is copied (a CPU tensor too,
    so a state updated in place after ``save`` returns cannot reach the
    writer thread's arrays)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        try:
            return (t.clone() if t.device.type == "cpu" else t.cpu()).numpy()
        except TypeError as e:  # a dtype numpy has no counterpart for
            raise TypeError(f"checkpoint leaf {path!r}: {leaf.dtype} has no numpy "
                            "dtype; convert it before saving") from e
    return np.asarray(leaf)


def _flatten(tree, prefix=()) -> dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], prefix + (str(k),)))
        return out
    path = "/".join(prefix)
    out[path] = _host_leaf(path, tree)
    return out


def _unflatten(flat: dict[str, np.ndarray]) -> dict:
    root: dict = {}
    for path, val in flat.items():
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return root


def save_checkpoint(state, step: int, directory, *, num_buckets: int = 4,
                    memento: MementoHash | None = None) -> Path:
    directory = Path(directory)
    ckpt_dir = directory / f"step_{step:08d}"
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    flat = _flatten(state)
    m = memento or MementoHash(num_buckets)

    buckets: dict[int, dict[str, np.ndarray]] = {}
    manifest = {"step": step,
                "memento": {"n": m.n, "l": m.l,
                            "R": {str(k): list(v) for k, v in m.R.items()}},
                "shards": {}}
    for path, arr in flat.items():
        b = m.lookup(key_to_u64(path))
        buckets.setdefault(b, {})[path] = arr
        manifest["shards"][path] = {
            "bucket": b, "shape": list(arr.shape), "dtype": str(arr.dtype)}

    for b, items in buckets.items():
        np.savez(ckpt_dir / f"bucket_{b:04d}.npz",
                 **{p.replace("/", "|"): a for p, a in items.items()})
    (ckpt_dir / "manifest.json").write_text(json.dumps(manifest))
    (ckpt_dir / "_DONE").write_text(str(time.time()))  # commit marker
    return ckpt_dir


def latest_step(directory) -> int | None:
    directory = Path(directory)
    steps = [int(p.name.split("_")[1]) for p in directory.glob("step_*")
             if (p / "_DONE").exists()]
    return max(steps) if steps else None


def restore_checkpoint(directory, step: int | None = None):
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoints in {directory}")
    ckpt_dir = directory / f"step_{step:08d}"
    manifest = json.loads((ckpt_dir / "manifest.json").read_text())
    flat = {}
    by_bucket: dict[int, list[str]] = {}
    for path, info in manifest["shards"].items():
        by_bucket.setdefault(info["bucket"], []).append(path)
    for b, paths in by_bucket.items():
        with np.load(ckpt_dir / f"bucket_{b:04d}.npz") as z:
            for p in paths:
                flat[p] = z[p.replace("/", "|")]
    return _unflatten(flat), manifest


class AsyncCheckpointer:
    def __init__(self, directory, *, num_buckets: int = 4, keep: int = 3):
        self.directory = Path(directory)
        self.num_buckets = num_buckets
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    def save(self, state, step: int) -> None:
        self.wait()  # one in-flight save at a time
        host_state = _flatten(state)  # device→host on the caller's thread

        def _write():
            try:
                save_checkpoint(_unflatten(host_state), step, self.directory,
                                num_buckets=self.num_buckets)
                self._gc()
            except Exception as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(int(p.name.split("_")[1])
                       for p in self.directory.glob("step_*")
                       if (p / "_DONE").exists())
        for s in steps[: -self.keep]:
            d = self.directory / f"step_{s:08d}"
            for f in d.iterdir():
                f.unlink()
            d.rmdir()
