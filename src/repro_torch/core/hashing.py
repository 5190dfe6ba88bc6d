"""Hash primitives of the host control plane (the port's own copy).

Two families, as in the reference package:

* 64-bit: paper-faithful (JumpHash's LCG, murmur-style fmix64), used by the
  host-only ``variant="64"`` states;
* 32-bit: murmur3 fmix32 mixing, the arithmetic the device kernels run.
  The numpy functions here are bit-identical to the CUDA kernels and to
  their plain torch versions (``repro_torch.kernels.primitives``).

Scalar functions take and return python ints; ``np_*`` functions work on
``np.uint32`` arrays with wrap-around semantics.
"""
from __future__ import annotations

import numpy as np

MASK32 = 0xFFFFFFFF
MASK64 = 0xFFFFFFFFFFFFFFFF

LCG_MULT = 2862933555777941757          # JumpHash's 64-bit LCG multiplier
GOLDEN32 = 0x9E3779B1
GOLDEN64 = 0x9E3779B97F4A7C15
_C1_32 = 0x85EBCA6B
_C2_32 = 0xC2B2AE35
_C1_64 = 0xFF51AFD7ED558CCD
_C2_64 = 0xC4CEB9FE1A85EC53


def fmix64(h: int) -> int:
    """Murmur3 64-bit finalizer."""
    h &= MASK64
    h ^= h >> 33
    h = (h * _C1_64) & MASK64
    h ^= h >> 33
    h = (h * _C2_64) & MASK64
    h ^= h >> 33
    return h


def fmix32(h: int) -> int:
    """Murmur3 32-bit finalizer."""
    h &= MASK32
    h ^= h >> 16
    h = (h * _C1_32) & MASK32
    h ^= h >> 13
    h = (h * _C2_32) & MASK32
    h ^= h >> 16
    return h


def hash2_64(key: int, seed: int) -> int:
    """Uniform hash of (key, seed): the ``hash(key, b)`` of paper Alg. 4."""
    return fmix64((key & MASK64) ^ fmix64(seed * GOLDEN64 + 1))


def hash2_32(key: int, seed: int) -> int:
    """32-bit (key, seed) hash, bit-identical to the device kernels."""
    return fmix32((key & MASK32) ^ fmix32((seed * GOLDEN32 + 1) & MASK32))


def key_to_u64(key) -> int:
    """Map an arbitrary key (int/str/bytes) to uint64."""
    if isinstance(key, (int, np.integer)):
        return int(key) & MASK64
    if isinstance(key, str):
        key = key.encode("utf-8")
    if isinstance(key, bytes):
        h = 0xCBF29CE484222325  # FNV-1a 64
        for byte in key:
            h = ((h ^ byte) * 0x100000001B3) & MASK64
        return h
    raise TypeError(f"unsupported key type: {type(key)!r}")


def key_to_u32(key) -> int:
    return fmix32(key_to_u64(key) & MASK32 ^ (key_to_u64(key) >> 32))


def np_fmix32(h: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        h = h.astype(np.uint32)
        h ^= h >> np.uint32(16)
        h = (h * np.uint32(_C1_32)).astype(np.uint32)
        h ^= h >> np.uint32(13)
        h = (h * np.uint32(_C2_32)).astype(np.uint32)
        h ^= h >> np.uint32(16)
    return h


def np_key_to_u32(keys: np.ndarray) -> np.ndarray:
    """Vectorized :func:`key_to_u32` for integer keys."""
    k = keys.astype(np.uint64)
    return np_fmix32(((k & np.uint64(MASK32)) ^ (k >> np.uint64(32))).astype(np.uint32))


def np_hash2_32(keys: np.ndarray, seed: np.ndarray | int) -> np.ndarray:
    seed = np.asarray(seed, dtype=np.uint32)
    with np.errstate(over="ignore"):
        s = np_fmix32(seed * np.uint32(GOLDEN32) + np.uint32(1))
        return np_fmix32(keys.astype(np.uint32) ^ s)
