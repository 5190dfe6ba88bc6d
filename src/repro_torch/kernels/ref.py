"""Oracles for the lookup kernels (the reference's ``kernels/ref.py``).

The ``*_ref`` functions are the plain torch versions under the
reference's names, so a kernel test reads ``kernel(...) == ref(...)``;
they run on the device of the tensors they are given (numpy arrays on the
CPU).  The scalar host oracle :func:`lookup_host` works for any host
state of the port.
"""
from __future__ import annotations

import numpy as np
import torch

from .engine import image_operands, key_tensor, lookup_plain, op_table


def _table(t) -> torch.Tensor:
    """A table operand: a tensor as it is; a numpy array as a tensor of
    the same bytes (uint32 words as int32 bit patterns)."""
    if isinstance(t, torch.Tensor):
        return t
    a = np.ascontiguousarray(t)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _plain(algo: str, keys, tables, scalars) -> torch.Tensor:
    tables = [_table(t) for t in tables]
    device = tables[0].device if tables else torch.device("cpu")
    return lookup_plain(algo, key_tensor(keys, device), tables, [int(s) for s in scalars])


def memento_lookup_ref(keys, repl, n) -> torch.Tensor:
    return _plain("memento", keys, [repl], [n])


def anchor_lookup_ref(keys, A, K, a) -> torch.Tensor:
    return _plain("anchor", keys, [A, K], [a])


def dx_lookup_ref(keys, words, a, max_probes, fallback) -> torch.Tensor:
    return _plain("dx", keys, [words], [a, max_probes, fallback])


def jump32_ref(keys, n) -> torch.Tensor:
    return _plain("jump", keys, [], [n])


def lookup_image_ref(keys, image) -> torch.Tensor:
    """The plain lookup of any image, dense or packed, on its device (the
    CPU for a tableless one)."""
    tables, scalars = image_operands(image)
    device = tables[0].device if tables else torch.device("cpu")
    return lookup_plain(image.algo, key_tensor(keys, device), tables, scalars,
                        table=op_table(image))


def lookup_host(keys: np.ndarray, h) -> np.ndarray:
    """Scalar host oracle: the per-key ``lookup`` of any algorithm."""
    return np.asarray([h.lookup(int(k)) for k in np.asarray(keys)], dtype=np.int32)


def memento_lookup_host(keys: np.ndarray, memento) -> np.ndarray:
    """Scalar host oracle of paper Alg. 4 over the Θ(r) dict."""
    return lookup_host(keys, memento)
