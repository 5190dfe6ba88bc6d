"""The port's device hash primitives (plain torch versions of the CUDA
kernels' arithmetic) against the reference's jnp primitives and its numpy
host jump, bit for bit."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.jump import np_jump32
from repro.kernels import primitives as ref
from repro_torch.kernels import primitives as port

KEYS = np.concatenate([
    np.asarray([0, 1, 2**31 - 1, 2**31, 2**32 - 1], np.uint32),
    np.random.default_rng(11).integers(0, 2**32, size=100_000, dtype=np.uint32)])
NS = [1, 2, 3, 127, 128, 129, 2**16 - 1, 2**16 + 1, 10**6]


def _port_keys():
    return port.as_u32(torch.from_numpy(KEYS.view(np.int32)))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.uint32)


def test_fmix32():
    want = np.asarray(ref.fmix32(jnp.asarray(KEYS)))
    np.testing.assert_array_equal(_np(port.fmix32(_port_keys())), want)


@pytest.mark.parametrize("seed", [0, 1, 12345, 2**31 - 1])
def test_hash2_scalar_seed(seed):
    want = np.asarray(ref.hash2(jnp.asarray(KEYS), seed))
    np.testing.assert_array_equal(_np(port.hash2(_port_keys(), seed)), want)


def test_hash2_tensor_seed():
    seeds = np.random.default_rng(3).integers(0, 2**31, size=KEYS.size).astype(np.int32)
    want = np.asarray(ref.hash2(jnp.asarray(KEYS), jnp.asarray(seeds)))
    got = port.hash2(_port_keys(), torch.from_numpy(seeds).to(torch.int64))
    np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("step", [0, 1, 7, 255])
def test_step_u24(step):
    want = np.asarray(ref.step_u24(jnp.asarray(KEYS), step))
    np.testing.assert_array_equal(_np(port.step_u24(_port_keys(), step)), want)


@pytest.mark.parametrize("n", NS)
def test_jump32(n):
    got = port.jump32(_port_keys(), n).numpy()
    np.testing.assert_array_equal(got, np_jump32(KEYS, n))
    np.testing.assert_array_equal(got, np.asarray(ref.jump32(jnp.asarray(KEYS), n)))


def test_jump32_counts_its_steps():
    work: dict = {}
    port.jump32(_port_keys()[:1000], 10**6, work)
    assert 10 * 1000 < work["step"] < 20 * 1000  # about ln(10^6) = 13.8 per key


def test_gather1d():
    table = torch.arange(-5, 123, dtype=torch.int32)
    idx = torch.tensor([[0, 127], [5, 64]])
    want = np.asarray(ref.gather1d(jnp.arange(-5, 123, dtype=jnp.int32),
                                   jnp.asarray([[0, 127], [5, 64]])))
    got = port.gather1d(table, idx)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_step_salt_matches():
    assert port.STEP_SALT == ref.STEP_SALT
