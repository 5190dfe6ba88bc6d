"""The port's host algorithms (AnchorHash, DxHash, JumpHash, PowerHash and
MementoHash) against the reference's, exactly: after one ``churn_mixed``
sequence on both, every lookup, lookup trace, working set, device image
word and epoch delta agrees.  Also the plain ``power32`` at the edges of
its level arithmetic, a DxHash state whose lookups reach ``fallback``, and
state carried across by ``repro_torch.convert``."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from conformance import churn_mixed, make
from repro.core import ALGORITHMS as REF_ALGORITHMS
from repro.core import image_fingerprint as ref_fingerprint
from repro.core.power import power32 as ref_power32_host
from repro.kernels import engine as ref_engine
from repro.kernels.primitives import power32 as ref_power32_jnp
from repro_torch import convert
from repro_torch.core import protocol as pp
from repro_torch.kernels import engine as port_engine
from repro_torch.kernels.primitives import as_u32, power32

KEYS = np.concatenate([
    np.asarray([0, 1, 2**31 - 1, 2**31, 2**32 - 1], np.uint32),
    np.random.default_rng(17).integers(0, 2**32, size=600, dtype=np.uint32)])


def _pair(algo: str, n0: int = 48, events: int = 90, seed: int = 3):
    """The reference's and the port's ``variant="32"`` state after the same
    ``churn_mixed`` sequence (capacity 4·n0 for the fixed-capacity ones)."""
    ref = make(algo, n0)
    port = pp.make_hash(algo, n0, capacity=4 * n0, variant="32")
    churn_mixed(ref, events, seed=seed, p_remove=0.6)
    churn_mixed(port, events, seed=seed, p_remove=0.6)
    return ref, port


def _words(arr) -> np.ndarray:
    """A table as int32 bit patterns (the reference keeps dx words uint32)."""
    a = arr.numpy() if isinstance(arr, torch.Tensor) else np.asarray(arr)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def test_registry_matches_reference():
    assert pp.ALGORITHMS == REF_ALGORITHMS
    from repro.core.protocol import ALGORITHM_REGISTRY as REF
    for name, info in pp.ALGORITHM_REGISTRY.items():
        ref = REF[name]
        assert (info.scalars, info.tables, info.lifo_only, info.fixed_capacity) == \
            (ref.scalars, ref.tables, ref.lifo_only, ref.fixed_capacity)
        assert info.required(1000) == ref.required(1000)


@pytest.mark.parametrize("algo", REF_ALGORITHMS)
def test_host_state_matches_reference_after_churn(algo):
    ref, port = _pair(algo)
    assert (port.size, port.working, port.epoch) == (ref.size, ref.working, ref.epoch)
    assert port.working_set() == ref.working_set()
    assert port.memory_bytes() == ref.memory_bytes()
    keys = KEYS[:300].tolist()
    assert [port.lookup(k) for k in keys] == [ref.lookup(k) for k in keys]
    assert [port.lookup_trace(k) for k in keys] == [ref.lookup_trace(k) for k in keys]
    assert [port.lookup_k_trace(k, 3) for k in keys[:40]] == \
        [ref.lookup_k_trace(k, 3) for k in keys[:40]]


@pytest.mark.parametrize("capacity", [None, 1000])
@pytest.mark.parametrize("algo", REF_ALGORITHMS)
def test_device_image_matches_reference_bit_for_bit(algo, capacity):
    ref, port = _pair(algo, seed=4)
    r, p = ref.device_image(capacity=capacity), port.device_image(capacity=capacity)
    assert (p.algo, p.n, p.epoch, p.scalars) == (r.algo, r.n, r.epoch, r.scalars)
    assert sorted(p.arrays) == sorted(r.arrays)
    for name, arr in r.arrays.items():
        assert p.arrays[name].dtype == torch.int32
        np.testing.assert_array_equal(p.arrays[name].numpy(), _words(arr))
    assert pp.image_fingerprint(p) == ref_fingerprint(r)
    assert pp.image_scalar_vec(p) == [r.n] + [r.scalars[s] for s in pp.IMAGE_LAYOUT[algo][0][1:]]


@pytest.mark.parametrize("algo", REF_ALGORITHMS)
def test_device_delta_matches_reference(algo):
    ref, port = _pair(algo, events=60, seed=5)
    for since in (0, ref.epoch - 7, ref.epoch - 1, ref.epoch):
        r, p = ref.device_delta(since), port.device_delta(since)
        assert (p.algo, p.base_epoch, p.epoch, p.n, p.scalars) == \
            (r.algo, r.base_epoch, r.epoch, r.n, r.scalars)
        assert p.num_words() == r.num_words()
        assert sorted(p.updates) == sorted(r.updates)
        for name, (idx, vals) in r.updates.items():
            np.testing.assert_array_equal(p.updates[name][0], idx)
            np.testing.assert_array_equal(p.updates[name][1], vals)


@pytest.mark.parametrize("algo", REF_ALGORITHMS)
def test_removal_rules_match_reference(algo):
    """LIFO-only and fixed-capacity rules raise where the reference raises."""
    ref, port = _pair(algo, n0=6, events=0)
    for h in (ref, port):
        for _ in range(4 * 6 + 1):
            try:
                h.add()
            except ValueError:
                break
    assert port.size == ref.size and port.working == ref.working
    victim = min(ref.working_set())
    outcomes = []
    for h in (ref, port):
        try:
            h.remove(victim)
            outcomes.append("removed")
        except ValueError:
            outcomes.append("refused")
    assert outcomes[0] == outcomes[1]


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 7, 8, 9, 255, 256, 257, 2**16,
                               2**16 + 1, 2**20 - 1, 10**6, 2**30, 2**30 + 1,
                               2**31 - 1])
def test_power32_matches_reference(n):
    """The plain power32 at n = 1, 2, 3 and around powers of two, against
    the reference's host and jnp versions."""
    keys = KEYS[:400]
    got = power32(as_u32(torch.from_numpy(keys.view(np.int32))), n).numpy()
    np.testing.assert_array_equal(got, np.asarray(ref_power32_jnp(keys, n)))
    assert got[:150].tolist() == [ref_power32_host(int(k), n) for k in keys[:150]]
    assert ((got >= 0) & (got < n)).all()
    if n == 1:
        assert not got.any()


def test_power32_counts_its_draws():
    work: dict = {}
    keys = as_u32(torch.from_numpy(KEYS.view(np.int32)))
    power32(keys, 1000, work)
    from repro_torch.core.power import PowerHash
    h = PowerHash(1000, variant="32")
    traces = [h.lookup_trace(int(k)) for k in KEYS]
    assert work["draw"] == sum(t[1] for t in traces)
    assert work["level"] == sum(t[2] for t in traces)


def test_dx_lookups_reach_fallback():
    """With the probe bound cut to ⌈a/w⌉ a third of the keys miss every
    probe; host, plain body and both reference planes all answer
    ``fallback`` for them."""
    ref, port = make("dx", 400), pp.make_hash("dx", 400, capacity=1600, variant="32")
    for h in (ref, port):
        h._MAX_PROBE_FACTOR = 1
        for b in range(0, 390):
            h.remove(b)  # the first working bucket moves up to 390
    assert port.working == 10 and port.max_probes() == 160
    img_r, img_p = ref.device_image(), port.device_image()
    assert img_p.scalars == img_r.scalars == {"max_probes": 160, "fallback": 390}
    traces = [port.lookup_trace(int(k)) for k in KEYS]
    reached = [t[0] for t in traces if t[1] == port.max_probes()]
    assert len(reached) > 50 and set(reached) == {390}
    assert traces == [ref.lookup_trace(int(k)) for k in KEYS]
    got = port_engine.engine_lookup(KEYS, img_p, device="cpu").numpy()
    assert got.tolist() == [t[0] for t in traces]
    for plane in ("jnp", "pallas"):
        np.testing.assert_array_equal(got, np.asarray(
            ref_engine.engine_lookup(KEYS, img_r, plane=plane)))


def _from_state(algo: str, ref):
    """The port's counterpart of a reference state, from plain values."""
    if algo == "memento":
        return convert.memento_from_state(ref.n, ref.l, ref.R, epoch=ref.epoch)
    if algo == "anchor":
        return convert.anchor_from_state(ref.a, ref.A, ref.K, ref.W, ref.L, ref.R,
                                         ref.N, epoch=ref.epoch)
    if algo == "dx":
        return convert.dx_from_state(ref.a, ref.active, ref.R, ref._fallback,
                                     epoch=ref.epoch)
    return getattr(convert, f"{algo}_from_state")(ref.n, epoch=ref.epoch)


@pytest.mark.parametrize("algo", REF_ALGORITHMS)
def test_state_carried_across_by_convert(algo):
    ref, _ = _pair(algo, seed=6)
    port = _from_state(algo, ref)
    assert pp.image_fingerprint(port.device_image()) == ref_fingerprint(ref.device_image())
    keys = KEYS[:200].tolist()
    assert [port.lookup(k) for k in keys] == [ref.lookup(k) for k in keys]
    assert port.working_set() == ref.working_set()
    img = ref.device_image()
    p_img = convert.image_from_arrays(img.algo, img.n, img.arrays, img.scalars, img.epoch)
    assert pp.image_fingerprint(p_img) == ref_fingerprint(img)
    assert all(t.dtype == torch.int32 for t in p_img.arrays.values())
    # the port's state goes on as the reference's does
    for h in (ref, port):
        h.add()
    assert [port.lookup(k) for k in keys] == [ref.lookup(k) for k in keys]
