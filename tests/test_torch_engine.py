"""The port's engine (plain torch versions of every ``{algo}_lookup`` and
``{algo}_diff`` kernel, as its wrappers run them on CPU tensors) against
the reference engine on both of its planes (Pallas in interpret mode, and
jnp) and against the host, exactly."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from conformance import ALGORITHMS, churn, churn_mixed, state
from repro.core import DeviceImageStore as RefStore
from repro.kernels import engine as ref
from repro_torch.convert import image_from_arrays, memento_from_state
from repro_torch.kernels import engine as port

KEYS = np.concatenate([
    np.asarray([0, 1, 2**31, 2**32 - 1], np.uint32),
    np.random.default_rng(21).integers(0, 2**32, size=700, dtype=np.uint32)])
PLANES = ["pallas", "jnp"]


def _incremental(n0: int, steps: int, seed: int):
    """A state after a growing removal fraction, one removal per event."""
    h = state("memento", n0, 0, seed=seed)
    for i in range(steps):
        churn(h, n0 // (2 * steps), seed=seed + i)
    return h


STATES = {
    "fresh": lambda: state("memento", 300, 0, seed=0),
    "churned": lambda: state("memento", 300, 120, seed=1),
    "removed90": lambda: state("memento", 300, 270, seed=2),
    "incremental": lambda: _incremental(300, 5, seed=3),
    "one_bucket": lambda: state("memento", 1, 0, seed=0),
}


def _port_image(img):
    return image_from_arrays(img.algo, img.n, img.arrays, img.scalars, img.epoch)


@pytest.mark.parametrize("plane", PLANES)
@pytest.mark.parametrize("name", sorted(STATES))
def test_lookup_matches_reference_and_host(name, plane):
    h = STATES[name]()
    img = h.device_image()
    got = port.engine_lookup(KEYS, _port_image(img))
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    want = np.asarray(ref.engine_lookup(KEYS, img, plane=plane))
    np.testing.assert_array_equal(got.numpy(), want)
    host = memento_from_state(h.n, h.l, h.R)
    assert got[:100].tolist() == [host.lookup(int(k)) for k in KEYS[:100]]


@pytest.mark.parametrize("plane", PLANES)
@pytest.mark.parametrize("events", [1, 40])
def test_diff_matches_reference(plane, events):
    h = state("memento", 300, 100, seed=4)
    store = RefStore(h)
    churn(h, events, seed=9)
    store.sync()
    old_img, new_img = store.previous_image(), store.image()
    got = port.engine_diff(KEYS, _port_image(old_img), _port_image(new_img))
    want = ref.engine_diff(KEYS, old_img, new_img, plane=plane)
    np.testing.assert_array_equal(got.old.numpy(), want.old)
    np.testing.assert_array_equal(got.new.numpy(), want.new)
    np.testing.assert_array_equal(got.moved.numpy(), want.moved)
    assert got.num_moved == want.num_moved > 0


def test_work_counts_match_host_trace():
    """The plain version's lane counts (what chip_smoke.py's bound reads)
    equal the host's Alg. 4 iteration counts."""
    h = state("memento", 300, 200, seed=5)
    work: dict = {}
    port.memento_lookup_plain(port.key_tensor(KEYS, "cpu"),
                              _port_image(h.device_image()).arrays["repl"], h.n, work)
    outer = inner = 0
    for k in KEYS:
        _, ext, inn = h.lookup_trace(int(k))
        outer, inner = outer + ext, inner + inn
    assert (work["outer"], work["read"]) == (outer, inner)


def test_key_tensor_accepts_numpy_and_tensors():
    as_np = port.key_tensor(KEYS, "cpu")
    assert as_np.dtype == torch.int32
    np.testing.assert_array_equal(as_np.numpy().view(np.uint32), KEYS)
    assert torch.equal(port.key_tensor(torch.from_numpy(KEYS.view(np.int32)), "cpu"), as_np)
    assert torch.equal(port.key_tensor(as_np.view(torch.uint32), "cpu"), as_np)
    with pytest.raises(ValueError):
        port.key_tensor(torch.zeros(3, dtype=torch.int64), "cpu")


def test_wrapper_checks_operands():
    repl = torch.full((128,), -1, dtype=torch.int32)
    keys = port.key_tensor(KEYS, "cpu")
    with pytest.raises(ValueError):
        port.memento_lookup(keys, repl, 0)
    with pytest.raises(ValueError):
        port.memento_lookup(keys, repl, 129)
    with pytest.raises(ValueError):
        port.memento_lookup(keys, repl.to(torch.int64), 5)
    with pytest.raises(ValueError):
        port.memento_lookup(keys.to(torch.int64), repl, 5)
    assert port.memento_lookup(keys[:0], repl, 5).shape == (0,)


CONFIGS = [dict(algo=a) for a in ("memento", "anchor", "cuckoo")] + [
    dict(algo="memento", mode="walk"), dict(algo="memento", mode="scan"),
    dict(algo="memento", k=0), dict(algo="memento", k=2),
    dict(algo="memento", bounded=True), dict(algo="memento", diff=True),
    dict(algo="memento", mode="walk", k=2), dict(algo="memento", mode="walk", diff=True),
    dict(algo="memento", table="compact"), dict(algo="memento", table="packed"),
    dict(algo="memento", table="sparse"), dict(algo="anchor", table="compact"),
    dict(algo="memento", table="compact", diff=True),
]


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()))
def test_engine_op_checks_match_reference(cfg):
    """A configuration the reference rejects raises the same ValueError;
    one it accepts builds the same configuration, with the same table
    names (packed and compact tables included)."""
    try:
        want = ref.EngineOp(**cfg)
    except ValueError as err:
        with pytest.raises(ValueError, match=str(err).replace("(", r"\(").replace(")", r"\)")):
            port.EngineOp(**cfg)
        return
    op = port.EngineOp(**cfg)
    fields = ("algo", "mode", "k", "bounded", "diff", "table", "table_names")
    assert [getattr(op, f) for f in fields] == [getattr(want, f) for f in fields]


def test_unported_configurations_raise_at_entry_points():
    """k > 1 lookups and diffs are served as the reference serves them,
    and so are the packed and compact tables: nothing raises any more."""
    h = state("memento", 40, 5, seed=0)
    ref_img = h.device_image()
    churn(h, 3, seed=1)
    new_img = h.device_image()
    img, img2 = _port_image(ref_img), _port_image(new_img)
    np.testing.assert_array_equal(port.engine_lookup(KEYS, img, k=2).numpy(),
                                  np.asarray(ref.engine_lookup(KEYS, ref_img, k=2, plane="jnp")))
    got = port.engine_diff(KEYS, img, img2, k=3)
    want = ref.engine_diff(KEYS, ref_img, new_img, k=3, plane="jnp")
    np.testing.assert_array_equal(got.old.numpy(), want.old)
    np.testing.assert_array_equal(got.new.numpy(), want.new)
    np.testing.assert_array_equal(got.moved.numpy(), want.moved)
    from repro.core.packing import pack_image as ref_pack
    from repro_torch.core.packing import pack_image

    packed, packed2 = pack_image(img), pack_image(img2)
    np.testing.assert_array_equal(
        port.engine_lookup(KEYS, packed, k=2).numpy(),
        np.asarray(ref.engine_lookup(KEYS, ref_pack(ref_img), k=2, plane="jnp")))
    got = port.engine_diff(KEYS, packed, packed2, k=3)
    want = ref.engine_diff(KEYS, ref_pack(ref_img), ref_pack(new_img), k=3, plane="jnp")
    np.testing.assert_array_equal(got.new.numpy(), want.new)
    np.testing.assert_array_equal(got.moved.numpy(), want.moved)
    np.testing.assert_array_equal(
        port.engine_lookup(KEYS, img, table="compact").numpy(),
        np.asarray(ref.engine_lookup(KEYS, ref_img, table="compact", plane="pallas")))


ALGO_STATES = {
    "fresh": (200, 0),
    "churned": (200, 80),
    "removed90": (200, 180),
}


@pytest.mark.parametrize("plane", PLANES)
@pytest.mark.parametrize("name", sorted(ALGO_STATES))
@pytest.mark.parametrize("algo", ALGORITHMS)
def test_every_body_lookup_matches_reference(algo, name, plane):
    n0, removals = ALGO_STATES[name]
    h = state(algo, n0, removals, seed=7)
    img = h.device_image()
    got = port.engine_lookup(KEYS, _port_image(img), device="cpu")
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    want = np.asarray(ref.engine_lookup(KEYS, img, plane=plane))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[:100].tolist() == [h.lookup(int(k)) for k in KEYS[:100]]


@pytest.mark.parametrize("plane", PLANES)
@pytest.mark.parametrize("algo", ALGORITHMS)
def test_every_body_diff_matches_reference(algo, plane):
    h = state(algo, 200, 60, seed=8)
    store = RefStore(h)
    churn_mixed(h, 30, seed=10, p_remove=0.7)
    store.sync()
    old_img, new_img = store.previous_image(), store.image()
    got = port.engine_diff(KEYS, _port_image(old_img), _port_image(new_img), device="cpu")
    want = ref.engine_diff(KEYS, old_img, new_img, plane=plane)
    np.testing.assert_array_equal(got.old.numpy(), want.old)
    np.testing.assert_array_equal(got.new.numpy(), want.new)
    np.testing.assert_array_equal(got.moved.numpy(), want.moved)
    assert got.num_moved == want.num_moved > 0


@pytest.mark.parametrize("old_ratio, new_ratio", [(4, 40), (40, 41), (1, 200), (200, 8)])
def test_dx_diff_across_probe_bounds_matches_reference(old_ratio, new_ratio):
    """``diff_plain`` of two DxHash epochs at different a/w, each with its
    own probe bound and fallback (``dx_diff`` takes its lane group from the
    larger bound), against the reference's jnp plane."""
    a = 1600

    def image(ratio, seed):
        h = state("dx", a // 4, 0, seed=seed)
        rng = np.random.default_rng(seed)
        while h.working > a // ratio:
            h.remove(int(rng.choice(sorted(h.working_set()))))
        return h.device_image()

    old, new = image(old_ratio, 1), image(new_ratio, 2)
    got = port.diff_plain("dx", port.key_tensor(KEYS, "cpu"),
                          *(port.image_operands(_port_image(i)) for i in (old, new)))
    want = ref.engine_diff(KEYS, old, new, plane="jnp")
    for g, w in zip(got, (want.old, want.new, want.moved)):
        np.testing.assert_array_equal(g.numpy(), w)
    assert old.scalars != new.scalars and got[2].any()


@pytest.mark.parametrize("algo", ALGORITHMS)
def test_work_counts_of_every_body_match_host_trace(algo):
    """The plain bodies' lane counts (what chip_smoke.py's bounds read)
    equal the host's own step counts where the host reports them."""
    h = state(algo, 300, 250, seed=5)
    img = _port_image(h.device_image())
    work: dict = {}
    port.lookup_plain(algo, port.key_tensor(KEYS, "cpu"), *port.image_operands(img), work)
    traces = [h.lookup_trace(int(k)) for k in KEYS]
    first = sum(t[1] for t in traces)
    second = sum(t[2] for t in traces)
    if algo in ("memento", "anchor"):
        assert (work["outer"], work.get("read", 0)) == (first, second)
    elif algo == "dx":
        assert work["probe"] == first + len(KEYS)  # the host counts misses
    elif algo == "power":
        assert (work.get("draw", 0), work.get("level", 0)) == (first, second)
    else:
        assert work["step"] >= len(KEYS)


def test_tableless_images_run_where_asked():
    img = _port_image(state("jump", 50, 3, seed=1).device_image())
    assert img.arrays == {}
    assert port.engine_lookup(KEYS, img, device="cpu").device.type == "cpu"
    with pytest.raises(ValueError):
        port.engine_lookup(KEYS, _port_image(state("anchor", 50, 3, seed=1).device_image()),
                           device="meta")


@pytest.mark.parametrize("algo", ALGORITHMS)
def test_kernel_wrappers_check_operands(algo):
    img = _port_image(state(algo, 64, 10, seed=2).device_image())
    tables, scalars = port.image_operands(img)
    keys = port.key_tensor(KEYS, "cpu")
    with pytest.raises(ValueError):
        port.kernel_lookup(algo, keys, tables, [0] + scalars[1:])
    with pytest.raises(ValueError):
        port.kernel_lookup(algo, keys.to(torch.int64), tables, scalars)
    with pytest.raises(ValueError):
        port.kernel_lookup(algo, keys, tables + [tables[0] if tables else keys], scalars)
    if tables:
        with pytest.raises(ValueError):
            port.kernel_lookup(algo, keys, [t[:1] for t in tables], scalars)
        with pytest.raises(ValueError):
            port.kernel_lookup(algo, keys, [t.to(torch.int64) for t in tables], scalars)
    assert port.kernel_lookup(algo, keys[:0], tables, scalars).shape == (0,)
    o, n, moved = port.kernel_diff(algo, keys, (tables, scalars), (tables, scalars))
    assert torch.equal(o, n) and not moved.any()
