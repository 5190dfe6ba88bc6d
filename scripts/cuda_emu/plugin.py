"""pytest plugin: run ``tests/test_torch_cuda.py`` on the CPU with the port's
kernels built by ``build.py``, so that every card test runs the kernels' own
code (CPU tensors launch the g++ build instead of the plain versions).

    python scripts/cuda_emu/build.py /tmp/emu
    EMU_BUILD=/tmp/emu PYTHONPATH=src:scripts/cuda_emu \\
        python -m pytest -p plugin -m cuda tests/test_torch_cuda.py

Only the tests that assert a CUDA device type fail.  Put a ``timeout`` on
such runs: a kernel whose chain rule is broken can loop forever.
"""
from __future__ import annotations

import contextlib
import ctypes
import importlib
import os
import threading
import types

import torch

_libs: dict = {}
_one_at_a_time = threading.Lock()


class _Serial:
    """A built library whose entries run one call at a time: an emulated
    launch keeps its grid and its fibers in globals, so two host threads
    must not launch at once."""

    def __init__(self, lib):
        self._lib = lib

    def __getattr__(self, name):
        fn = getattr(self._lib, name)

        def call(*args):
            with _one_at_a_time:
                return fn(*args)
        return call


def _load(name, signatures):
    lib = _libs.get(name)
    if lib is None:
        raw = ctypes.CDLL(os.path.join(os.environ["EMU_BUILD"], f"lib{name}.so"))
        for fn, argtypes in signatures.items():
            getattr(raw, fn).argtypes = argtypes
            getattr(raw, fn).restype = ctypes.c_int
        raw.error_string.argtypes = [ctypes.c_int]
        raw.error_string.restype = ctypes.c_char_p
        lib = _libs[name] = _Serial(raw)
    return lib


def _cpu(device=None):
    return torch.device("cpu")


def _cpus(devices=None):
    """A device list on the CPU: one entry for every GPU (one), or as many
    as the list has."""
    return [torch.device("cpu")] * (1 if devices is None else len(devices))


def install() -> None:
    """Route the port's kernel wrappers to the g++ build, on CPU tensors."""
    from repro_torch.kernels import build, delta_apply as da, engine

    build.load = _load
    engine._on_card = lambda t: True
    torch.cuda.is_available = lambda: True
    torch.cuda.synchronize = lambda *a, **k: None
    torch.cuda.device = lambda *a, **k: contextlib.nullcontext()
    torch.cuda.current_stream = lambda *a, **k: types.SimpleNamespace(cuda_stream=0)
    torch.cuda.current_device = lambda: 0
    torch.cuda.get_device_properties = lambda *a: types.SimpleNamespace(multi_processor_count=4)
    plain = da.delta_apply

    def delta_apply(table, meta, count):
        plain(table, meta, count)  # its checks
        name = da.KERNELS[table.dtype]
        out = torch.empty_like(table)
        lib = build.load("delta_apply", da._SIGNATURES)
        rc = getattr(lib, name)(table.data_ptr(), out.data_ptr(), table.numel(), meta.data_ptr(),
                                meta.numel() // 2, count, 0)
        build.check(lib, rc, name)
        da.LAUNCHES[name] += 1
        return out

    da.delta_apply = delta_apply
    for mod in ("repro_torch.serve.router", "repro_torch.core.image_store",
                "repro_torch.kernels.engine", "repro_torch.sim.driver", "repro_torch.kernels.ops",
                "repro_torch.serve.plane", "repro_torch.data.pipeline",
                "repro_torch.launch.replicate"):
        m = importlib.import_module(mod)
        if hasattr(m, "resolve_device"):
            m.resolve_device = _cpu
        if hasattr(m, "resolve_devices"):
            m.resolve_devices = _cpus


def pytest_configure(config):
    install()


def pytest_collection_modifyitems(items):
    """The card tests' ``dev`` fixture gives the CPU."""
    for item in items:
        for fixturedef in item._fixtureinfo.name2fixturedefs.get("dev", ()):
            fixturedef.func = _cpu
