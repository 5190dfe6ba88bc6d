"""Build the CUDA sources in ``csrc/`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exports a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into its own shared library.  No PyTorch
header is included, so a source builds in seconds.  The libraries go into
``_build/`` beside this file (listed in ``.gitignore``), named by a hash of
the source and the flags: they are built at first use and reused while
that hash is unchanged.  Stale sources build in parallel, one ``nvcc`` each.

The flags keep IEEE float32 arithmetic: no ``--use_fast_math``, and
``--fmad=false`` so no multiply-add is contracted (the jump32 step relies
on a correctly rounded divide and exact products).
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "--fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")


@dataclass
class Built:
    """One compiled source: where its library is, how long ``nvcc`` took
    (0 when reused), and what ``ptxas -v`` said about its kernels."""

    name: str
    path: Path
    seconds: float
    ptxas: str
    reused: bool


_LOADED: dict[tuple, ctypes.CDLL] = {}
_SOURCES: dict[str, Path] = {}


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the
    toolkit's default location."""
    home = os.environ.get("CUDA_HOME")
    if home:
        return str(Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def _source(name: str) -> Path:
    return _SOURCES.get(name) or CSRC / f"{name}.cu"


def _target(name: str) -> Path:
    src = _source(name).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build(names: list[str] | None = None) -> dict[str, Built]:
    """Compile every stale source of ``names`` (default: all of ``csrc/``),
    all ``nvcc`` processes started together.  Raises ``RuntimeError`` with
    the compiler's output if one fails."""
    names = sources() if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: dict[str, Built] = {}
    running = {}
    for name in names:
        target = _target(name)
        log = target.with_suffix(".log")
        if target.exists() and log.exists():
            out[name] = Built(name, target, 0.0, log.read_text(), True)
            continue
        tmp = target.with_name(f"{target.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(_source(name))]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, target, time.perf_counter())
    failed = []
    for name, (proc, tmp, target, t0) in running.items():
        text, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{text}")
            continue
        os.replace(tmp, target)
        target.with_suffix(".log").write_text(text)
        out[name] = Built(name, target, seconds, text, False)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def load(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu`` (building it if needed),
    with ``argtypes`` set from ``signatures`` and every ``restype`` int."""
    key = (name, _SOURCES.get(name))
    lib = _LOADED.get(key)
    if lib is None:
        built = build([name])[name]
        lib = ctypes.CDLL(str(built.path))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        _LOADED[key] = lib
    return lib


@contextlib.contextmanager
def built_from(name: str, source: Path):
    """Within the block, :func:`build` and :func:`load` take ``source`` (another
    revision of ``csrc/<name>.cu``, such as a ``git archive`` of an earlier
    commit) in place of this tree's, so that two builds run through the
    same wrappers: ``scripts/ab_engine.py`` times them so."""
    _SOURCES[name] = Path(source).resolve()
    try:
        yield
    finally:
        del _SOURCES[name]


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} "
                           f"({lib.error_string(rc).decode()})")
