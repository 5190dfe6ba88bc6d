"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or the reference package ``repro``, and the
port's entry points run on the GPU unless the caller asks for the CPU."""
from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imports(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


def test_port_files_exist():
    assert len(PORT_FILES) > 10 and (ROOT / "chip_smoke.py") in PORT_FILES


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_of_jax_or_the_reference(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_scan_catches_forbidden_imports(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import os\nfrom repro.core import memento\nimport jax.numpy as jnp\n"
                 "from . import sibling\nimport repro_torch\n")
    assert [m for m in _imports(f) if m.split(".")[0] in FORBIDDEN] == ["repro.core", "jax.numpy"]


def test_importing_the_port_loads_neither_jax_nor_repro():
    code = ("import sys, repro_torch, repro_torch.convert, repro_torch.kernels.build\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
                         check=True, timeout=120)
    assert out.stdout.strip() == "[]"


def test_default_device_needs_a_gpu(monkeypatch):
    from repro_torch.core.image_store import DeviceImageStore
    from repro_torch.core.memento import MementoHash
    from repro_torch.data import ShardPlacement
    from repro_torch.launch import FollowerImageStore, ReplicationGroup
    from repro_torch.runtime import ElasticCluster
    from repro_torch.serve.plane import ShardedLookupPlane
    from repro_torch.serve.router import SessionRouter

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceImageStore(MementoHash(8, variant="32"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SessionRouter(8)
    assert SessionRouter(8, device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ShardPlacement(64, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ElasticCluster(8, num_shards=64)
    store = DeviceImageStore(MementoHash(8, variant="32"), device="cpu")
    with pytest.raises(RuntimeError, match="devices=\\['cpu'\\]"):
        ShardedLookupPlane(store)
    assert ShardPlacement(64, 8, device="cpu").device.type == "cpu"
    assert ElasticCluster(8, num_shards=64, device="cpu").placement.device.type == "cpu"
    assert ShardedLookupPlane(store, devices=["cpu"]).devices == [torch.device("cpu")]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FollowerImageStore()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ReplicationGroup(MementoHash(8, variant="32"))
    assert FollowerImageStore(device="cpu").device.type == "cpu"
    group = ReplicationGroup(MementoHash(8, variant="32"), 2, device="cpu")
    assert [f.device.type for f in group.followers] == ["cpu", "cpu"]


def test_chip_smoke_alone_fails_without_the_repo(tmp_path):
    """Copied into a directory with nothing else of the repository, the
    script exits non-zero and prints no result."""
    script = tmp_path / "chip_smoke.py"
    script.write_text((ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                         cwd=tmp_path, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
