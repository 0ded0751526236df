"""The port stands alone: it imports torch, never jax, nothing of the
reference package ``repro``, and not ``ml_dtypes`` (which the card's
machine does not have)."""

from __future__ import annotations

import os
import pathlib
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"
MODULES = sorted(
    ".".join(p.relative_to(SRC).with_suffix("").parts).replace(
        ".__init__", "")
    for p in PORT.rglob("*.py"))

_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b"
    r"|import\s+ml_dtypes\b|from\s+ml_dtypes\b"
    r"|import\s+repro(\.|\s|,|$)|from\s+repro(\.|\s))", re.M)

# the training stack's file-system consumers: the checkpoint store, the
# reshard planner, the sharding rules, meshes, MeshCap, the data shards
FS_CONSUMERS = ("repro_torch.checkpoint", "repro_torch.checkpoint.store",
                "repro_torch.distributed", "repro_torch.distributed.resharding",
                "repro_torch.distributed.sharding", "repro_torch.launch.mesh",
                "repro_torch.data", "repro_torch.data.pipeline",
                "repro_torch.core.capability")


def test_importing_the_port_loads_no_jax_and_no_reference():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'ml_dtypes' or m.startswith('ml_dtypes.')\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "repro_torch.fs.mounts" in MODULES
    assert set(FS_CONSUMERS) <= set(MODULES)


@pytest.mark.parametrize("module", FS_CONSUMERS)
def test_fs_consumers_load_alone_without_jax_reference_or_ml_dtypes(module):
    """Each module of the checkpoint/data slice, imported on its own (and
    used: a sharded save and restore for the store)."""
    use = ""
    if module == "repro_torch.checkpoint.store":
        use = (
            "import torch\n"
            "from repro_torch.fs.mounts import make_mount\n"
            "from repro_torch.distributed.resharding import ShardGrid\n"
            "mf = make_mount('bento', 4096, device='cpu')\n"
            "t = {'w': torch.ones(4, 4, dtype=torch.bfloat16)}\n"
            "g = {'w': ShardGrid.from_spec((4, 4), ('d',), {'d': 2})}\n"
            "m = importlib.import_module(" + repr(module) + ")\n"
            "m.save(mf.view, '/c', t, step=0, shardings=g)\n"
            "b, _ = m.load(mf.view, '/c', t, device='cpu')\n"
            "assert torch.equal(b['w'], t['w'])\n")
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({module!r})\n" + use +
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'repro', 'ml_dtypes'))\n"
        "sys.exit(1 if bad else 0)\n")
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(PORT)) for p in PORT.rglob("*.py")))
def test_no_source_imports_jax_or_the_reference(path):
    hits = [m.group(0).strip()
            for m in _FORBIDDEN.finditer((PORT / path).read_text())]
    assert hits == []


def test_forbidden_pattern_spares_the_port_itself():
    assert _FORBIDDEN.search("from repro.fs import layout")
    assert _FORBIDDEN.search("import repro.core")
    assert _FORBIDDEN.search("from repro import fs")
    assert _FORBIDDEN.search("    import jax.numpy as jnp")
    assert _FORBIDDEN.search("        import ml_dtypes")
    assert _FORBIDDEN.search("from ml_dtypes import bfloat16")
    assert not _FORBIDDEN.search("from repro_torch.fs import layout")
    assert not _FORBIDDEN.search("import repro_torch")
