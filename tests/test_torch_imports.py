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

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
PORT = SRC / "repro_torch"
# the port's files outside its package: the card's smoke, its allocator
# probe and the examples
PORT_SCRIPTS = ["chip_smoke.py", "peak_blocks.py"] + sorted(
    str(p.relative_to(ROOT)) for p in (ROOT / "examples").glob("*_torch.py"))
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

# the training slice: the optimizer, the step, the trainer and its CLI, and
# the layer loop with remat
TRAINING = ("repro_torch.optim", "repro_torch.optim.adamw",
            "repro_torch.train", "repro_torch.train.step",
            "repro_torch.train.trainer", "repro_torch.launch.train",
            "repro_torch.models.scan_utils")

# the ssm/hybrid training and MoE slice: the scans' backward by recompute,
# the MoE layer and the parameter counts
MOE_AND_SCAN_GRADS = ("repro_torch.kernels._autograd",
                      "repro_torch.models.moe", "repro_torch.models.registry")


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
    assert set(TRAINING) <= set(MODULES)
    assert set(MOE_AND_SCAN_GRADS) <= set(MODULES)


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


@pytest.mark.parametrize("module", TRAINING)
def test_training_modules_load_alone_without_jax_reference_or_ml_dtypes(
        module):
    """Each module of the training slice, imported on its own (and used:
    one step of the smoke trainer on the CPU for the trainer)."""
    use = ""
    if module == "repro_torch.train.trainer":
        use = (
            "from repro_torch.configs import registry\n"
            "b = registry.get('smollm-135m')\n"
            "m = importlib.import_module(" + repr(module) + ")\n"
            "t = m.Trainer(b.smoke, b.run, global_batch=2, seq_len=8,\n"
            "              device='cpu')\n"
            "assert t.train(1)['loss'] > 0\n")
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


@pytest.mark.parametrize("module", MOE_AND_SCAN_GRADS)
def test_moe_and_scan_grad_modules_load_alone_without_jax_or_reference(
        module):
    """Each new module of the slice, imported on its own (and used: the
    olmoe smoke config's counts for the registry, a MoE layer's forward
    and backward for the layer)."""
    use = ""
    if module == "repro_torch.models.registry":
        use = (
            "from repro_torch.configs import registry\n"
            "m = importlib.import_module(" + repr(module) + ")\n"
            "cfg = registry.get('olmoe-1b-7b').model\n"
            "assert m.param_count(cfg, active_only=True) == 1_281_951_744\n")
    elif module == "repro_torch.models.moe":
        use = (
            "import torch\n"
            "from repro_torch.configs import registry\n"
            "from repro_torch.distributed.sharding import ShardingCtx\n"
            "from repro_torch.models import params as P\n"
            "m = importlib.import_module(" + repr(module) + ")\n"
            "cfg = registry.get('olmoe-1b-7b').smoke\n"
            "w = P.materialize(m.moe_specs(cfg), torch.Generator(), 'cpu')\n"
            "x = torch.randn(2, 8, cfg.d_model, requires_grad=True)\n"
            "y, aux = m.moe_apply(cfg, ShardingCtx.null(), w, x)\n"
            "(y.sum() + aux).backward()\n"
            "assert x.grad is not None\n")
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


@pytest.mark.parametrize("path", PORT_SCRIPTS)
def test_port_scripts_import_neither_jax_nor_the_reference(path):
    """``chip_smoke.py``, ``peak_blocks.py`` and the
    ``examples/*_torch.py`` hold to the package's rule."""
    hits = [m.group(0).strip()
            for m in _FORBIDDEN.finditer((ROOT / path).read_text())]
    assert hits == []


def test_port_scripts_are_the_smoke_the_probe_and_five_examples():
    assert PORT_SCRIPTS == [
        "chip_smoke.py", "peak_blocks.py", "examples/batched_io_demo_torch.py",
        "examples/online_upgrade_demo_torch.py",
        "examples/quickstart_torch.py", "examples/serve_batched_torch.py",
        "examples/train_small_lm_torch.py"]


def test_forbidden_pattern_spares_the_port_itself():
    assert _FORBIDDEN.search("from repro.fs import layout")
    assert _FORBIDDEN.search("import repro.core")
    assert _FORBIDDEN.search("from repro import fs")
    assert _FORBIDDEN.search("    import jax.numpy as jnp")
    assert _FORBIDDEN.search("        import ml_dtypes")
    assert _FORBIDDEN.search("from ml_dtypes import bfloat16")
    assert not _FORBIDDEN.search("from repro_torch.fs import layout")
    assert not _FORBIDDEN.search("import repro_torch")
