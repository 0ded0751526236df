"""The port stands alone: it imports torch, never jax, and nothing of the
reference package ``repro``."""

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
    r"|import\s+repro(\.|\s|,|$)|from\s+repro(\.|\s))", re.M)


def test_importing_the_port_loads_no_jax_and_no_reference():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "repro_torch.fs.mounts" in MODULES


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
    assert not _FORBIDDEN.search("from repro_torch.fs import layout")
    assert not _FORBIDDEN.search("import repro_torch")
