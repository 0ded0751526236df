"""The examples on the port (``examples/*_torch.py``) against the
reference's (``examples/*.py``).

Each port example runs with ``--device cpu`` at its smoke size in a
subprocess of its own (the five at once); each reference example runs in
this process, its output captured. Where both print an exact figure, the
two agree: the mount's generation before and after the online upgrade,
the checkpoint files, the steps trained; the boundary's gate crossings,
bulk cache passes, per-entry errnos and journal checksum calls; the
trainer's steps across the module swap, the swaps' failures; the
recoveries and shard retries of the failure-injected run. Times and
losses differ (the packages draw other weights from one seed).
"""

from __future__ import annotations

import os
import re
import runpy
import subprocess
import sys

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")
EXAMPLES = os.path.join(ROOT, "examples")
# example -> arguments (both packages; the port's also get --device cpu)
RUNS = {"quickstart": [], "batched_io_demo": [], "online_upgrade_demo": [],
        "serve_batched": [],
        # step 16 sees the first shard again, so the loss falls in both
        "train_small_lm": ["--steps", "17", "--fail-at", "7"]}


@pytest.fixture(scope="module")
def port_outputs():
    """Every port example's stdout, the five run at once (a thread each)."""
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    procs = {name: subprocess.Popen(
        [sys.executable, os.path.join(EXAMPLES, f"{name}_torch.py"),
         "--device", "cpu", *args], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for name, args in RUNS.items()}
    out = {}
    try:
        for name, p in procs.items():
            stdout, stderr = p.communicate(timeout=300)
            assert p.returncode == 0, (name, stdout[-2000:], stderr[-2000:])
            out[name] = stdout
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def reference_output(name, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *RUNS[name]])
    capsys.readouterr()
    runpy.run_path(os.path.join(EXAMPLES, f"{name}.py"), run_name="__main__")
    return capsys.readouterr().out


def figures(pattern, text):
    return re.findall(pattern, text, re.M)


def test_quickstart(port_outputs, capsys, monkeypatch):
    port, ref = port_outputs["quickstart"], reference_output(
        "quickstart", capsys, monkeypatch)
    for pat in (r"^mounted (\w+) \(generation (\d+)\)",
                r"over (\d+) steps$", r"^checkpoints: (.*)$",
                r"pause, generation (\d+)$", r"^(OK)$"):
        assert figures(pat, port) == figures(pat, ref) != [], pat
    gen = figures(r"^generated: \[(.*)\]$", port)
    assert len(gen) == 1 and len(gen[0].split(",")) == 8


def test_batched_io_demo(port_outputs, capsys, monkeypatch):
    port, ref = port_outputs["batched_io_demo"], reference_output(
        "batched_io_demo", capsys, monkeypatch)
    for pat in (r"^scalar : (\d+) reads, (\d+) gate crossings",
                r"^batched: (\d+) reads, (\d+) gate crossings, (\d+) bulk",
                r"^mixed  : (.*)$",
                r"^queue  : (\d+) completions, (\d+) journal checksum"):
        assert figures(pat, port) == figures(pat, ref) != [], pat


def test_online_upgrade_demo(port_outputs, capsys, monkeypatch):
    port, ref = port_outputs["online_upgrade_demo"], reference_output(
        "online_upgrade_demo", capsys, monkeypatch)
    for pat in (r"^  v1 @ step (\d+):", r"^  v2 @ step (\d+):",
                r"ops during swaps, (\d+) failures$", r"^(OK)$",
                r"^== (.*) ==$"):
        assert figures(pat, port) == figures(pat, ref) != [], pat
    assert int(figures(r"^  (\d+) provenance records", port)[0]) > 0


def test_serve_batched(port_outputs, capsys, monkeypatch):
    port, ref = port_outputs["serve_batched"], reference_output(
        "serve_batched", capsys, monkeypatch)
    pat = r"^([\w.-]+): batch=(\d+) "
    assert figures(pat, port) == figures(pat, ref) != []
    assert figures(r"^generated ids: \[(\d+), (\d+)\]$", port) == [
        ("4", "16")]


def test_train_small_lm(port_outputs, capsys, monkeypatch):
    port, ref = port_outputs["train_small_lm"], reference_output(
        "train_small_lm", capsys, monkeypatch)
    for pat in (r"^([\w.-]+): (\d+) steps in",
                r"recoveries=(\d+) shard_retries=(\d+)$"):
        assert figures(pat, port) == figures(pat, ref) != [], pat
    assert figures(r"recoveries=(\d+)", port) == ["1"]
    first, last = map(float, figures(r"loss ([\d.]+) -> ([\d.]+)", port)[0])
    assert last < first
