"""The port's CUDA build keys: what ``kernels/_build.target`` hashes.

Nothing is compiled here (no ``nvcc`` on a CPU host); the tests check
that a library is rebuilt when anything it is compiled from changes.
"""

from __future__ import annotations

import shutil

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of ``csrc`` that ``_build`` reads instead of the package's."""
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    return copy


@pytest.mark.parametrize("edited", ["ssd.cu", "mma.cuh"])
def test_target_changes_with_the_source_and_the_shared_header(csrc, edited):
    before = _build.target("ssd")
    with open(csrc / edited, "a") as f:
        f.write("\n// edited\n")
    assert _build.target("ssd") != before


def test_target_ignores_other_kernels_sources(csrc):
    before = _build.target("ssd")
    with open(csrc / "wkv6.cu", "a") as f:
        f.write("\n// edited\n")
    (csrc / "notes.txt").write_text("not a header")
    assert _build.target("ssd") == before


def test_blocks_per_sm():
    """228 KiB an SM, 1 KiB of it kept by the runtime for each block."""
    assert _build.blocks_per_sm(0) == 228
    assert _build.blocks_per_sm(114688) == 2
    assert _build.blocks_per_sm(116 * 1024) == 1
