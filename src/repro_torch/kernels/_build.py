"""Builds the port's CUDA sources at first use and loads them with ctypes.

Each ``csrc/<name>.cu`` is compiled by its own ``nvcc`` for ``sm_90a``
(several sources build at once, ``build_all``) into a shared library with
a plain C interface,
``build/repro_torch/<name>-<digest>.so`` at the root of the checkout. The
digest covers the source, the shared headers (``csrc/*.cuh``) and the
flags, so an edited source or header builds anew and an unchanged one is
reused. A ``threading.Lock`` serialises callers
in one process (the parallel drain and the SQPOLL thread can reach a
kernel at once) and a file lock serialises processes sharing the build
directory. Nothing here runs at import: this module imports on hosts
with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

SM_SMEM = 233472  # bytes of shared memory on one H100 SM (228 KiB)
BLOCK_RESERVED = 1024  # of which the runtime keeps this much per block

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    found = str(path) if path.exists() else shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH); the "
            "CUDA kernels build on a machine with the CUDA toolkit")
    return found


def target(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed by the source, the shared
    headers ``csrc/*.cuh`` it may include, and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update("\0".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Iterable[str]) -> Dict[str, Path]:
    """Compile each ``csrc/<name>.cu`` that has no up-to-date library, one
    ``nvcc`` per source, all started together, and return every name's
    path. Raises with the compilers' output when any nvcc fails."""
    targets = {name: target(name) for name in names}
    if all(t.exists() for t in targets.values()):
        return targets
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lockfile:
        fcntl.flock(lockfile, fcntl.LOCK_EX)
        try:
            # another process may have built some while we waited
            procs = {}
            for name, t in targets.items():
                if not t.exists():
                    tmp = t.with_name(f"{t.name}.{os.getpid()}.tmp")
                    procs[name] = (tmp, subprocess.Popen(
                        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                         str(CSRC / f"{name}.cu")],
                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                        text=True))
            failed = []
            for name, (tmp, proc) in procs.items():
                out, _ = proc.communicate()
                targets[name].with_suffix(".log").write_text(out)
                if proc.returncode != 0:
                    tmp.unlink(missing_ok=True)
                    failed.append(f"CUDA build of {name}.cu failed (nvcc exit "
                                  f"{proc.returncode}):\n{out}")
                else:
                    os.replace(tmp, targets[name])
            if failed:
                raise RuntimeError("\n".join(failed))
        finally:
            fcntl.flock(lockfile, fcntl.LOCK_UN)
    return targets


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists, and
    return its path."""
    return build_all([name])[name]


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) from the build of ``csrc/<name>.cu``, or "" if none is kept."""
    log = target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(build(name)))
        return lib


def blocks_per_sm(smem: int) -> int:
    """How many blocks of ``smem`` bytes of dynamic shared memory fit on
    one H100 SM at once (registers and threads may allow fewer)."""
    return SM_SMEM // (smem + BLOCK_RESERVED)
