"""Build and load the port's CUDA C++ kernels.

Each source under ``beyond_deep_ensembles_tpu_torch/csrc/`` exports a plain C
interface. At first use ``load`` compiles it with ``nvcc`` for Hopper
(``sm_90a``) into a shared library under ``build/kernels/`` at the root of the
checkout, named by a hash of the source and the flags, and loads it with
``ctypes``. The library is written under a temporary name and renamed, so a
second process building the same source at the same time never loads a
half-written file. A failed build raises; nothing falls back to the plain
version.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE = Path(__file__).resolve().parents[1]
SOURCES = PACKAGE / "csrc"
BUILD = PACKAGE.parent / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# what nvcc printed for each library built in this process (ptxas register
# and spill counts), by source name
build_logs: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return path


@functools.cache
def load(source: str) -> ctypes.CDLL:
    """The library built from ``csrc/<source>``, compiled on first use."""
    src = SOURCES / source
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD / f"{src.stem}-{digest}.so"
    if not lib.exists():
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed on {src.name} ({res.returncode}):\n{res.stdout}{res.stderr}")
        os.replace(tmp, lib)
        build_logs[source] = res.stdout + res.stderr
    return ctypes.CDLL(str(lib))
