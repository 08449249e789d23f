"""Build and load the port's CUDA C++ kernels.

Each source under ``beyond_deep_ensembles_tpu_torch/csrc/`` exports a plain C
interface. At first use ``load`` compiles it with ``nvcc`` for Hopper
(``sm_90a``) into a shared library under ``build/kernels/`` at the root of the
checkout, named by a hash of the source and the flags, and loads it with
``ctypes``. The library is written under a temporary name and renamed, so a
second process building the same source at the same time never loads a
half-written file. ``build`` compiles several sources at once, one nvcc
process each, as ``chip_smoke.py`` does before its first launch. A failed
build raises; nothing falls back to the plain version.
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


def _library_path(source: str) -> Path:
    src = SOURCES / source
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD / f"{src.stem}-{digest}.so"


def build(*sources: str) -> None:
    """Compile every source whose library is missing, one nvcc each, all at
    once; raises if any fails."""
    running = []
    for source in sources:
        lib = _library_path(source)
        if lib.exists():
            continue
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES / source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((source, lib, tmp, proc))
    failed = []
    for source, lib, tmp, proc in running:
        log = proc.communicate()[0]
        build_logs[source] = log
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed on {source} ({proc.returncode}):\n{log}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))


@functools.cache
def load(source: str) -> ctypes.CDLL:
    """The library built from ``csrc/<source>``, compiled on first use."""
    build(source)
    return ctypes.CDLL(str(_library_path(source)))
