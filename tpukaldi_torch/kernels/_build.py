"""Build and load the port's CUDA kernels.

Each kernel source under `csrc/` is compiled at first use with `nvcc` for
Hopper (`sm_90a`) into a shared library with a plain C interface, loaded
with `ctypes`.  The library lands in `build/tpukaldi_torch/` beside the
package (a directory `.gitignore` lists), named by a hash of its source, the
shared headers (`csrc/*.cuh`) and the flags, so an edited source or header
is rebuilt and an unchanged one is reused.  Beside it, `<library>.txt`
keeps ptxas's report of the build: each kernel's registers, spills and
shared memory.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "tpukaldi_torch",
)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.isfile(path):
        raise RuntimeError(
            "nvcc not found on PATH or under CUDA_HOME; the CUDA kernels "
            "are built from source and need the CUDA toolkit")
    return path


def library_path(source: str) -> str:
    """Where the library built from `csrc/<source>` lives."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(_CSRC) if f.endswith(".cuh"))
    for name in (source, *headers):
        with open(os.path.join(_CSRC, name), "rb") as f:
            digest.update(f.read())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{digest.hexdigest()[:16]}.so")


def build(source: str) -> str:
    """Compile `csrc/<source>` unless its library exists; returns the path."""
    lib = library_path(source)
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.tmp.{os.getpid()}"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(_CSRC, source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {source}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    with open(f"{lib}.txt", "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp, lib)  # atomic: a reader never sees a partial library
    return lib


def load(source: str) -> ctypes.CDLL:
    """Build (if needed) and load the library of `csrc/<source>`."""
    if source not in _loaded:
        _loaded[source] = ctypes.CDLL(build(source))
    return _loaded[source]
