"""Build and load the port's CUDA kernels.

Each source under flexflow_tpu_torch/csrc/ is compiled with `nvcc` for
Hopper (`sm_90a`) into a shared library with a plain C interface, then
loaded with ctypes. The library lands in flexflow_tpu_torch/_build/
(listed in .gitignore), named by a hash of its source and flags, so the
first call in a fresh checkout builds it and later calls load it. Nothing
here runs at import: the CPU test suite imports every module of the port
on machines without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
# one lock per source, so several sources build at once from threads
_source_locks: Dict[str, threading.Lock] = {}
_loaded: Dict[str, ctypes.CDLL] = {}
#: nvcc's output (ptxas register / shared-memory report) per source
build_logs: Dict[str, str] = {}


def find_nvcc() -> str:
    """The nvcc that builds the kernels: on PATH, else under the CUDA
    toolkit PyTorch itself locates (CUDA_HOME)."""
    path = shutil.which("nvcc")
    if path:
        return path
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are built from "
        "flexflow_tpu_torch/csrc at first use and need the CUDA toolkit"
    )


def nvcc_command(nvcc: str, source: str, output: str) -> list:
    return [nvcc, *NVCC_FLAGS, "-o", output, source]


def library_path(source_name: str) -> str:
    """Where the library built from csrc/<source_name> lives: the name
    carries a hash of the source text and the flags, so an edited source
    never loads a stale build."""
    with open(os.path.join(CSRC, source_name), "rb") as f:
        h = hashlib.sha256(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source_name)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{h.hexdigest()[:16]}.so")


def load(source_name: str) -> ctypes.CDLL:
    """Build csrc/<source_name> if its library is missing, then load it
    (once per process). Calls for different sources from different
    threads build in parallel."""
    with _lock:
        source_lock = _source_locks.setdefault(source_name, threading.Lock())
    with source_lock:
        lib = _loaded.get(source_name)
        if lib is not None:
            return lib
        out = library_path(source_name)
        if not os.path.exists(out):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{out[:-3]}.{os.getpid()}.tmp.so"
            cmd = nvcc_command(
                find_nvcc(), os.path.join(CSRC, source_name), tmp
            )
            res = subprocess.run(cmd, capture_output=True, text=True)
            build_logs[source_name] = res.stdout + res.stderr
            if res.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {source_name} ({' '.join(cmd)}):\n"
                    f"{res.stderr}"
                )
            os.replace(tmp, out)
        lib = ctypes.CDLL(out)
        _loaded[source_name] = lib
        return lib
