"""Builds the port's CUDA sources and loads them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds).  Libraries are built at first use into
``rnd_semantic_segmentation_torch/build/``, which git ignores, under a name
that carries a hash of the source and the flags: an edited source rebuilds.
Several sources build in parallel, one ``nvcc`` process each.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Tuple

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin): "
                       "the port's CUDA kernels are built from source at first use")


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, name + ".cu")


def library_path(name: str) -> str:
    with open(source_path(name), "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"lib{name}-{digest[:16]}.so")


def build(names: Iterable[str]) -> Dict[str, Tuple[float, str]]:
    """Compiles every named source whose library is missing, all at once.

    Returns ``{name: (seconds, compiler output)}`` for the sources it built;
    the compiler output holds ptxas' register and shared-memory report.
    """
    os.makedirs(BUILD_DIR, exist_ok=True)
    started = {}
    for name in names:
        so = library_path(name)
        if os.path.exists(so):
            continue
        tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, source_path(name)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, so, time.perf_counter())
    built = {}
    for name, (proc, tmp, so, t0) in started.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source_path(name)}:\n{out}")
        os.replace(tmp, so)
        built[name] = (time.perf_counter() - t0, out)
    return built


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(library_path(name))
            _libs[name] = lib
        return lib
