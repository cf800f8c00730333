"""Build the port's CUDA kernels at first use.

Each source under csrc/ compiles with nvcc for Hopper (sm_90a) into a
shared library with a plain C interface, loaded with ctypes: no PyTorch
headers, so a build takes seconds. Libraries land in kernels/_build/
(git-ignored), named by a hash of the source and flags, so an edited
source rebuilds and an unchanged one loads from disk.

    python -m ouster_sdk_tpu_torch.kernels.build     # build all, print ptxas
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Tuple

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
SOURCES = ("planar_project.cu", "packet_project.cu", "lutfree_project.cu")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
#: ptxas report and seconds of each build made in this process
build_log: Dict[str, Tuple[str, float]] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def _lib_path(source: str) -> str:
    with open(os.path.join(CSRC, source), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest.hexdigest()[:16]}.so")


def _compile(source: str) -> str:
    out = _lib_path(source)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        res = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
             os.path.join(CSRC, source)],
            capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{res.stderr}")
        os.replace(tmp, out)  # atomic: a reader never sees a partial library
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    build_log[source] = (res.stderr, time.perf_counter() - t0)
    return out


def build_all() -> Dict[str, str]:
    """Compile every source, one nvcc each, all started together."""
    with ThreadPoolExecutor(max_workers=len(SOURCES)) as pool:
        paths = list(pool.map(_compile, SOURCES))
    return dict(zip(SOURCES, paths))


def load(source: str) -> ctypes.CDLL:
    """The compiled library of `source`, building it at first use."""
    lib = _libs.get(source)
    if lib is None:
        lib = _libs[source] = ctypes.CDLL(_compile(source))
    return lib


if __name__ == "__main__":
    for src, path in build_all().items():
        log, secs = build_log.get(src, ("(cached)", 0.0))
        print(f"{src} -> {path} ({secs:.1f} s)\n{log}")
