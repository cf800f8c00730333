"""Build the port's CUDA kernels at first use, and bind their launchers.

Each source under csrc/ compiles with nvcc for Hopper (sm_90a) into a
shared library with a plain C interface, loaded with ctypes: no PyTorch
headers, so a build takes seconds. Libraries land in kernels/_build/
(git-ignored), named by a hash of the source and flags, so an edited
source rebuilds and an unchanged one loads from disk.

Every C launcher returns 0 or an error code that the source's
`<stem>_error_string` names, and takes PyTorch's stream last. `bind`
turns such launchers into Python calls; `check_operand` is the check that
every wrapper makes of the tensors it hands them.

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
from typing import Callable, Dict, Sequence, Tuple

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
SOURCES = ("planar_project.cu", "packet_project.cu", "lutfree_project.cu",
           "icp_nn.cu", "voxel_map.cu", "slam_gather.cu", "xyz_project.cu")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
#: launch symbols of each bound source and their argument types, the
#: stream left out; typed in the library at its first call
_signatures: Dict[str, Dict[str, Sequence]] = {}
_typed: Dict[str, ctypes.CDLL] = {}
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


def _typed_lib(source: str) -> ctypes.CDLL:
    lib = _typed.get(source)
    if lib is None:
        lib = load(source)
        for symbol, argtypes in _signatures[source].items():
            fn = getattr(lib, symbol)
            fn.argtypes = [*argtypes, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        fn = getattr(lib, _error_string(source))
        fn.argtypes = [ctypes.c_int]
        fn.restype = ctypes.c_char_p
        _typed[source] = lib
    return lib


def _error_string(source: str) -> str:
    return os.path.splitext(source)[0] + "_error_string"


def call(source: str, symbol: str, what: str, *args) -> None:
    """Call launch `symbol` of `source` (bound with `bind`) with `args`,
    the stream included, and raise RuntimeError("<what> launch failed:
    <message> (<code>)") if it returns nonzero."""
    lib = _typed_lib(source)
    err = getattr(lib, symbol)(*args)
    if err != 0:
        msg = getattr(lib, _error_string(source))(err).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({err})")


def bind(source: str, *launches: Tuple[str, str, Sequence]
         ) -> Tuple[Callable[..., None], ...]:
    """One launcher for each (symbol, what, argtypes) of `source`, argtypes
    without the trailing stream. `launcher(device, *args)` enters
    `device`, appends the device's current stream to `args` and calls the
    symbol as `call` does. It neither synchronizes nor allocates, so a
    CUDA graph capture records the launch as the eager call issues it.
    The library is built, loaded and typed at the first call."""
    _signatures[source] = {symbol: argtypes for symbol, _, argtypes
                           in launches}

    def launcher(symbol: str, what: str) -> Callable[..., None]:
        def launch(device: torch.device, *args) -> None:
            with torch.cuda.device(device):
                stream = torch.cuda.current_stream(device).cuda_stream
                call(source, symbol, what, *args, stream)
        return launch

    return tuple(launcher(symbol, what) for symbol, what, _ in launches)


def check_operand(t: torch.Tensor, name: str, dtype: torch.dtype,
                  shape: Tuple[int, ...], device: torch.device) -> None:
    """Raise ValueError unless `t` is a contiguous `dtype` tensor of
    `shape` on `device`: what a launcher takes of every operand."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the frames on {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def bit_mask(size: int) -> int:
    """The mask of a field's `size` low bits, as a uint32."""
    return (1 << size) - 1 if size < 32 else 0xFFFFFFFF


if __name__ == "__main__":
    for src, path in build_all().items():
        log, secs = build_log.get(src, ("(cached)", 0.0))
        print(f"{src} -> {path} ({secs:.1f} s)\n{log}")
