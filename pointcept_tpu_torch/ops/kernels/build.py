"""Builds the sources in `pointcept_tpu_torch/csrc/` and loads them.

Each CUDA source (``.cu``) is compiled by its own `nvcc` into a shared
library with a plain C interface (no PyTorch headers: a build takes seconds)
and loaded with `ctypes`. Libraries land in ``build/kernels/`` at the
repository root, named by a hash of their source, the sources it includes,
the shared headers (`csrc/*.cuh`) and the flags, so an unchanged source is
not rebuilt.
`build_all` starts one `nvcc` per source, all at once. A host source
(``.cpp``: PointGroup's clustering) is compiled by `g++` the same way
(`load_host`).

Nothing here runs at import: a library is built the first time a wrapper
launches its kernel on a CUDA tensor (or calls its host library), or when
`build_all` is called.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]
# ISO C++ (not gnu++): g++ then contracts no multiply-add into an FMA, so a
# host library's float results do not depend on the build machine
GXX_FLAGS = ["-std=c++17", "-O3", "-shared", "-fPIC"]

_libs: Dict[str, ctypes.CDLL] = {}
_host_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set NVCC or install the CUDA toolkit under /usr/local/cuda")


def _target(name: str) -> Path:
    """The library's path, named by a hash of its source, the other sources
    of `csrc/` it includes (the RPE halves include the attention kernels),
    the headers of `csrc/` (any of which it may include) and the flags."""
    data = (CSRC / f"{name}.cu").read_bytes()
    for inc in re.findall(rb'#include "([^"]+\.cu)"', data):
        data += (CSRC / inc.decode()).read_bytes()
    data += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    h = hashlib.sha256(data + " ".join(ARCH_FLAGS + NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{h}.so"


def _compile(name: str) -> subprocess.Popen:
    out = _target(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *ARCH_FLAGS, *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    proc.target, proc.tmp = out, tmp
    return proc


def build_all(names: Iterable[str]) -> Dict[str, str]:
    """Compile every stale library in parallel; returns nvcc's output (with
    `-Xptxas -v`: registers, shared memory, spills) per compiled source."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {n: _compile(n) for n in names if not _target(n).exists()}
    logs = {}
    for n, p in procs.items():
        out, _ = p.communicate()
        logs[n] = out
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {n}.cu:\n{out}")
        os.replace(p.tmp, p.target)
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(_target(name)))
            _libs[name] = lib
        return lib


def _gxx() -> str:
    for cand in (os.environ.get("CXX"), shutil.which("g++")):
        if cand and shutil.which(cand):
            return cand
    raise RuntimeError("g++ not found: set CXX or install a C++ compiler")


def _host_target(name: str) -> Path:
    data = (CSRC / f"{name}.cpp").read_bytes()
    h = hashlib.sha256(data + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{h}.so"


def load_host(name: str) -> ctypes.CDLL:
    """The loaded library of the host source `csrc/<name>.cpp`, built with
    `g++` first if needed; raises when it does not build."""
    with _lock:
        key = f"{name}.cpp"
        lib = _host_libs.get(key)
        if lib is None:
            out = _host_target(name)
            if not out.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                proc = subprocess.run([_gxx(), *GXX_FLAGS, "-o", str(tmp), str(CSRC / key)],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(f"g++ failed for {key}:\n{proc.stdout}")
                os.replace(tmp, out)
            lib = _host_libs[key] = ctypes.CDLL(str(out))
        return lib


def cfunc(name: str, symbol: str, argtypes: list):
    """A C function of library `name` with its argument types set; every
    pointer and the stream are `c_void_p` so that ctypes keeps all 64 bits."""
    fn = getattr(load(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def check(status: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {status}")


INT32_MAX = 2**31 - 1


def check_int32(what: str, **counts: int) -> None:
    """Raise where a count the kernel takes as an `int` (an element count,
    a row, an int32 code) passes 2^31 - 1: the kernel would read wrong rows."""
    for name, value in counts.items():
        if value > INT32_MAX:
            raise ValueError(f"{what}: {name} = {value} passes 2^31 - 1, the kernel's int range")
