"""Build and load the package's CUDA kernels (csrc/*.cu) with nvcc.

Each source is compiled at first use into a shared library with a plain C
interface, ``_build/lib<name>_<source hash>.so`` inside the package, and
loaded with ctypes. Nothing here runs at import time: the CPU tests import
every module on machines without nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _so_path(name: str) -> str:
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        h = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD, f"lib{name}_{h}.so")


def build(names) -> dict[str, tuple[float, str]]:
    """Compile every named source that is not built yet, all nvcc processes
    started together. Returns {name: (seconds, ptxas report)} for what it
    compiled; raises with the compiler's output if one fails."""
    import time
    os.makedirs(BUILD, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        so = _so_path(name)
        if os.path.exists(so):
            continue
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp,
               os.path.join(CSRC, name + ".cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT), tmp, so)
    done = {}
    failed = []
    for name, (p, tmp, so) in procs.items():
        out, _ = p.communicate()
        log = out.decode(errors="replace")
        if p.returncode != 0:
            failed.append(f"{name}.cu:\n{log}")
            continue
        os.replace(tmp, so)
        done[name] = (time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return done


def entry(name: str, symbol: str, argtypes):
    """C entry point `symbol` of csrc/<name>.cu (built and loaded first if
    needed), declared to take `argtypes` and return an int cudaError_t."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(_so_path(name))
            _libs[name] = lib
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def check_tensor(t, name: str, dtype, dev, shape=None) -> None:
    """Raise unless t is a contiguous `dtype` tensor on `dev` (of `shape`)."""
    if t.device != dev or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: want contiguous {dtype} on {dev}, got "
                         f"{t.dtype} on {t.device}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: want shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")


def stream_ptr():
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
