"""Build and load the package's CUDA kernels (csrc/*.cu) with nvcc.

Each source is compiled at first use into a shared library with a plain C
interface, ``_build/lib<name>_<source hash>.so`` inside the package, and
loaded with ctypes. The hash covers the source and every csrc/*.cuh header
it includes, so an edited header rebuilds its users. Nothing here runs at
import time: the CPU tests import every module on machines without nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

TILE = 16384          # positions per tile of the resolve, tile_resolve.cuh
_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"/]+\.cuh)"', re.M)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _so_path(name: str) -> str:
    """Where csrc/<name>.cu builds to: the name of the library holds a hash
    of the source and of every csrc header it includes, directly or through
    another header."""
    h = hashlib.sha256()
    todo, seen = [name + ".cu"], set()
    while todo:
        f = todo.pop()
        if f in seen:
            continue
        seen.add(f)
        with open(os.path.join(CSRC, f), "rb") as fh:
            text = fh.read()
        h.update(f.encode() + b"\0" + text)
        todo += sorted(m.decode() for m in _INCLUDE.findall(text))
    return os.path.join(BUILD, f"lib{name}_{h.hexdigest()[:16]}.so")


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


def resolve_scratch(n: int, dev, lead: int = 0):
    """Scratch of the ordered-tile resolve over n positions: the map (int32,
    whole tiles) and the sync words (int32, zeroed on every call): `lead`
    words of the caller's, then the ticket and one flag per tile."""
    import torch
    tiles = -(-n // TILE)
    return (torch.empty(tiles * TILE, dtype=torch.int32, device=dev),
            torch.zeros(lead + 1 + tiles, dtype=torch.int32, device=dev))


def stream_ptr():
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
