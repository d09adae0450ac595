"""Running max and min along the last dimension: the inclusive scans of
the encoder's coding stages (the window anchors, the pack's word bounds,
the match walk's next candidate, the split's groups, the precode runs).

On a card one hand-written kernel, csrc/rowscan.cu, scans every row at
once in tiles over all SMs; running_ref, torch.cummax / torch.cummin (one
thread block a row, and indices nobody reads), is its plain version and
the CPU's route.
"""
from __future__ import annotations

import ctypes

import torch

TILE = 2048           # elements a block scans, csrc/rowscan.cu kTile
_OPS = ("max", "min")


def running_ref(x: torch.Tensor, op: str, reverse: bool = False):
    """Plain version of running: torch.cummax or torch.cummin's values
    along the last dimension, through flips where reverse."""
    fn = torch.cummax if op == "max" else torch.cummin
    if reverse:
        return torch.flip(fn(torch.flip(x, [-1]), -1).values, [-1])
    return fn(x, -1).values


def running(x: torch.Tensor, op: str, reverse: bool = False):
    """The inclusive running max (op "max") or min ("min") along the last
    dimension of x, from each row's end where reverse: csrc/rowscan.cu on a
    CUDA tensor (contiguous int64, rows under 2^30 elements), running_ref
    on a CPU tensor; the same values. Counts its calls that launch the
    kernel (one or two CUDA launches each) in running.launches."""
    if op not in _OPS:
        raise ValueError(f"running scan: op {op!r} is not max or min")
    if x.device.type == "cpu":
        return running_ref(x, op, reverse)
    from . import _cuda
    dev = x.device
    _cuda.check_tensor(x, "x", torch.int64, dev)
    if x.dim() == 0 or x.shape[-1] >= 1 << 30:
        raise ValueError(f"running scan: shape {tuple(x.shape)}")
    out = torch.empty_like(x)
    N, n = x.numel(), x.shape[-1]
    if N == 0:
        return out
    tiles = -(-N // TILE)
    agg = None
    if tiles > 1 and TILE % n:
        agg = torch.empty(tiles, dtype=torch.int64, device=dev)
    fn = _cuda.entry("rowscan", "jd_rowscan", [ctypes.c_void_p] * 3
                     + [ctypes.c_longlong] + [ctypes.c_int] * 3
                     + [ctypes.c_void_p])
    with torch.cuda.device(dev):
        rc = fn(x.data_ptr(), out.data_ptr(),
                None if agg is None else agg.data_ptr(), N, n,
                int(op == "min"), int(reverse), _cuda.stream_ptr())
    _cuda.check(rc, "running scan kernel launch")
    running.launches += 1
    return out


running.launches = 0
