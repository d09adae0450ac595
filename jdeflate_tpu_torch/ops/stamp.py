"""The card's own clock inside the captured programs, and the size of a
captured graph.

stamp(t, i) writes the card's global nanosecond timer into slot i of t by
one one-thread kernel on the current stream (csrc/stamp.cu): captured into
a program it is a node of the graph, and it reads the clock when every
node before it has finished. Two stamps of one card subtract to the
device time between them. The encoder stamps its two programs and its
entropy stage this way (codec/deflate.py launch_batch, read_batch). On
the CPU there is no such clock and stamp does nothing.

graph_nodes(handle) counts the nodes of a captured graph
(cudaGraphGetNodes on torch.cuda.CUDAGraph.raw_cuda_graph()), what the
program layer adds to the counter program.nodes on every replay.
"""
from __future__ import annotations

import ctypes

import torch


def slots(n: int, dev) -> torch.Tensor:
    """A (n,) int64 tensor of stamp slots on `dev`: zeros on the CPU,
    where nothing stamps them; unset on a card, where every slot read is
    stamped first."""
    if torch.device(dev).type == "cpu":
        return torch.zeros(n, dtype=torch.int64)
    return torch.empty(n, dtype=torch.int64, device=dev)


def stamp(t: torch.Tensor | None, i: int) -> None:
    """Slot i of t, a contiguous int64 tensor on a card, gets the card's
    clock in ns once the work before it on the current stream has
    finished. Nothing where t is None or on the CPU."""
    if t is None or t.device.type != "cuda":
        return
    from . import _cuda
    _cuda.check_tensor(t, "stamps", torch.int64, t.device)
    if not 0 <= i < t.numel():
        raise IndexError(f"stamp slot {i} of {t.numel()}")
    fn = _cuda.entry("stamp", "jd_stamp", [ctypes.c_void_p] * 2)
    with torch.cuda.device(t.device):
        rc = fn(t.data_ptr() + 8 * i, _cuda.stream_ptr())
    _cuda.check(rc, "stamp kernel launch")


def graph_nodes(handle: int) -> int:
    """The nodes of the captured cudaGraph_t `handle`."""
    from . import _cuda
    fn = _cuda.entry("stamp", "jd_graph_nodes",
                     [ctypes.c_void_p, ctypes.POINTER(ctypes.c_ulonglong)])
    n = ctypes.c_ulonglong(0)
    _cuda.check(fn(handle, ctypes.byref(n)), "cudaGraphGetNodes")
    return n.value
