"""Captured device programs: the port's counterpart of jax.jit for a
function of static shape.

The JAX package compiles encode_batch and the device checksums into one XLA
program per static shape. Here run(fn, inputs, statics) does the same with
CUDA graphs: for each (device, fn, statics, the inputs' shapes and dtypes)
the first call runs fn eagerly and returns its result, then captures fn
once into a torch.cuda.CUDAGraph over static input buffers; every later
call copies the inputs into those buffers, replays the graph with one
launch and returns clones of its outputs. The clones matter: a replay
writes its outputs into the graph's own memory, so the next replay of the
same shape would overwrite a result that a caller still holds (the
encoder launches every batch before it reads any back).

So a captured function must make no host read and no upload: every value
that changes between calls is one of its input tensors (a per-batch scalar
is a 0-d tensor, not a Python int), every constant table is resident on the
device before the capture, and its loops have a trip count fixed by the
statics. Its outputs are a tuple of tensors.

On the CPU, and inside eager() on any device, run() calls fn directly: the
CPU is the path the caller asked for, and eager() is the counterpart of
jax.disable_jit that the tests and chip_smoke.py hold the captured programs
to. On a card a capture or replay that fails raises; nothing falls back to
the eager path.

Kernel launch counts stay true under replay: a wrapper counts a launch
where its Python runs, and a replay runs no Python, so the launches a
capture records for each wrapper in COUNTED are added to its count on
every replay (the capture itself launches nothing and counts nothing).
"""
from __future__ import annotations

import contextlib
import threading
import time

import torch

from ..ops import lz77

# kernel wrappers whose `launches` count the launches a replay makes
COUNTED = (lz77.match_walk,)

_local = threading.local()
_programs: dict = {}
# captures made and the seconds they took (the first call's eager run
# excluded), replays made: read by chip_smoke.py
stats = {"captures": 0, "capture_s": 0.0, "replays": 0}


@contextlib.contextmanager
def eager():
    """Within the block, run() calls its function eagerly on every device
    (jax.disable_jit's counterpart)."""
    prev = getattr(_local, "eager", False)
    _local.eager = True
    try:
        yield
    finally:
        _local.eager = prev


def is_eager() -> bool:
    return getattr(_local, "eager", False)


class Program:
    """fn captured at one input signature on one device: static input
    buffers, the graph, its output tensors and the kernel launches it
    makes per replay."""

    def __init__(self, fn, inputs: tuple, statics: tuple):
        dev = inputs[0].device
        t0 = time.perf_counter()
        with torch.cuda.device(dev):
            self.ins = tuple(torch.empty_like(x) for x in inputs)
            before = [w.launches for w in COUNTED]
            self.graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(self.graph):
                    outs = fn(*self.ins, *statics)
            finally:
                self.launches = [w.launches - b
                                 for w, b in zip(COUNTED, before)]
                for w, b in zip(COUNTED, before):
                    w.launches = b
        if not isinstance(outs, tuple) or not all(
                isinstance(o, torch.Tensor) for o in outs):
            raise TypeError("a captured function returns a tuple of tensors")
        self.outs = outs
        stats["captures"] += 1
        stats["capture_s"] += time.perf_counter() - t0

    def __call__(self, inputs: tuple) -> tuple:
        with torch.cuda.device(self.ins[0].device):
            for buf, x in zip(self.ins, inputs):
                buf.copy_(x)
            self.graph.replay()
            res = tuple(o.clone() for o in self.outs)
        for w, n in zip(COUNTED, self.launches):
            w.launches += n
        stats["replays"] += 1
        return res


def _key(fn, inputs: tuple, statics: tuple):
    dev = inputs[0].device
    if any(x.device != dev for x in inputs):
        raise ValueError("a program's inputs lie on one device, got "
                         f"{sorted({str(x.device) for x in inputs})}")
    return (dev, fn, statics,
            tuple((tuple(x.shape), x.dtype) for x in inputs))


def run(fn, inputs: tuple, statics: tuple = ()) -> tuple:
    """fn(*inputs, *statics): inputs are tensors on one device, statics
    hashable Python values that fix the shapes. On a card, one captured
    program per (device, fn, statics, input shapes and dtypes), replayed;
    on the CPU or inside eager(), fn itself."""
    if inputs[0].device.type != "cuda" or is_eager():
        return fn(*inputs, *statics)
    key = _key(fn, inputs, statics)
    prog = _programs.get(key)
    if prog is None:
        res = fn(*inputs, *statics)     # warms the tables, kernels, attrs
        _programs[key] = Program(fn, inputs, statics)
        return res
    return prog(inputs)


def clear() -> None:
    """Drop every captured program (their graphs and memory)."""
    _programs.clear()
