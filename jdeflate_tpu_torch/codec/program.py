"""Captured device programs: the port's counterpart of jax.jit for a
function of static shape.

The JAX package compiles encode_batch, the device checksums and the decode
batches into one XLA program per static shape. Here run(fn, inputs,
statics) does the same with CUDA graphs: for each (device, fn, statics, the
inputs' shapes and dtypes) the first call runs fn eagerly and returns its
result, then captures fn once into a torch.cuda.CUDAGraph over static
input buffers; every later call copies the inputs into those buffers,
replays the graph with one launch and returns clones of its outputs. The
clones matter: a replay writes its outputs into the graph's own memory, so
the next replay of the same shape would overwrite a result that a caller
still holds (the encoder launches every batch before it reads any back).

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

Memory. The programs of one device share one graph memory pool
(torch.cuda.graph_pool_handle): a capture reuses the blocks the earlier
captures freed, instead of each graph keeping a private pool of its own
peak. Sharing is safe because run() serialises every replay on the
caller's current stream under one lock, and clones every output straight
after its replay: no program's outputs are read after another program
replays, and the outputs a graph keeps are live tensors, which no other
capture is given. The cache holds at most BUDGET bytes per device: the
programs' static input buffers, and the pools their graphs live in, each
counted as its growth of torch.cuda.memory_reserved over its captures
(its graphs' outputs and working memory). Past BUDGET the least recently
used programs of that device are dropped. PyTorch frees a pool only when
no graph uses it, and then only at the next torch.cuda.empty_cache()
(torch.cuda.graph calls it as a capture starts); a live pool keeps even
its free blocks. So a pool grown past half the budget is retired (later
captures start a new one) and goes with the last of its programs, and an
eviction calls empty_cache() once. tests/test_torch_decode_program.py
holds these facts on the card.

Each device captures on a side stream of its own (capture_stream).
torch.cuda.graph's default is one stream for the whole process, made on
the device current at its first use: a capture on another card then runs
its ops on that card's streams while the first card's stream captures,
and CUDA refuses them (cudaErrorStreamCaptureUnsupported).

Tracing (trace.py). A replay's host work, the input copies, the launch
and the output clones, is the span "program.replay", inside whatever span
its caller is in (encode.launch, decode.launch, adler32); each replay adds
its graph's node count, read once at capture (cudaGraphGetNodes,
ops/stamp.py graph_nodes), to the counter "program.nodes". The graph is
captured with keep_graph=True, so that its cudaGraph_t can be read, and
instantiated at once.

Kernel launch counts stay true under replay: a wrapper counts a launch
where its Python runs, and a replay runs no Python, so the launches a
capture records for each wrapper in COUNTED are added to its count on
every replay (the capture itself launches nothing and counts nothing).
launched(wrapper) gives the launches of the calling thread's last run().
"""
from __future__ import annotations

import collections
import contextlib
import threading

import torch

from .. import trace
from ..ops import (expand, expand2, expand5, huffman, lz77, scan, stamp,
                   walk)

# kernel wrappers whose `launches` count the launches a replay makes
COUNTED = (lz77.match_probe, lz77.extend_top, lz77.match_walk,
           huffman.code_lengths, scan.running, walk.walk_checked,
           expand2.expand_tokens, expand5.seed_plane, expand5.resolve,
           expand.expand_matches)
# bytes the programs of one device may hold: static inputs and the growth
# of the pools they were captured into. The dense decode's programs hold
# gigabytes (chip_smoke.py phase 16 prints each branch's pool growth); a
# decode whose programs do not fit re-captures on every pass
BUDGET = 8 << 30

_local = threading.local()
_lock = threading.RLock()
# key -> Program, least recently used first
_programs: collections.OrderedDict = collections.OrderedDict()
_pools: dict = {}          # device -> the _Pool new captures join
_streams: dict = {}        # device -> its capture stream
# captures made, replays made, programs evicted, bytes the cache holds,
# bytes the captures added to their pools: read by the benchmark and
# chip_smoke.py. A call's captures and evictions are also trace.py counters
# of its record (program.captures, program.evictions; not its replays, a
# count per program call that program.stats already keeps); the seconds of
# a first call (its eager run and its capture) are the span
# "program.capture", those of a replay the span "program.replay", and a
# replay's graph nodes the counter "program.nodes"
stats = {"captures": 0, "replays": 0, "evictions": 0, "bytes": 0,
         "pool_growth": 0}


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


class _Pool:
    """One graph memory pool of one device and the bytes its captures
    added to the card's reserve."""

    def __init__(self):
        self.handle = torch.cuda.graph_pool_handle()
        self.nbytes = 0


def capture_stream(dev) -> torch.cuda.Stream:
    """The side stream that captures on `dev` run on, one per device."""
    stream = _streams.get(dev)
    if stream is None:
        stream = _streams[dev] = torch.cuda.Stream(device=dev)
    return stream


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


class Program:
    """fn captured at one input signature on one device: static input
    buffers, the graph, its output tensors, the kernel launches it makes
    per replay, its node count, and the bytes it holds outside its pool
    (its inputs)."""

    def __init__(self, fn, inputs: tuple, statics: tuple, pool: _Pool):
        dev = inputs[0].device
        with torch.cuda.device(dev):
            self.ins = tuple(torch.empty_like(x) for x in inputs)
            before = [w.launches for w in COUNTED]
            self.graph = torch.cuda.CUDAGraph(keep_graph=True)
            try:
                with torch.cuda.graph(self.graph, pool=pool.handle,
                                      stream=capture_stream(dev)):
                    # graph() emptied the cache as it began: the rise from
                    # here is what this capture adds to the pool
                    r0 = torch.cuda.memory_reserved(dev)
                    outs = fn(*self.ins, *statics)
                    rise = torch.cuda.memory_reserved(dev) - r0
            finally:
                self.launches = [w.launches - b
                                 for w, b in zip(COUNTED, before)]
                for w, b in zip(COUNTED, before):
                    w.launches = b
            self.nodes = stamp.graph_nodes(self.graph.raw_cuda_graph())
            self.graph.instantiate()
        if not isinstance(outs, tuple) or not all(
                isinstance(o, torch.Tensor) for o in outs):
            raise TypeError("a captured function returns a tuple of tensors")
        self.outs = outs
        self.dev = dev
        self.pool = pool
        pool.nbytes += max(rise, 0)
        stats["pool_growth"] += max(rise, 0)
        self.nbytes = _nbytes(self.ins)
        stats["captures"] += 1
        trace.count("program.captures")

    def __call__(self, inputs: tuple) -> tuple:
        with trace.span("program.replay"), torch.cuda.device(self.dev):
            for buf, x in zip(self.ins, inputs):
                buf.copy_(x)
            self.graph.replay()
            res = tuple(o.clone() for o in self.outs)
        trace.count("program.nodes", self.nodes)
        for w, n in zip(COUNTED, self.launches):
            w.launches += n
        _local.launched = dict(zip(COUNTED, self.launches))
        stats["replays"] += 1
        return res


def _note(before: list) -> None:
    """This thread's last run() launched each wrapper of COUNTED as often
    as its count rose since `before`."""
    _local.launched = {w: w.launches - b for w, b in zip(COUNTED, before)}


def launched(wrapper) -> int:
    """The launches of `wrapper` (one of COUNTED) that the calling thread's
    last run() made: those its capture recorded on a replay, those counted
    in the eager call otherwise (0 where it took a plain route)."""
    return getattr(_local, "launched", {}).get(wrapper, 0)


def _key(fn, inputs: tuple, statics: tuple):
    dev = inputs[0].device
    if any(x.device != dev for x in inputs):
        raise ValueError("a program's inputs lie on one device, got "
                         f"{sorted({str(x.device) for x in inputs})}")
    return (dev, fn, statics,
            tuple((tuple(x.shape), x.dtype) for x in inputs))


def device_bytes(dev) -> int:
    """Bytes the cached programs of `dev` hold: their static inputs, and the
    growth of every pool a cached program lives in."""
    progs = [p for p in _programs.values() if p.dev == dev]
    pools = {id(p.pool): p.pool for p in progs}
    return (sum(p.nbytes for p in progs)
            + sum(q.nbytes for q in pools.values()))


def _evict(key) -> None:
    prog = _programs.pop(key)
    if _pools.get(prog.dev) is prog.pool and not any(
            p.pool is prog.pool for p in _programs.values()):
        del _pools[prog.dev]            # dead: no capture may join it
    stats["evictions"] += 1
    trace.count("program.evictions")


def _admit(dev, key) -> list:
    """After `key` was captured on `dev`: retire the device's pool once it
    has grown past half the budget, then drop the least recently used
    programs of `dev` but `key` while they hold more than BUDGET bytes.
    Returns the keys dropped, oldest first."""
    pool = _programs[key].pool
    if pool.nbytes > BUDGET // 2 and _pools.get(dev) is pool:
        del _pools[dev]
    dropped = []
    while device_bytes(dev) > BUDGET:
        old = next((k for k, p in _programs.items()
                    if p.dev == dev and k != key), None)
        if old is None:
            break
        _evict(old)
        dropped.append(old)
    return dropped


def _update_bytes() -> None:
    stats["bytes"] = sum(device_bytes(d)
                         for d in {p.dev for p in _programs.values()})


def run(fn, inputs: tuple, statics: tuple = ()) -> tuple:
    """fn(*inputs, *statics): inputs are tensors on one device, statics
    hashable Python values that fix the shapes. On a card, one captured
    program per (device, fn, statics, input shapes and dtypes), replayed;
    on the CPU or inside eager(), fn itself."""
    if inputs[0].device.type != "cuda" or is_eager():
        before = [w.launches for w in COUNTED]
        res = fn(*inputs, *statics)
        _note(before)
        return res
    key = _key(fn, inputs, statics)
    with _lock:
        prog = _programs.get(key)
        if prog is not None:
            _programs.move_to_end(key)
            return prog(inputs)
        with trace.span("program.capture"):
            before = [w.launches for w in COUNTED]
            res = fn(*inputs, *statics)     # warms tables, kernels, attrs
            _note(before)
            dev = inputs[0].device
            pool = _pools.get(dev)
            if pool is None:
                pool = _pools[dev] = _Pool()
            try:
                _programs[key] = Program(fn, inputs, statics, pool)
            except BaseException:
                if not any(p.pool is pool for p in _programs.values()):
                    del _pools[dev]         # its graph never lived
                raise
            if _admit(dev, key):
                with torch.cuda.device(dev):
                    torch.cuda.empty_cache()
            _update_bytes()
        return res


def clear() -> None:
    """Drop every captured program (their graphs and memory)."""
    with _lock:
        _programs.clear()
        _pools.clear()
        stats["bytes"] = 0
        if torch.cuda.is_initialized():
            torch.cuda.empty_cache()
