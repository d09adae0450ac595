"""Device meshes for data-parallel compression.

The reference is single-threaded (SURVEY.md §2.5); data parallelism is new
design. DEFLATE's 32 KiB window bound makes input sharding legal, and gzip
member concatenation (RFC 1952) and sync-flush seams (RFC 1951) make the
shards' outputs recompose bit-exactly.

A mesh here is a tuple of torch.device, one per rank of the 1-D 'dp' axis:
rank k encodes shard k of each round on mesh[k]. A device may repeat (four
ranks on cuda:0 run one after another on one card). The JAX package's
dp_sharding and replicated return XLA NamedSharding objects that place an
array over its mesh; a tuple of devices has no such placement object, so
they have no counterpart here: each rank's tensors are put on its device
where they are made.

Several processes: where the JAX caller runs jax.distributed.initialize()
before make_mesh(), which then lists every process's devices, the caller
here runs torch.distributed.init_process_group and passes its group. Each
process then holds a ProcessMesh: its own ranks' devices and its place in
the global mesh, which is every process's ranks in process-rank order (the
order in which jax.devices() lists devices across processes).

Teardown of a gloo group. Its threads (the run loops, pt_gloo_runloop,
and the transport's event loop, gloo_tcp_loop) end only with the group's
last reference: destroy_process_group() drops torch.distributed's own
reference but stops neither while a ProcessMesh or a ShardedDeflater
still holds the group. A group that lives into interpreter finalization
can abort the process ("terminate called without an active exception"):
a run loop that releases a finished collective's tensor then waits for
the GIL, Python ends it with pthread_exit, and that unwind through a
noexcept frame calls std::terminate. So each process tears down in this
order: drop every mesh and deflater of the group (keep them local to a
function that returns), call destroy_process_group(), then exit. The
group then ends inside destroy_process_group(), its threads joined.
Nothing of this package keeps a group past the meshes and deflaters
that hold it, a raising compress included (ROADMAP C15).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..utils import device as _device
from ..utils import errors

DP_AXIS = "dp"


@dataclasses.dataclass(frozen=True)
class ProcessMesh:
    """This process's part of a mesh that spans the processes of a
    torch.distributed group: `local` holds its ranks' devices, which are
    global ranks first .. first + len(local) - 1 of `size`. With group None
    the mesh is all in this process (first 0, size len(local))."""
    local: tuple
    group: object
    first: int
    size: int


def spanning(local, group=None) -> ProcessMesh:
    """The ProcessMesh of this process's ranks `local` (devices) over
    `group`: one all_gather_object of every process's rank count, so every
    process of the group must call it."""
    local = tuple(_device.resolve(d) for d in local)
    if group is None:
        return ProcessMesh(local, None, 0, len(local))
    counts = [None] * dist.get_world_size(group)
    dist.all_gather_object(counts, len(local), group=group)
    return ProcessMesh(local, group, sum(counts[:dist.get_rank(group)]),
                       sum(counts))


def make_mesh(n_devices: int | None = None, device="cuda", group=None):
    """1-D data-parallel mesh: the first n (default: all) CUDA devices, or
    with device="cpu" n virtual ranks on the CPU (n is then required). A
    CUDA mesh never moves to the CPU: fewer cards than n is an error.

    With a torch.distributed `group`, a ProcessMesh of this process's ranks
    (every process of the group must call it): n virtual CPU ranks, or n
    cards (default 1), cuda:{(group rank * n + j) % device_count} for the
    j-th, so one process per card by default."""
    kind = _device.resolve(device).type
    if kind == "cpu":
        if n_devices is None or n_devices < 1:
            raise errors.IncorrectUseError(
                "a CPU mesh needs n_devices >= 1 virtual ranks")
        local = (torch.device("cpu"),) * n_devices
        return local if group is None else spanning(local, group)
    have = torch.cuda.device_count()
    n = (have if group is None else 1) if n_devices is None else n_devices
    if n < 1 or n > have:
        raise errors.IncorrectUseError(
            f"a mesh of {n} CUDA devices requested, {have} present")
    if group is None:
        return tuple(torch.device("cuda", k) for k in range(n))
    r = dist.get_rank(group)
    return spanning([torch.device("cuda", (r * n + j) % have)
                     for j in range(n)], group)
