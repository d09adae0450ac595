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
"""
from __future__ import annotations

import torch

from ..utils import device as _device
from ..utils import errors

DP_AXIS = "dp"


def make_mesh(n_devices: int | None = None,
              device="cuda") -> tuple[torch.device, ...]:
    """1-D data-parallel mesh: the first n (default: all) CUDA devices, or
    with device="cpu" n virtual ranks on the CPU (n is then required). A
    CUDA mesh never moves to the CPU: fewer cards than n is an error."""
    kind = _device.resolve(device).type
    if kind == "cpu":
        if n_devices is None or n_devices < 1:
            raise errors.IncorrectUseError(
                "a CPU mesh needs n_devices >= 1 virtual ranks")
        return (torch.device("cpu"),) * n_devices
    have = torch.cuda.device_count()
    n = have if n_devices is None else n_devices
    if n < 1 or n > have:
        raise errors.IncorrectUseError(
            f"a mesh of {n} CUDA devices requested, {have} present")
    return tuple(torch.device("cuda", k) for k in range(n))
