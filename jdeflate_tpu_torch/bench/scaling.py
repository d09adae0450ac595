"""The sharded-members row (the port of scripts/scaling_probe.py):
ShardedDeflater in members mode over 1, 2, 4 and 8 ranks, the same eight
16 KiB blocks of work per round split over the ranks.

Ranks go round-robin over the visible cards (rank k on cuda:k % count);
ranks that share a card time-slice it, so every wall carries its layout:
the cards used and the most ranks on one card. On the CPU every rank is
the CPU. The multi-member gzip of the widest mesh must inflate in zlib and
through decompress_members. The collective volumes are the byte counts
this run's member lengths give. The JAX probe's strong-scaling model is
left out: it rests on assumed TPU interconnect rates, not this card's.
"""
from __future__ import annotations

import gzip
import time

import torch

from ..parallel.shard import ShardedDeflater, decompress_members
from ..utils import device as _device

LEVEL = 6
BLOCK = 1 << 14
BLOCKS_PER_ROUND = 8


def mesh_of(d: int, dev: torch.device) -> tuple:
    """d ranks: round-robin over the visible cards, or all on the CPU."""
    if dev.type == "cpu":
        return (dev,) * d
    cards = torch.cuda.device_count()
    return tuple(torch.device("cuda", k % cards) for k in range(d))


def _sync(mesh) -> None:
    for dv in set(mesh):
        if dv.type == "cuda":
            torch.cuda.synchronize(dv)


def probe(data: bytes, device="cuda", ranks=(1, 2, 4, 8)) -> dict:
    dev = _device.resolve(device)
    out = {"total_bytes": len(data), "level": LEVEL, "block_size": BLOCK,
           "cards_visible": (torch.cuda.device_count() if dev.type == "cuda"
                             else 0)}
    walls = {}
    meas = None
    for d in ranks:
        mesh = mesh_of(d, dev)
        enc = ShardedDeflater(mesh=mesh, level=LEVEL, block_size=BLOCK,
                              blocks_per_device=max(BLOCKS_PER_ROUND // d, 1),
                              mode="members")
        enc.compress(data)                      # warm
        _sync(mesh)
        t0 = time.perf_counter()
        blob, info = enc.compress(data)
        _sync(mesh)
        per_card = max(mesh.count(x) for x in set(mesh))
        walls[str(d)] = {"wall_s": time.perf_counter() - t0,
                         "cards": len(set(mesh)) if dev.type == "cuda" else 0,
                         "ranks_per_card": per_card if dev.type == "cuda"
                         else 0}
        meas = (d, [m[1] for m in info["members"]], blob, info)
    d, lens, blob, info = meas
    out["members_gzip_ok"] = gzip.decompress(blob) == data
    out["members_device_decode_ok"] = decompress_members(
        blob, info, device=dev) == data
    out["n_members"] = len(info["members"])
    out["wall_s_by_ranks"] = walls

    # the bytes each collective would move, from this run's member lengths
    cap = max(lens)
    host_collect = sum(lens)
    padded = d * d * cap
    out["collectives_measured"] = {
        "n_shards": d,
        "member_lengths": lens,
        "lengths_allgather_bytes": 4 * d * d,
        "member_gather_host_collect_bytes": host_collect,
        "member_gather_padded_allgather_bytes": padded,
        "decision": ("host_collect: moves %dx fewer bytes on this run and "
                     "only the host needs the members for output assembly"
                     % max(padded // max(host_collect, 1), 1)),
    }
    return out
