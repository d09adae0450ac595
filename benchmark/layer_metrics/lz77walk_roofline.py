"""B3, csrc/lz77walk.cu (ops/lz77.py::match_walk): share of its roofline.

Least bytes of one launch: the parse visits, in each block, every literal
position and every emitted match's start; at each it needs the candidate
word, and at a match also its length; plus each block's length read once.
It writes each block's count and its emitted matches once (not the
list's capacity)."""
import torch

from benchmark import rooflines

KERNEL = {"wrapper": ("jdeflate_tpu_torch.ops.lz77", "match_walk"),
          "pattern": r"match_walk_kernel"}


def bytes_needed(args, result) -> int:
    block_len = args[2]
    plist = result.to(torch.int64)
    count = plist[:, 0] - 1                         # matches per block
    slot = torch.arange(plist.shape[1], device=plist.device)[None, :]
    live = (slot >= 1) & (slot <= count[:, None])
    covered = torch.where(live, plist >> 17, 0).sum()
    matches = int(count.sum())
    literals = int(block_len.to(torch.int64).sum() - covered)
    visits = literals + matches
    blocks = block_len.numel()
    return 4 * visits + 4 * matches + 4 * blocks + 4 * (matches + blocks)


KERNEL["bytes"] = bytes_needed


def read(trace):
    return rooflines.share(trace, "lz77walk_roofline", KERNEL["pattern"])
