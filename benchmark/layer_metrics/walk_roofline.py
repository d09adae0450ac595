"""B1, csrc/walk.cu (ops/walk.py::walk_checked): share of its roofline.

Least bytes of one launch: a word of the stream per active lane, each
lane's start, three words per pseudo-entry, the history length and the four
tree tables read once; the tokens produced (not the 32 slots of every
lane), and each lane's meta, length and 64-bit offset, and the err word,
written once."""
from benchmark import rooflines

KERNEL = {"wrapper": ("jdeflate_tpu_torch.ops.walk", "walk_checked"),
          "pattern": r"(?<![A-Za-z0-9_])walk_kernel\b"}


def bytes_needed(args, result) -> int:
    seg_word0, start_rel, t1 = args[1], args[3], args[4]
    tok = result[0]
    lanes = start_rel.numel()
    active = int((start_rel >= 0).sum())
    tokens = int((tok != 0).sum())
    return (4 * active + 4 * lanes + 12 * seg_word0.numel() + 4
            + 4 * 4 * t1.shape[0] * t1.shape[1]
            + 4 * tokens + lanes * (4 + 4 + 8) + 4)


KERNEL["bytes"] = bytes_needed


def read(trace):
    return rooflines.share(trace, "walk_roofline", KERNEL["pattern"])
