"""B2, csrc/expand.cu + tile_resolve.cuh (ops/expand2.py::expand_tokens,
the place kernel and the resolve with front end TokenFront): share of its
roofline.

Least bytes of one launch: the tokens produced and each lane's 64-bit
offset read once, the bytes produced written once. The history is left out:
only the part that matches reach is needed, which the inputs do not say."""
from benchmark import rooflines

KERNEL = {"wrapper": ("jdeflate_tpu_torch.ops.expand2", "expand_tokens"),
          "pattern": r"expand_place_kernel|tile_resolve_kernel<TokenFront>"}


def bytes_needed(args, result) -> int:
    tok, outlen, out_cap = args[0], args[1], args[3]
    tokens = int((tok != 0).sum())
    produced = min(int(result[1]), int(out_cap))
    return 4 * tokens + 8 * outlen.numel() + produced


KERNEL["bytes"] = bytes_needed


def read(trace):
    return rooflines.share(trace, "expand_roofline", KERNEL["pattern"])
