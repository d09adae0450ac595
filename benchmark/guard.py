"""What a run of the benchmark must not have loaded: JAX, and the JAX
package that the port was made from. Names are compared by their top-level
part (before the first dot) whole, since the port's own name,
jdeflate_tpu_torch, begins with the JAX package's."""
from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "jdeflate_tpu")
# the old harness and its helpers, which the benchmark neither imports nor
# reads (full dotted names, or top-level names)
OLD_HARNESS = ("bench", "chip_smoke", "scripts", "jdeflate_tpu_torch.bench")


def loaded(names=FORBIDDEN, modules=None) -> list:
    """The modules of `modules` (sys.modules by default) whose top-level
    name is one of `names`, or whose full name is one of the dotted
    `names` or lies under one."""
    mods = sys.modules if modules is None else modules
    tops = {n for n in names if "." not in n}
    dotted = tuple(n for n in names if "." in n)
    return sorted(m for m in mods
                  if m.split(".", 1)[0] in tops
                  or any(m == d or m.startswith(d + ".") for d in dotted))


def offenders(modules=None) -> list:
    return loaded(FORBIDDEN + OLD_HARNESS, modules)
