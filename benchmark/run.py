"""The port's benchmark: one run of one cell of BENCHMARK.json.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with an NVIDIA card. It builds
the port's kernels into the package's fixed build directories, makes the
cell's payloads (from its configuration's content seed), orders the calls
by --seed, warms the cell's shapes, measures the
closed loop for --seconds (--trace 0: the cell's end-to-end metrics) or
traces a bounded stretch (--trace 1: its per-layer metrics), judges a
seeded sample of the answers against the plain reference, and prints one
JSON line last on standard output; the numbers compared, each beside its
limit, are the last lines on standard error and the result's last key.

The process runs one OpenMP and BLAS thread (OMP_NUM_THREADS=1). It
measures jdeflate_tpu_torch alone: a run in which jax, jaxlib, flax or
the JAX package jdeflate_tpu is loaded, at the start or once the window
has closed, fails, as does one without a card. --fault plants one of
faults.py's faults under the timed path (the benchmark's own runs plant
none).
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# one host thread for OpenMP and BLAS, set before they load: with the
# default of one per core, idle workers spin beside the caller on a host
# the card's machine shares, and a run's host-bound times swing by tens of
# percent between processes
os.environ["OMP_NUM_THREADS"] = "1"

# the checkout's root, not this directory, heads the path: the benchmark is
# the package `benchmark`, and none of its modules shadows another
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT


def fail(msg: str, code: int = 1) -> None:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def no_forbidden(when: str) -> None:
    from benchmark import guard
    found = guard.offenders()
    if found:
        fail(f"{when}, the process holds modules it must not: "
             f"{', '.join(found)}")


def main() -> None:
    no_forbidden("at start")
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--fault", default=None,
                    help="plant a fault of faults.py (never in a measured run)")
    args = ap.parse_args()

    from benchmark import faults, harness, spec
    try:
        cell = spec.load_cell(args.workload)
    except spec.SpecError as e:
        fail(str(e), 2)
    if args.fault is not None and args.fault not in faults.FAULTS:
        fail(f"no fault {args.fault!r}: {sorted(faults.FAULTS)}", 2)
    try:
        import torch
        import jdeflate_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"cannot import the port: {e}", 3)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: the benchmark needs a "
             "CUDA card", 3)
    if torch.cuda.device_count() < cell.chips:
        fail(f"{cell.name} needs {cell.chips} cards, "
             f"{torch.cuda.device_count()} present", 3)
    no_forbidden("after importing the port")

    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), T0, fault=args.fault)
    no_forbidden("once the window has closed")
    for name, c in result["checks"].items():
        rel = "<=" if c["kind"] == "max" else ">="
        print(f"check {name}: {c['value']} (limit {rel} {c['limit']})",
              file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
