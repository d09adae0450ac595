"""Time a stage by cycling distinct input sets (the port of
scripts/devtime.py::measure_cycled).

The JAX harness cycled genuinely different inputs inside one compiled loop
so that XLA could not hoist the stage and one readback bounded the work.
PyTorch runs eagerly, so the contract is kept with plain calls: at least
two input sets of one shape, called in turn after one warm call. Two times
come back per call: CUDA events around the run of calls (the stage's span
on the card, launch gaps included) and the stage's kernels' own device time
from torch.profiler. On the CPU the first is the host clock around the
calls and the second is None: there is no device.
"""
from __future__ import annotations

import time

import torch


def _tensors(inputs) -> list:
    return [x for x in inputs if isinstance(x, torch.Tensor)]


def _check_sets(input_sets) -> torch.device:
    """Raise unless there are at least two input sets whose tensors have
    one shape; returns their device."""
    if len(input_sets) < 2:
        raise ValueError("measure_cycled needs at least two input sets")
    shapes = [[tuple(t.shape) for t in _tensors(s)] for s in input_sets]
    if any(s != shapes[0] for s in shapes[1:]):
        raise ValueError(f"input sets differ in shape: {shapes}")
    ts = _tensors(input_sets[0])
    return ts[0].device if ts else torch.device("cpu")


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def measure_cycled(input_sets, stage, iters: int = 4) -> float:
    """Seconds per call of stage(*inputs), inputs cycling over input_sets
    (at least two tuples whose tensors have one shape), after one warm
    call: CUDA events around iters calls on the card, the host clock to a
    synchronise on the CPU."""
    dev = _check_sets(input_sets)
    stage(*input_sets[0])
    sync(dev)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for k in range(iters):
            stage(*input_sets[k % len(input_sets)])
        return (time.perf_counter() - t0) / iters
    with torch.cuda.device(dev):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for k in range(iters):
            stage(*input_sets[k % len(input_sets)])
        b.record()
        torch.cuda.synchronize(dev)
    return a.elapsed_time(b) / 1e3 / iters


def device_cycled(input_sets, stage, iters: int = 4):
    """Device seconds per call of the kernels stage(*inputs) launches
    (torch.profiler, device events only), over iters cycled calls after one
    warm call. None on the CPU, or where the profiler sees no device
    time."""
    from torch.profiler import ProfilerActivity, profile
    dev = _check_sets(input_sets)
    if dev.type != "cuda":
        return None
    stage(*input_sets[0])
    sync(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for k in range(iters):
            stage(*input_sets[k % len(input_sets)])
        sync(dev)
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / 1e6 / iters if us > 0 else None


def measure(input_sets, stage, iters: int = 4) -> dict:
    """{"ms": span per call, "dev_ms": the kernels' device time per call
    (None on the CPU)} of stage over the cycled input sets."""
    s = measure_cycled(input_sets, stage, iters)
    d = device_cycled(input_sets, stage, iters)
    return {"ms": s * 1e3, "dev_ms": None if d is None else d * 1e3}
