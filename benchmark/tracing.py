"""Tracing for the --trace 1 run, done from the benchmark's own files.

- Host spans: the port's layer boundaries wrapped for the traced stretch,
  each call's seconds summed by name and marked in the profile with
  torch.profiler.record_function, so the device's idle gaps can be named by
  what the host was doing. The spans are declared where they are used: an
  operation's SPANS (operations/<op>.py) and a per-layer reader's SPANS,
  each (module, attribute, name) or (module, attribute, name, keep), where
  keep(args, result) makes a value kept in trace.kept[name] for each call;
  merge() joins them.
- Counters: the port's program.stats and each roofline kernel's launch
  count, read before and after the stretch; each RawInflater.decompress's
  last_stats.
- The device timeline: torch.profiler's events, reduced to the busy time
  (the union of kernels, copies and sets), the time per kernel and the
  breakdown of the result line.
- The counting pass: the stretch's calls once more, op by op
  (program.eager()), with each roofline's kernel wrapper wrapped to count
  the bytes that call's inputs need.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import heapq
import importlib
import re
import time

STRETCH = "benchmark.stretch"
TOP = 10


def _owner(module: str, attr: str):
    """(object holding the last part of attr, that part's name)."""
    obj = importlib.import_module(module)
    *path, name = attr.split(".")
    for p in path:
        obj = getattr(obj, p)
    return obj, name


@contextlib.contextmanager
def wrapped(module: str, attr: str, after):
    """Within the block, each call of module.attr runs through the original
    and then after(args, result, seconds)."""
    owner, name = _owner(module, attr)
    orig = owner.__dict__[name] if isinstance(owner, type) else getattr(
        owner, name)

    def call(*a, **k):
        t0 = time.perf_counter()
        r = orig(*a, **k)
        after(a, r, time.perf_counter() - t0)
        return r

    # a kernel wrapper counts its launches on the function its module's
    # name holds (ops/walk.py: walk_checked.launches += 1)
    counts = hasattr(orig, "launches")
    if counts:
        call.launches = orig.launches
    setattr(owner, name, call)
    try:
        yield
    finally:
        setattr(owner, name, orig)
        if counts:
            orig.launches = call.launches


@dataclasses.dataclass
class Trace:
    """What the per-layer readers read (layer_metrics/*.py)."""
    cell: str
    requests: int = 0
    decoded: int = 0
    encoded: int = 0
    spans: dict = dataclasses.field(default_factory=dict)      # name -> s
    span_calls: dict = dataclasses.field(default_factory=dict)
    stats: dict = dataclasses.field(default_factory=dict)      # delta
    launches: dict = dataclasses.field(default_factory=dict)   # delta
    kept: dict = dataclasses.field(default_factory=dict)       # name -> []
    kernel_ns: dict = dataclasses.field(default_factory=dict)  # name -> ns
    busy_s: float | None = None
    window_s: float | None = None
    kernel_bytes: dict = dataclasses.field(default_factory=dict)
    kernel_calls: dict = dataclasses.field(default_factory=dict)
    breakdown: dict | None = None

    def kernel_seconds(self, pattern: str) -> float:
        rx = re.compile(pattern)
        return sum(ns for k, ns in self.kernel_ns.items()
                   if rx.search(k)) / 1e9


def merge(*groups) -> tuple:
    """The spans of several declarations, each function wrapped once: as
    (module, attribute, name, [keep, ...]). A function declared under two
    names is an error."""
    by: dict = {}
    for group in groups:
        for module, attr, name, *keep in group:
            got = by.setdefault((module, attr), (name, []))
            if got[0] != name:
                raise ValueError(f"{module}.{attr} is span {got[0]!r} and "
                                 f"{name!r}")
            got[1].extend(k for k in keep if k not in got[1])
    return tuple((m, a, name, keeps) for (m, a), (name, keeps) in by.items())


@contextlib.contextmanager
def host_spans(trace: Trace, spans):
    """Within the block, every span of `spans` (merge()'s) sums its seconds
    into trace, marks the profile and keeps what its keep functions make."""
    import torch
    secs = collections.defaultdict(float)
    calls = collections.defaultdict(int)
    with contextlib.ExitStack() as stack:
        for module, attr, name, keeps in spans:
            owner, part = _owner(module, attr)
            orig = (owner.__dict__[part] if isinstance(owner, type)
                    else getattr(owner, part))

            def call(*a, _orig=orig, _name=name, _keeps=keeps, **k):
                t0 = time.perf_counter()
                with torch.profiler.record_function(_name):
                    r = _orig(*a, **k)
                secs[_name] += time.perf_counter() - t0
                calls[_name] += 1
                for keep in _keeps:
                    trace.kept.setdefault(_name, []).append(keep(a, r))
                return r

            setattr(owner, part, call)
            stack.callback(setattr, owner, part, orig)
        yield
    trace.spans = dict(secs)
    trace.span_calls = dict(calls)


# ---- the device timeline

def union(intervals) -> list:
    """Sorted, merged (start, end) intervals."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def clip(intervals, lo, hi) -> list:
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if min(e, hi) > max(s, lo)]


def gaps(merged, lo, hi) -> list:
    """The idle intervals of [lo, hi] between merged busy intervals."""
    out, cur = [], lo
    for s, e in merged:
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if hi > cur:
        out.append((cur, hi))
    return out


def innermost_segments(annotations):
    """(edges, names): the sorted times where a host span starts or ends,
    and for each stretch between two neighbouring edges the innermost
    (shortest) span holding it, by one sweep."""
    edges = sorted({t for _, s, e in annotations for t in (s, e)})
    starts = sorted((s, e - s, name, e) for name, s, e in annotations)
    active: list = []                   # heap of (length, end, name)
    names, j = [], 0
    for a in edges[:-1]:
        while j < len(starts) and starts[j][0] <= a:
            s, n, name, e = starts[j]
            heapq.heappush(active, (n, e, name))
            j += 1
        while active and active[0][1] <= a:
            heapq.heappop(active)
        # after the pops the top is live, and no live span is shorter
        names.append(active[0][2] if active else "between calls")
    return edges, names


def short(name: str, n: int = 96) -> str:
    return name if len(name) <= n else name[:n - 3] + "..."


def reduce_timeline(device, annotations, lo, hi) -> dict:
    """device: (name, start, end) of every device operation; annotations:
    (name, start, end) of the host spans; [lo, hi]: the traced window, all
    in ns of one clock. Returns busy_s, window_s, kernel_ns and the
    breakdown (top device operations by time, idle time by host span)."""
    dev = clip([(s, e) for _, s, e in device], lo, hi)
    merged = union(dev)
    busy = sum(e - s for s, e in merged)
    kernel_ns: dict = collections.defaultdict(int)
    for name, s, e in device:
        kernel_ns[name] += e - s
    idle: dict = collections.defaultdict(int)
    edges, names = innermost_segments(
        [a for a in annotations if a[0] != STRETCH])
    for s, e in gaps(merged, lo, hi):
        # the gap split where a host span starts or ends inside it
        k = bisect.bisect_right(edges, s) - 1
        cur = s
        while cur < e:
            nxt = edges[k + 1] if k + 1 < len(edges) else e
            end = min(nxt, e)
            name = names[k] if 0 <= k < len(names) else "between calls"
            idle[name] += end - cur
            cur = end
            k += 1
    top = sorted(kernel_ns.items(), key=lambda kv: -kv[1])[:TOP]
    top_idle = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": busy / 1e9, "window_s": (hi - lo) / 1e9,
            "kernel_ns": dict(kernel_ns),
            "breakdown": {
                "device_ops": [[short(k), v / 1e9] for k, v in top],
                "idle_gaps": [[k, v / 1e9] for k, v in top_idle]}}


def profiler_events(prof, spans):
    """(device operations, host spans) of a finished torch.profiler profile,
    as (name, start_ns, end_ns). The profiler mirrors each host span on the
    device's timeline as an annotation; those are left out by name."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    names = {STRETCH} | {span[2] for span in spans}
    device, notes = [], []
    for e in prof.profiler.kineto_results.events():
        name, start = e.name(), e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == cuda:
            if name not in names:
                device.append((name, start, end))
        elif name in names:
            notes.append((name, start, end))
    return device, notes


@contextlib.contextmanager
def profiled(trace: Trace, spans):
    """Profile the block (host spans and device operations) and reduce its
    timeline into trace. Without a device the timeline stays unread."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(STRETCH):
            yield
            if cuda:
                torch.cuda.synchronize()
    if not cuda:
        return
    device, notes = profiler_events(prof, spans)
    window = [(s, e) for n, s, e in notes if n == STRETCH]
    if not window:
        return
    got = reduce_timeline(device, notes, *window[0])
    trace.busy_s = got["busy_s"]
    trace.window_s = got["window_s"]
    trace.kernel_ns = got["kernel_ns"]
    trace.breakdown = got["breakdown"]


# ---- counters

def program_stats() -> dict:
    from jdeflate_tpu_torch.codec import program
    return dict(program.stats)


def delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after
            if isinstance(after[k], (int, float))}


def launches(kernels: dict) -> dict:
    """Launch count of each roofline kernel's wrapper (its `launches`)."""
    out = {}
    for key, spec in kernels.items():
        owner, name = _owner(*spec["wrapper"])
        n = getattr(getattr(owner, name), "launches", None)
        if n is not None:
            out[key] = n
    return out


@contextlib.contextmanager
def counting(trace: Trace, kernels: dict):
    """Within the block, each call of a roofline kernel's wrapper adds the
    bytes its inputs need (spec["bytes"](args, result)) and one call."""
    with contextlib.ExitStack() as stack:
        for key, spec in kernels.items():
            trace.kernel_bytes[key] = 0
            trace.kernel_calls[key] = 0

            def after(a, r, sec, _key=key, _fn=spec["bytes"]):
                trace.kernel_bytes[_key] += int(_fn(a, r))
                trace.kernel_calls[_key] += 1

            stack.enter_context(wrapped(*spec["wrapper"], after))
        yield
