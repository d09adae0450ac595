"""One run of one cell: build, make the payloads, warm the
cell's shapes, then either measure the closed loop for `seconds` (--trace 0,
the end-to-end metrics) or trace a bounded stretch (--trace 1, the
per-layer metrics); once the window has closed, send the fresh payload of
the run's seed through the same call, and judge it with a seeded sample of
the answers against the reference."""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import resource
import statistics
import subprocess
import sys
import time

from . import corpus, faults, generator, spec, tracing

# payload indexes the sample and the checks draw from: no payload has them
_SAMPLE_STREAM = 1 << 41
_CHECK_STREAM = 1 << 42


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Window:
    seconds: float
    records: list
    setup_s: float


class Sampler:
    """Keeps a seeded sample of the answers: `per_payload` answers of each
    payload and `sample` answers of all, by reservoir sampling, and
    `per_pass` answers of each pass of the cyclic order over the payloads,
    so that every pass is judged. An answer kept by two rules counts once.
    """

    def __init__(self, rule: dict, seed: int, n_payloads: int):
        self.rule = rule
        self.n = n_payloads
        self.rng = corpus.rng_for(seed, _SAMPLE_STREAM)
        self.calls = 0
        self.pools: dict = {}       # reservoir -> [(call, payload, answer)]
        self.seen: collections.Counter = collections.Counter()
        self.picks: set = set()     # the calls of this pass to keep
        self.picked: dict = {}      # call -> (payload, answer)

    def offer(self, i: int, answer) -> None:
        c = self.calls
        self.calls += 1
        k = self.rule.get("per_pass")
        if k:
            if c % self.n == 0:
                self.picks = {c + int(j) for j in self.rng.choice(
                    self.n, min(k, self.n), replace=False)}
            if c in self.picks:
                self.picked[c] = (i, answer)
        for key, size in ((("payload", i), self.rule.get("per_payload")),
                          (("all",), self.rule.get("sample"))):
            if not size:
                continue
            self.seen[key] += 1
            slot = generator.sample_keep(self.seen[key], self.rng, size)
            if slot is None:
                continue
            pool = self.pools.setdefault(key, [])
            if slot == len(pool):
                pool.append((c, i, answer))
            else:
                pool[slot] = (c, i, answer)

    def answers(self) -> list:
        got = dict(self.picked)
        for pool in self.pools.values():
            for c, i, answer in pool:
                got[c] = (i, answer)
        return [got[c] for c in sorted(got)]


def build(device) -> None:
    """Every kernel of the port into its fixed build directory
    (jdeflate_tpu_torch/_build/), and the native library
    (native/build/): only the first run in a checkout compiles."""
    from jdeflate_tpu_torch.stream import native
    if device == "cuda":
        from jdeflate_tpu_torch.ops import _cuda
        t0 = time.perf_counter()
        names = sorted(f[:-3] for f in os.listdir(_cuda.CSRC)
                       if f.endswith(".cu"))
        built = _cuda.build(names)
        log(f"kernels: {len(built)} of {len(names)} compiled in "
            f"{time.perf_counter() - t0:.1f} s")
    if not native.available():
        raise RuntimeError("the native library did not build (needs g++)")


def _call(op, i: int, sampler: Sampler) -> generator.Record:
    t0 = time.perf_counter()
    try:
        answer, fields = op.call(i)
    except Exception as e:              # a failed call is counted, not fatal
        return generator.Record(i, time.perf_counter() - t0,
                                error=repr(e)[:300])
    rec = generator.Record(i, time.perf_counter() - t0, **fields)
    sampler.offer(i, answer)
    return rec


def measure(op, order: list, seconds: float, sampler: Sampler,
            t0: float) -> Window:
    """Closed loop, one caller: whole calls in the cyclic order until the
    window's time is up."""
    start = time.perf_counter()
    deadline = start + seconds
    records = []
    while True:
        records.append(_call(op, order[len(records) % len(order)], sampler))
        if time.perf_counter() >= deadline:
            break
    return Window(time.perf_counter() - start, records, start - t0)


def stretch_calls(op, order: list, rule: dict) -> list:
    """The traced stretch: the first `calls` calls of the cyclic order among
    payloads of at most `max_bytes`."""
    fits = [i for i in order
            if len(op.payloads[i]) <= rule.get("max_bytes", float("inf"))]
    return [fits[k % len(fits)] for k in range(rule["calls"])]


def traced(cell, op, op_spans, order, sampler, readers, t0):
    trace = tracing.Trace(cell.name)
    calls = stretch_calls(op, order, cell.traffic["trace"])
    kernels = {name: mod.KERNEL for name, mod in readers.items()
               if hasattr(mod, "KERNEL")}
    spans = tracing.merge(op_spans, *(getattr(mod, "SPANS", ())
                                      for mod in readers.values()))
    s0, l0 = tracing.program_stats(), tracing.launches(kernels)
    start = time.perf_counter()
    records = []
    with tracing.host_spans(trace, spans), tracing.profiled(trace, spans):
        for i in calls:
            records.append(_call(op, i, sampler))
    window = Window(time.perf_counter() - start, records, start - t0)
    trace.stats = tracing.delta(s0, tracing.program_stats())
    trace.launches = tracing.delta(l0, tracing.launches(kernels))
    trace.requests = len(records)
    trace.decoded = sum(r.decoded for r in records)
    trace.encoded = sum(r.encoded for r in records)
    return window, trace, calls, kernels


def count_bytes(op, trace, calls, kernels) -> None:
    """The stretch's calls again, op by op, counting the bytes each
    roofline kernel's inputs need."""
    from jdeflate_tpu_torch.codec import program
    with program.eager(), tracing.counting(trace, kernels):
        for i in calls:
            op.call(i)


def power_limit() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unread ({e})"
    return r.stdout.strip().splitlines()[0] if r.stdout.strip() else "unread"


def fresh_call(cell, op, seed: int) -> tuple:
    """The fresh payload of the run's seed through the timed call: ([(its
    index, its answer)], or [] where the call failed; failures)."""
    try:
        i = op.add(generator.fresh_payload(cell.config, cell.traffic, seed))
        answer, _ = op.call(i)
    except Exception as e:
        log(f"the fresh payload's call failed: {e!r}"[:400])
        return [], 1
    log(f"fresh payload of the seed: {len(op.payloads[i])} bytes")
    return [(i, answer)], 0


def judge(op, answers: list, failed: int, seed: int) -> tuple:
    """(The numbers compared, each {"value", "limit", "kind"}: at most the
    limit ("max") or at least ("min"); the sampled index entries that show
    C7, which are not compared)."""
    rng = corpus.rng_for(seed, _CHECK_STREAM)
    tot: collections.Counter = collections.Counter()
    notes = []
    for got in [op.check_setup(rng)] + [op.check(i, a, rng)
                                         for i, a in answers]:
        notes += got.pop("notes", [])
        tot.update(got)
    for line in notes[:5]:
        log(f"index fault: {line}")
    numbers = {"calls_failed": failed}
    for k in ("bytes_differing", "streams_rejected", "index_faults"):
        numbers[k] = tot.get(k, 0)
    out = {k: {"value": v, "limit": 0, "kind": "max"}
           for k, v in numbers.items()}
    out["answers_checked"] = {"value": len(answers), "limit": 1,
                              "kind": "min"}
    return out, tot.get("c7_blocks", 0)


def passes(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] if c["kind"] == "max"
               else c["value"] >= c["limit"] for c in checks.values())


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             t0: float, device="cuda", fault: str | None = None,
             zstrm=None) -> dict:
    """One run; returns the result line's object."""
    import torch
    if zstrm is None:
        from jdeflate_tpu_torch.stream import zstrm
    build(device)
    payloads = generator.make_payloads(cell.config, cell.traffic)
    kind, op_spans = generator.load(cell.traffic["op"])
    op = kind(cell.config, cell.traffic, payloads, device, zstrm)
    op.prepare()
    for i in op.warm_calls():
        op.call(i)
    order = generator.call_order(len(payloads), seed)
    sampler = Sampler(cell.traffic["check"], seed, len(payloads))
    readers = {m["name"]: spec.load_module("layer_metrics", m["name"])
               for m in cell.per_layer} if trace else {}
    s0 = tracing.program_stats()
    planted = (faults.FAULTS[fault](zstrm) if fault
               else contextlib.nullcontext())
    cuda = device == "cuda"
    u0 = resource.getrusage(resource.RUSAGE_SELF)
    with planted:
        if trace:
            window, tr, calls, kernels = traced(cell, op, op_spans, order,
                                                sampler, readers, t0)
        else:
            window = measure(op, order, seconds, sampler, t0)
        u1 = resource.getrusage(resource.RUSAGE_SELF)
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        grew = tracing.delta(s0, tracing.program_stats())
        fresh, fresh_failed = fresh_call(cell, op, seed)
    log(f"host CPU time in the {'stretch' if trace else 'window'}: user "
        f"{u1.ru_utime - u0.ru_utime:.3f} s, system "
        f"{u1.ru_stime - u0.ru_stime:.3f} s")
    by = collections.defaultdict(list)
    for r in window.records:
        by[r.payload].append(r.seconds)
    log("call seconds by payload (median, max, n): " + "; ".join(
        f"{k}: {statistics.median(v):.4f} {max(v):.4f} {len(v)}"
        for k, v in sorted(by.items())))
    log(f"{cell.name} seed {seed}: set-up {window.setup_s:.3f} s; "
        f"{len(window.records)} calls in {window.seconds:.3f} s; program "
        f"captures {grew.get('captures', 0)}, replays "
        f"{grew.get('replays', 0)}, evictions {grew.get('evictions', 0)} "
        f"in the {'stretch' if trace else 'window'}")
    failed = 0
    for r in window.records:
        if r.error:
            if not failed:
                log(f"call on payload {r.payload} failed: {r.error}")
            failed += 1
    if trace and any(hasattr(m, "KERNEL") for m in readers.values()):
        count_bytes(op, tr, calls, kernels)
    checks, c7 = judge(op, sampler.answers() + fresh,
                       failed + fresh_failed, seed)
    log(f"C7 blocks among the sampled index blocks (not compared): {c7}")
    metrics = {}
    if trace:
        for m in cell.per_layer:
            v = readers[m["name"]].read(tr)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            v = spec.load_module("end_to_end", m["name"]).read(window)
            if v is None:       # only where no call succeeded
                if passes(checks):
                    raise RuntimeError(f"{m['name']} has nothing to read")
                continue
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips if cuda else 0, "memory_peak_bytes": peak}
    if cuda:
        dev["power_limit"] = power_limit()
    result = {"correct": passes(checks), "attempted": len(window.records),
              "failed": failed, "metrics": metrics,
              "device": dev}
    if trace:
        if tr.busy_s is not None:
            dev["busy_s"] = tr.busy_s
            dev["window_s"] = tr.window_s
        if tr.breakdown is not None:
            result["breakdown"] = tr.breakdown
    result["checks"] = checks
    return result

