"""What the coding stages (codec/deflate.py code_batch) cost per 1 MiB
batch, stage by stage, on one CUDA card. Run from a checkout's root:

    python3 scripts/code_stage_times.py

For levels 1, 6 and 9, on the first 1 MiB batch of benchmark/corpus.py's
payload (16 blocks of 64 KiB) with its match stage's (length, dist):

1. graph timing: each of code_batch's stage exits (walk, freqs, split,
   entropy, codes, items, stored, pack, offsets) and the whole coding
   program (full, as launch_batch runs it) captured as a program and
   replayed, the CUDA-event median of 10 replays; an exit runs every stage
   before it, so the difference from the previous exit is that stage's
   time (each program's input copies and output clones included);
2. the program's own stage counters: the batch launched and read back
   10 times as the encoder does (launch_batch, read_batch) inside a trace
   request, the median of encode.match_ns, encode.launch_wait_ns,
   encode.code_ns and encode.entropy_ns (the card's clock stamped inside
   the two programs), printed beside the graph-difference entropy stage of
   1, which includes its program's copies and clones;
3. the whole coding program replayed 10 times under torch.profiler: its
   device busy time per batch, the running scans' device time per batch
   (PyTorch's cummax / cummin kernel, "with_indices", or csrc/rowscan.cu's
   kernels) and its top device operations.

It runs on a checkout without ops/scan.py, or without the stamps (2 is
then skipped), too, so parent and change can be compared in one call.
"""
import statistics
import subprocess
import sys

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, ".")
from benchmark import corpus  # noqa: E402
from jdeflate_tpu_torch import trace  # noqa: E402
from jdeflate_tpu_torch.codec import deflate as D  # noqa: E402
from jdeflate_tpu_torch.codec import program  # noqa: E402

BL, BATCH = 1 << 16, 16
STAGES = ("walk", "freqs", "split", "entropy", "codes", "items", "stored",
          "pack", "offsets")
SCAN_NAMES = ("with_indices", "rowscan")
COUNTERS = ("encode.match_ns", "encode.launch_wait_ns", "encode.code_ns",
            "encode.entropy_ns")


def dev_us(e):
    for a in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(e, a):
            return getattr(e, a)
    return 0.0


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return (x,)
    if isinstance(x, (tuple, list)):
        return tuple(t for y in x for t in _tensors(y))
    return ()


def _stage(data, sc, length, dist, bl, batch, level, num_words, stage):
    return _tensors(D.code_batch(data, *sc.unbind(), length, dist, bl, batch,
                                 level, num_words, False, stage))


def graph_ms(fn, inputs, statics, reps=10):
    """CUDA-event median of fn replayed as a captured program."""
    program.run(fn, inputs, statics)
    program.run(fn, inputs, statics)
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        program.run(fn, inputs, statics)
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def first_batch(level):
    data = corpus.make_payload(1 << 20, 2727, 0, corpus.MIX)
    enc = D.RawDeflater(level=level, block_size=BL, batch=BATCH,
                        device="cuda")
    enc.capture_calls = True
    with program.eager():
        enc.compress(data)
    d, *scal = enc.last_calls[0]
    sc = torch.tensor(scal, dtype=torch.int64, device=d.device)
    st = enc.call_statics
    with program.eager():
        match = D._match_handle(d, sc, *st[:3])
    return (d, sc, *match), st, enc


def stage_counters(enc, reps=10):
    """The median of each of COUNTERS over `reps` launches and reads of the
    first batch, ms; None on a checkout whose programs stamp no clock."""
    if not hasattr(D, "STAMPS"):
        return None
    st = enc.call_statics
    nch = D._nch(st[0], D.levels_mod.get_level(st[2]).chunk)
    got = []
    for _ in range(reps + 1):
        with trace.request("code_stage_times"):
            D.read_batch(D.launch_batch(*enc.last_calls[0], *st), st[1], nch)
        got.append(trace.last_request()["counters"])
    return {k: statistics.median(c[k] for c in got[1:]) / 1e6
            for k in COUNTERS}


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    print(sys.version.split()[0], torch.__version__, torch.version.cuda)
    for level in (1, 6, 9):
        ins, st, enc = first_batch(level)
        bl, batch, lv, num_words = st[:4]
        prev, rows, cum = 0.0, [], {}
        for s in STAGES:
            ms = graph_ms(_stage, ins[:4], (bl, batch, lv, num_words, s))
            rows.append(f"{s} {ms:.3f} (+{ms - prev:.3f})")
            prev = cum[s] = ms
        full = graph_ms(D._code_handle, ins, st)
        rows.append(f"full {full:.3f} (+{full - prev:.3f})")
        print(f"graph timing level {level}, ms a 1 MiB batch, cumulative "
              f"(+ the stage): " + "; ".join(rows), flush=True)
        got = stage_counters(enc)
        if got is not None:
            print(f"stage counters level {level}, median ms a 1 MiB batch: "
                  + "; ".join(f"{k} {v:.4f}" for k, v in got.items())
                  + f"; graph-difference entropy stage "
                  f"{cum['entropy'] - cum['split']:.4f}", flush=True)
        # the profiler loses a session's first kernel records: spin
        # kernels take that loss
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(64):
                torch.cuda._sleep(10_000)
            for _ in range(10):
                program.run(D._code_handle, ins, st)
            torch.cuda.synchronize()
        kern = [(dev_us(e) / 1e3, e.count, e.key) for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and "spin" not in e.key]
        busy = sum(k[0] for k in kern) / 10
        scans = [k for k in kern if any(n in k[2] for n in SCAN_NAMES)]
        print(f"profile level {level}, 10 replays of the coding program: "
              f"device busy {busy:.3f} ms a batch; running scans "
              f"{sum(k[0] for k in scans) / 10:.4f} ms a batch in "
              f"{sum(k[1] for k in scans) / 10:g} kernels ("
              + "; ".join(f"{k[2][:60]} x{k[1]}" for k in scans) + "); top: "
              + "; ".join(f"{k[2][:60]} x{k[1]} {k[0] / 10:.4f} ms"
                          for k in sorted(kern, reverse=True)[:8]),
              flush=True)


if __name__ == "__main__":
    main()
