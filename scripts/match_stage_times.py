"""Which scan kernels the encoder runs, where, and what the match stage's
parts cost per 1 MiB batch, on one CUDA card. Run from a checkout's root:

    python3 scripts/match_stage_times.py [--timing-only]

1. level 6 on 8 MiB and level 9 on 4 MiB, captured (as the benchmark's
   encode cells run them), profiled: every device kernel whose name holds
   "scan", full name, count and ms.
2. eager, one 1 MiB batch at levels 1, 6 and 9, the match stage and the
   coding stages profiled apart: aten::cummin / aten::cummax by input
   shape, count and device ms.
3. CUDA-event medians per batch: the match stage whole, without the exact
   extension, and (where ops/lz77.py has extend_top) stage 1's kernel,
   its plain loop and the top-T choice.
"""
import statistics
import sys

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, ".")
from benchmark import corpus  # noqa: E402
from jdeflate_tpu_torch.codec import deflate as D  # noqa: E402
from jdeflate_tpu_torch.codec import levels, program  # noqa: E402
from jdeflate_tpu_torch.ops import lz77  # noqa: E402

BL, BATCH = 1 << 16, 16


def dev_us(e):
    for a in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(e, a):
            return getattr(e, a)
    return 0.0


def tot_us(e):
    for a in ("device_time_total", "cuda_time_total"):
        if hasattr(e, a):
            return getattr(e, a)
    return 0.0


def ev_ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def calls(level, mb, seed=2121):
    data = corpus.make_payload(mb << 20, seed, 0, corpus.MIX)
    enc = D.RawDeflater(level=level, block_size=BL, batch=BATCH,
                        device="cuda")
    enc.capture_calls = True
    with program.eager():
        enc.compress(data)
    return data, enc, enc.last_calls, enc.call_statics


def captured_scans():
    for level, mb in ((6, 8), (9, 4)):
        data = corpus.make_payload(mb << 20, 2121, 0, corpus.MIX)
        enc = D.RawDeflater(level=level, block_size=BL, batch=BATCH,
                            device="cuda")
        enc.compress(data)
        enc.compress(data)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            enc.compress(data)
            torch.cuda.synchronize()
        rows = [(dev_us(e) / 1e3, e.count, e.key) for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(r[0] for r in rows)
        print(f"== captured level {level}, {mb} MiB ({mb} batches): busy "
              f"{busy:.3f} ms", flush=True)
        for ms, c, k in sorted(rows, reverse=True)[:4]:
            print(f"  top {ms:.3f} ms x{c} {k[:90]}")
        for ms, c, k in sorted(rows, reverse=True):
            if "scan" in k:
                print(f"  SCAN {ms:.3f} ms x{c} ({ms / c:.4f} ms/call) "
                      f"{k[:400]}", flush=True)


def stage_scans():
    for level in (1, 6, 9):
        _, _, cl, st = calls(level, 1)
        data, *scal = cl[0]
        sc = torch.tensor(scal, dtype=torch.int64, device=data.device)
        bl, batch, lv = st[:3]
        with program.eager():
            match = D._match_handle(data, sc, bl, batch, lv)
            D._code_handle(data, sc, *match, *st)
            torch.cuda.synchronize()
            for name, fn in (
                    ("match", lambda: D._match_handle(data, sc, bl, batch,
                                                      lv)),
                    ("code", lambda: D._code_handle(data, sc, *match,
                                                    *st))):
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA],
                             record_shapes=True) as prof:
                    fn()
                    torch.cuda.synchronize()
                busy = sum(dev_us(e) for e in prof.key_averages()
                           if e.device_type
                           == torch.autograd.DeviceType.CUDA) / 1e3
                print(f"== level {level} {name} stage, one batch: device "
                      f"busy {busy:.3f} ms", flush=True)
                for e in prof.key_averages(group_by_input_shape=True):
                    if e.key in ("aten::cummin", "aten::cummax"):
                        print(f"  {e.key} {e.input_shapes[:1]} x{e.count} "
                              f"{tot_us(e) / 1e3:.3f} ms", flush=True)
                for e in prof.key_averages():
                    if e.device_type == torch.autograd.DeviceType.CUDA \
                            and "scan" in e.key:
                        print(f"  kernel x{e.count} {dev_us(e) / 1e3:.3f} "
                              f"ms {e.key[:160]}", flush=True)


def _match(ext, blen, vf, level, exact):
    cfg = levels.get_level(level)
    return lz77.find_matches_batch(
        ext, blen, vf, D.HALO, BL, D.PAD, max(cfg.probes, 1),
        exact_ext=exact, ext_top=cfg.ext_top, ext_rounds=cfg.ext_rounds,
        rescue=cfg.rescue, probe_words=cfg.probe_words, ext_mdiv=cfg.ext_mdiv)


def _stage1_ref(ext, plen, pdist, topd):
    return (lz77.extend_top_ref(ext, plen, pdist, topd),)


def _stage1(ext, plen, pdist, topd):
    return (lz77.extend_top(ext, plen, pdist, topd),)


def _topd(plen, pdist, T):
    return (lz77.top_distances(plen, pdist, T),)


def graph_ms(fn, inputs, statics, reps=10):
    """CUDA-event median of fn replayed as a captured program (its input
    copies and output clones included)."""
    program.run(fn, inputs, statics)
    program.run(fn, inputs, statics)
    return ev_ms(lambda: program.run(fn, inputs, statics), reps)


def timing():
    for level in (1, 6, 9):
        _, _, cl, st = calls(level, 1)
        data, *scal = cl[0]
        bl, batch, lv = st[:3]
        cfg = levels.get_level(level)
        sc = torch.tensor(scal, dtype=torch.int64, device=data.device)
        block_len, vf, _, ext = D._batch_rows(data, *sc.unbind(), bl, batch)
        ins = (ext, block_len, vf)
        full = graph_ms(_match, ins, (level, True))
        noext = graph_ms(_match, ins, (level, False))
        line = (f"graph timing level {level} (T {cfg.ext_top}, rounds "
                f"{cfg.ext_rounds}): match stage {full:.3f} ms/batch, "
                f"without the exact extension {noext:.3f} ms, the "
                f"extension {full - noext:.3f} ms")
        if hasattr(lz77, "extend_top"):
            rec = []
            orig = lz77.extend_top

            def keep(*a):
                rec.append(tuple(x.clone() for x in a))
                return lz77.extend_top_ref(*a)
            lz77.extend_top = keep
            try:
                with program.eager():
                    _match(*ins, level, True)
            finally:
                lz77.extend_top = orig
            a = rec[0]
            kern = ev_ms(lambda: lz77.extend_top(*a), 20)
            kern_g = graph_ms(_stage1, a, ())
            ref = graph_ms(_stage1_ref, a, ())
            topd = graph_ms(_topd, a[1:3], (cfg.ext_top,))
            same = torch.equal(lz77.extend_top(*a), lz77.extend_top_ref(*a))
            sel = int(((a[1] > 0) & torch.isin(a[2], a[3])).sum())
            # the profiler loses the records of a session's first launches:
            # average over the records it kept
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    lz77.extend_top(*a)
                torch.cuda.synchronize()
            kept = [e for e in prof.key_averages()
                    if "extend_kernel" in e.key]
            dev = sum(dev_us(e) for e in kept) / 1e3 / max(
                sum(e.count for e in kept), 1)
            line += (f"; stage 1 kernel {kern:.4f} ms eager, {kern_g:.4f} "
                     f"ms as a program, device {dev:.4f} ms (plain loop "
                     f"as a program {ref:.3f} ms; equal {same}; {sel} of "
                     f"{a[1].numel()} positions selected); top-T "
                     f"{topd:.3f} ms; stage 2 about "
                     f"{full - noext - kern - topd:.3f} ms")
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    lz77.top_distances(a[1], a[2], cfg.ext_top)
                torch.cuda.synchronize()
            rows = sorted(((dev_us(e) / 1e3 / e.count, e.count, e.key[:70])
                           for e in prof.key_averages()
                           if e.device_type
                           == torch.autograd.DeviceType.CUDA), reverse=True)
            line += "; top-T kernels over 10 calls, records kept and ms " \
                "each: " + "; ".join(f"{k} x{c} {ms:.4f} ms"
                                     for ms, c, k in rows[:4])
        print(line, flush=True)


if __name__ == "__main__":
    import subprocess
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    print(sys.version.split()[0], torch.__version__, torch.version.cuda)
    if "--timing-only" not in sys.argv:
        captured_scans()
        stage_scans()
    timing()
