"""Chip smoke test of the PyTorch/CUDA port (jdeflate_tpu_torch) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from jdeflate_tpu_torch/csrc, then drives the
port's main path: a 32 MiB Silesia-like corpus compressed by zlib at level
6, indexed by RawInflater.build_index and decoded on the GPU through the
window-walk and token-expansion kernels, raw and gzip-framed. It holds each
kernel against its plain PyTorch version on the main path's inputs, checks
that a tampered window anchor errs and falls back to the native decoder,
and times everything. Any failure exits non-zero. The last line is
{"ok": true, "device": {...}}; the line with {"kernels": [...]} before it
lists every kernel with its launches, error against the plain version,
time, bound and the plain version's time.

Without a CUDA device it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
import zlib

REPO = os.path.dirname(os.path.abspath(__file__))
CORPUS_MB = 32
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate (data sheet)
BATCH = dict(max_batch_bits=1 << 25, max_batch_blocks=256,
             max_batch_out=1 << 23)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def _source_text(n: int) -> bytes:
    """Real-text component: C/C++ and Python sources that ship in the repo
    (the frozen reference package, so the corpus is the same in every
    checkout)."""
    paths = [os.path.join(REPO, "native", "jdnative.cpp"),
             os.path.join(REPO, "oracle", "jdeflate_cli.c")]
    for root, _, files in sorted(os.walk(os.path.join(REPO, "jdeflate_tpu"))):
        paths += [os.path.join(root, f) for f in sorted(files)
                  if f.endswith(".py")]
    blob = b""
    for p in paths:
        with open(p, "rb") as f:
            blob += f.read()
    return (blob * (n // len(blob) + 1))[:n]


def make_corpus(n: int) -> bytes:
    """Deterministic Silesia-like mix (the bench's generator, copied): real
    source text, words, records with noise, runs, near-random."""
    import numpy as np
    rng = np.random.default_rng(20260817)
    parts = []
    words = [b"the ", b"of ", b"and ", b"compression ", b"deflate ",
             b"window ", b"entropy ", b"stream ", b"block ", b"huffman ",
             b"match ", b"distance ", b"symbol ", b"encode ", b"decode \n"]
    ref = _source_text(n)
    ref_pos = 0
    total = 0
    while total < n:
        kind = rng.integers(5)
        if kind == 0:       # synthetic text
            k = int(rng.integers(1 << 16, 1 << 18))
            idx = rng.integers(0, len(words), k // 6)
            seg = b"".join(words[i] for i in idx)[:k]
        elif kind == 1:     # structured records with noise
            rec = rng.integers(0, 256, 96, dtype=np.uint8)
            reps = int(rng.integers(500, 3000))
            m = np.tile(rec, (reps, 1))
            noise = rng.integers(0, 96, reps)
            m[np.arange(reps), noise] = rng.integers(0, 256, reps)
            seg = m.tobytes()
        elif kind == 2:     # runs
            k = int(rng.integers(1 << 15, 1 << 17))
            vals = rng.integers(0, 8, k // 64, dtype=np.uint8)
            seg = np.repeat(vals, 64).tobytes()
        elif kind == 3:     # high entropy
            k = int(rng.integers(1 << 14, 1 << 16))
            seg = rng.integers(0, 256, k, dtype=np.uint8).tobytes()
        else:               # real source text
            k = int(rng.integers(1 << 16, 1 << 18))
            seg = ref[ref_pos:ref_pos + k]
            ref_pos = (ref_pos + k) % max(len(ref) - (1 << 18), 1)
        parts.append(seg)
        total += len(seg)
    return b"".join(parts)[:n]


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0 or not r.stdout.strip():
        fail(f"nvidia-smi: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def gpu_ms(fn, reps: int = 3) -> float:
    """Mean device time of fn() over reps runs after one warm run, from CUDA
    events around the whole run of reps calls."""
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def profile_decode(dec, raw, idx, span_s: float) -> None:
    """Device time by kernel over one decode (torch.profiler), and the
    device's busy share of the decode's span."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        dec.decompress(raw, index=idx)
        torch.cuda.synchronize()
    rows = [(getattr(e, "self_device_time_total", 0) / 1e3, e.count, e.key)
            for e in prof.key_averages()]
    busy = sum(r[0] for r in rows)
    if busy <= 0:
        print("profile: the profiler saw no device time", flush=True)
        return
    top = sorted(rows, reverse=True)[:6]
    print(f"profile: device busy {busy:.1f} ms of the {span_s * 1e3:.1f} ms "
          f"span ({100 * busy / (span_s * 1e3):.1f}%); top: "
          + "; ".join(f"{k[:48]} x{c} {ms:.1f} ms" for ms, c, k in top),
          flush=True)


def max_abs_err(got, want) -> int:
    import torch
    err = 0
    for g, w in zip(got, want):
        d = (g.to(torch.int64) - w.to(torch.int64)).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    return err


def main() -> None:
    try:
        import torch
        from jdeflate_tpu_torch.codec import inflate as I
        from jdeflate_tpu_torch.formats import headers as H
        from jdeflate_tpu_torch.ops import _cuda
        from jdeflate_tpu_torch.ops import expand2 as ex2
        from jdeflate_tpu_torch.ops import walk as wk
        from jdeflate_tpu_torch.stream import native, zstrm
    except ImportError as e:
        fail(f"cannot import the port: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this needs a CUDA device")
    if any(m == "jax" or m.startswith(("jax.", "jdeflate_tpu."))
           or m == "jdeflate_tpu" for m in sys.modules):
        fail("the port pulled in jax or jdeflate_tpu")

    # ---- 1. setup: card, kernel build (all nvcc processes at once)
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    built = _cuda.build(["walk", "expand"])
    build_s = time.perf_counter() - t0
    for name, (secs, log) in built.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"nvcc {name}.cu: {secs:.1f} s; {' | '.join(regs)}", flush=True)
    print(f"kernel build: {build_s:.1f} s", flush=True)
    if not native.available():
        fail("native indexer library did not build (needs g++)")

    # ---- 2. corpus: 32 MiB, zlib level 6, raw and gzip-framed
    t0 = time.perf_counter()
    data = make_corpus(CORPUS_MB << 20)
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    raw = co.compress(data) + co.flush()
    gz = (H.emit_gzip_header() + raw
          + H.emit_gzip_trailer(zlib.crc32(data), len(data)))
    hl = len(H.emit_gzip_header())
    print(f"corpus: {len(data)} B -> {len(raw)} B zlib-6 raw "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    # ---- 3. main path: index, then decode on the card
    dec = I.RawInflater(device="cuda", **BATCH)
    t0 = time.perf_counter()
    idx = dec.build_index(raw)
    index_s = time.perf_counter() - t0
    dec.capture_calls = True
    wk.walk_cuda.launches = 0
    ex2.expand_tokens.launches = 0
    out = dec.decompress(raw, index=idx)
    torch.cuda.synchronize()
    launches = {"walk": wk.walk_cuda.launches,
                "expand2": ex2.expand_tokens.launches}
    stats = list(dec.last_stats)
    calls = list(dec.last_calls)
    dec.capture_calls = False
    if out != data:
        fail("raw decode differs from the corpus")
    kinds = [k for k, _, _ in stats]
    if any(k not in ("win", "stored") for k in kinds):
        fail(f"unexpected batch kinds {set(kinds)}")
    if any(e != 0 for _, _, e in stats):
        fail(f"a batch erred on the main path: {stats}")
    nwin = kinds.count("win")
    if nwin == 0 or launches != {"walk": nwin, "expand2": nwin}:
        fail(f"launches {launches} != {nwin} windowed batches")
    print(f"main path: index {index_s:.2f} s, {len(idx['block_bits'])} "
          f"blocks, {nwin} win + {kinds.count('stored')} stored batches, "
          f"launches {launches}", flush=True)
    outg = zstrm.decompress(gz, index=idx, header_len=hl, device="cuda")
    if outg != data:
        fail("gzip decode differs from the corpus")
    print("gzip-framed decode with CRC32 trailer check: ok", flush=True)

    # ---- 4. each kernel against its plain version, on the card
    per = []
    for words, metas, row, halo, npe, nb, oc in calls:
        args = I._walk_inputs(words, metas[row], npe, nb)[0]
        per.append((args, halo, oc))
    walk_err = exp_err = 0
    for args, halo, oc in per[:2]:
        got = wk.walk_cuda(*args)
        want = wk.walk_windows_ref(*args)
        walk_err = max(walk_err, max_abs_err(got, want))
        ann = wk.annotate_lit_runs(got[0])
        o, p, e = ex2.expand_tokens(ann, got[1], halo, oc)
        ro, rp, re_ = ex2.expand_tokens_ref(ann, got[1], halo, oc)
        n = int(rp)
        if int(p) != n or int(e) != 0 or int(re_) != 0:
            fail(f"expand produced {int(p)} vs plain {n}")
        exp_err = max(exp_err, max_abs_err([o[:n]], [ro[:n]]))
    if walk_err or exp_err:
        fail(f"kernel differs from plain version: walk {walk_err}, "
             f"expand {exp_err}")
    print(f"kernels equal their plain versions on {min(2, len(per))} "
          "batches (max abs err 0)", flush=True)

    # ---- 5. fallback: a tampered anchor errs and is re-decoded natively
    k = max((i for i, w in enumerate(idx["win"]) if w is not None),
            key=lambda i: len(idx["win"][i]))
    win = list(idx["win"])
    win[k] = win[k].copy()
    valid = [i for i, a in enumerate(win[k]) if a >= 0]
    win[k][valid[len(valid) // 2]] += 1
    outt = dec.decompress(raw, index={**idx, "win": win})
    bad = [(p, e) for kk, p, e in dec.last_stats if kk == "win" and e > 0]
    if not bad or outt != data:
        fail(f"tampered anchor: err batches {bad}, bytes ok {outt == data}")
    print(f"tampered anchor: batch err {bad[0][1]} -> native re-decode ok",
          flush=True)

    # ---- 6. times
    walk_ms, exp_ms, walk_bound, exp_bound = [], [], [], []
    walk_plain, exp_plain = [], []
    ntok = 0
    lanes = []
    for args, halo, oc in per:
        start_rel, t1 = args[3], args[4]
        L = start_rel.numel()
        lanes.append(L)
        res = wk.walk_cuda(*args)
        ann = wk.annotate_lit_runs(res[0])
        walk_ms.append(gpu_ms(lambda: wk.walk_cuda(*args)))
        exp_ms.append(gpu_ms(lambda: ex2.expand_tokens(ann, res[1], halo,
                                                       oc)))
        walk_plain.append(gpu_ms(lambda: wk.walk_windows_ref(*args), 1))
        exp_plain.append(gpu_ms(
            lambda: ex2.expand_tokens_ref(ann, res[1], halo, oc), 1))
        # least bytes: each input read once, each output written once
        active = int((start_rel >= 0).sum())
        walk_bytes = (active * 4 + L * 4 + 4 * t1.shape[0] * 128 * 4
                      + L * wk.S_SLOTS * 4 + L * 4)
        produced = int(res[1].sum())
        exp_bytes = L * wk.S_SLOTS * 4 + L * 4 + I.HALO + produced
        walk_bound.append(walk_bytes / HBM_BYTES_PER_S * 1e3)
        exp_bound.append(exp_bytes / HBM_BYTES_PER_S * 1e3)
        ntok += int((res[0] != 0).sum())

    dec.decompress(raw, index=idx)                       # warm
    torch.cuda.synchronize()
    walls, spans = [], []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        o = dec.decompress(raw, index=idx)
        b.record()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        spans.append(a.elapsed_time(b) / 1e3)
        if o != data:
            fail("timed decode differs from the corpus")
    wall, span = statistics.median(walls), statistics.median(spans)
    print(f"decode ({card}): wall {wall * 1e3:.1f} ms = "
          f"{len(data) / wall / 1e9:.4f} GB/s; device span "
          f"{span * 1e3:.1f} ms = {len(data) / span / 1e9:.4f} GB/s; "
          f"runs {[round(w * 1e3, 1) for w in walls]} ms", flush=True)
    print(f"walk ({card}): {statistics.mean(walk_ms):.3f} ms/launch x "
          f"{launches['walk']} (per batch {[round(x, 3) for x in walk_ms]}); "
          f"plain {statistics.mean(walk_plain):.3f} ms; bound "
          f"{statistics.mean(walk_bound):.4f} ms; "
          f"{statistics.mean(lanes):.0f} lanes/launch", flush=True)
    print(f"expand2 ({card}): {statistics.mean(exp_ms):.3f} ms/launch x "
          f"{launches['expand2']} (per batch {[round(x, 3) for x in exp_ms]}); "
          f"plain {statistics.mean(exp_plain):.3f} ms; bound "
          f"{statistics.mean(exp_bound):.4f} ms; {ntok} tokens, "
          f"{sum(exp_ms) * 1e6 / ntok:.1f} ns/token", flush=True)
    profile_decode(dec, raw, idx, span)

    kernels = [
        {"name": "walk", "route": "cuda",
         "source": "jdeflate_tpu_torch/csrc/walk.cu",
         "replaces": "jdeflate_tpu/ops/walk.py:266",
         "launches": launches["walk"], "max_abs_err": walk_err,
         "ms": statistics.mean(walk_ms),
         "plain_ms": statistics.mean(walk_plain),
         "bound_ms": statistics.mean(walk_bound), "bound_by": "bytes",
         "library_ms": None},
        {"name": "expand2", "route": "cuda",
         "source": "jdeflate_tpu_torch/csrc/expand.cu",
         "replaces": "jdeflate_tpu/ops/expand2.py:47",
         "launches": launches["expand2"], "max_abs_err": exp_err,
         "ms": statistics.mean(exp_ms),
         "plain_ms": statistics.mean(exp_plain),
         "bound_ms": statistics.mean(exp_bound), "bound_by": "bytes",
         "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    main()
