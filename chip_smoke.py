"""Chip smoke test of the PyTorch/CUDA port (jdeflate_tpu_torch) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the eleven CUDA kernels from jdeflate_tpu_torch/csrc (all nvcc
processes at once), then drives the port's paths on a 32 MiB Silesia-like
corpus. Decode: the corpus compressed by zlib at level 6, indexed by
RawInflater.build_index and decoded on the GPU through the window-walk
kernel (with the decode's checks in its epilogue) and the token-expansion
kernel, raw and gzip-framed (a batch may err only where its last
pseudo-entry's word segment clamps, ROADMAP C5, and the err decisions must
be the reference's, E2_ERRS); a tampered window anchor must err and fall
back to the native decoder; the gzip-framed decode and the level-6 gzip
encode below must each launch the crc32 kernel (csrc/crc32.cu) once.
crc32: the kernel on 1 MiB and 51,220,480 B of seeded random bytes, from
bytes and from a device tensor, must equal zlib.crc32 and the plain
program chain on the card; its time, device time, bound and the plain
chain's time go in its row. Match probe: the bucket probe kernel
(csrc/lz77probe.cu) on the encoder's rows of one 1 MiB batch at levels 1,
6 and 9 must equal the plain loop on the card; its time, device time,
bound, the plain loop's time and the candidates its walk visits per
position go in its row. Tree kernel: the two-queue Huffman kernel
(csrc/huffman2q.cu) on the (512, 286) and (512, 30) rows of one 1 MiB
level-9 batch must equal the plain loop on the card; its time, device
time, bound and the plain loop's time go in its row. Scan kernel: the
running scan kernel (csrc/rowscan.cu) on every input that code_batch hands
scan.running in one 1 MiB batch at levels 6 and 9 must equal the plain
route on the card; its time, device time, bound, the plain route's time
and one torch.cummax / torch.cummin call's go in its row. Encode:
compress_with_index at level 6 with 64 KiB blocks in batches of 16 (the
bench's round trip) through the match-walk and match-probe kernels (one
launch of each a batch); the gzip stream must
inflate in zlib and in the port's decoder with every windowed batch at err
0, and a FEXTRA self-indexed member (of the first MiB: the field holds at
most 64 KiB of index) must decode with no index handed over. v5 decode: the
same 32 MiB decode with JDT_EXPAND=5, through the walk, seed-plane and
resolve kernels; its errs must be the walk's plus the reference's
seed-window and spill limits (ROADMAP C3, V5_ERRS). Anchored decode: the first 8 MiB encoded by the port at
level 6, re-indexed with symbol anchors taken from the symbol lattice the
port computes on the card, through the v1 match-expansion kernel, every
batch at err 0. Dense decode: the first 8 MiB compressed by zlib, indexed
with block offsets only (its segmented orbits err in both packages,
ROADMAP C8), and a 1 MiB dense decode held against the CPU. ZStream: the
corpus through ZStream("deflate") in uneven writes with one sync flush
midway (each segment equal to RawDeflater of its chunk and dictionary, the
CRC32 equal to zlib's), and the zlib-6 gzip stream with trailing garbage
fed to ZStream("inflate") in 1 MiB chunks (output, used_input and
unused_data checked); the host time of its checksum round trips is printed.
Sharded: ShardedDeflater on four ranks of cuda:0, members mode over the
corpus (gzip and decompress_members on the card must give it back), stream
mode over the first 8 MiB (its combined CRC32 equal to zlib's), and a
verify=True run whose fault hook corrupts one shard (one retry, right
output); the match walk is held to its plain version on the members
encode's batches, the walk and the token expansion on the member
decodes'; then the two level-9 members cases of the tests
(L9_MEMBER_CASES: 4 KiB blocks, one where a match crosses a 2 KiB split
seam), whose card blob, info and per-batch decode record must equal the
CPU's. Multi-process: the same sharded runs over a gloo group of
worker processes of this script (python3 chip_smoke.py --mp-worker JOB
RANK, started by the script itself), every rank on cuda:0: 4 processes x
1 rank in members mode over the corpus and in stream mode over 8 MiB, 2
processes x 2 ranks with verify=True and the fault hook on global rank 1;
every process's blob, info and retries must equal the one-process run's,
and the match walk is held to its plain version on each worker's first
round; every worker must exit 0 with no gloo thread left after its
teardown (parallel/mesh.py's order), and the phase prints their return
codes. Levels (phase 14): the first 256 KiB encoded at levels 1 and 9 on
the card and on the CPU must give equal streams and indexes, and the
match walk is held to its plain version on their batches. Programs (phase
15): with the captured
programs cleared, RawDeflater at levels 1, 6 and 9, ZStream("deflate")
and ShardedDeflater (members and stream, four ranks of cuda:0) run as
captured CUDA graphs (the card's default, which every earlier phase ran)
and under program.eager(); streams, indexes and window anchors must be
byte-equal (sha256) and the match walk's, match probe's, tree
kernel's and exact extension kernel's launches equal, each level's first
batch through its two programs (match stage, coding stages) must equal
encode_batch in one eager call, its stage times are printed, its record's
encode.match_kernel, encode.tree_kernel, encode.ext_kernel and
encode.scan_kernel must equal the probe's, the tree kernel's, the
extension kernel's and the scan kernel's launches (the tree kernel's: none
at levels 1 and 6; the extension kernel's: one a batch; the scan
kernel's: 7 a batch, 9 at level 9), the extension kernel (csrc/lz77extend.cu) must equal its plain
loop on the card on that batch's stage-1 inputs (its time, device time,
bound and the plain loop's time go in its row), and
RawDeflater.launch (Phase 1) must make no synchronising call under
torch.cuda.set_sync_debug_mode("error"); walls, graphs captured, capture
times and adler32's time per call are printed. Decode programs
(phase 16): every decode batch runs as a captured program on the card
(each earlier decode did); with the cache cleared, engine 2 and v5 on the
32 MiB zlib-6 stream and the anchored and dense decodes of its first 8 MiB
run captured and under program.eager(): sha256 of the output, last_stats,
the first erring batch and every kernel's launches must be equal; walls,
programs, captures and replays are printed, then the engine-2 decode's
host time by phase (_plan, uploads, the launch loop, the readback with
_fill, the native re-decode). Each phase boundary prints memory_reserved
and the program cache's bytes. Each path's kernel launches are counted from
zero around it (path_launches in the kernels line; a replay adds the
launches its capture recorded). Each kernel is
held against its plain PyTorch version on the main path's inputs, the
encoder's integer stages on the card against the same stages on the CPU,
and everything is timed. The walk (B1) is held to its plain version on
every windowed batch (tokens and meta; lane bytes, lane offsets and err),
on the batches a tampered anchor changes and on synthetic changes to three
batches (adversarial_windows). The token expansion (B2) is held to its plain
version and to the corpus on every windowed batch at err 0, on synthetic
adversarial token streams (adversarial_tokens) and over three runs of one
batch; the match walk (B3) on all encode batches and on synthetic edge
cases (adversarial_walks); the v5 seed plane (B4) and resolve (B5) on
every windowed batch and on synthetic plans (adversarial_plans);
the v1 match expansion (B6) on every anchored batch, on synthetic token
slots (adversarial_slots) and match lists (adversarial_match_lists). Any
failure exits non-zero. The last line is {"ok": true, "device": {...}};
the line with {"kernels": [...]} before it lists every kernel with its
launches, error against the plain version, time (CUDA events around
back-to-back calls, and its kernels' own device time from the profiler),
bound, the plain version's time and the library call's time; the profile
lines give each path's device busy time and its scan kernels' total.

Without a CUDA device it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import gzip
import json
import os
import random
import statistics
import struct
import subprocess
import sys
import time
import zlib

REPO = os.path.dirname(os.path.abspath(__file__))
CORPUS_MB = 32
ANCH_MB = 8                   # anchored and dense decode: the first 8 MiB
DENSE_MB = 8
ZS_WRITE = 1_000_003          # ZStream deflate: uneven writes
SHARD_RANKS = 4               # sharded encode: four ranks on cuda:0
SHARD_STREAM_MB = 8           # sharded stream mode and the retry run
MP_WORKER_S = 300             # multi-process phase: each spawn's limit
PROFILE_MB = 4                # ZStream and sharded paths: profiled slice
LEVELS_KB = 256               # phase 14: levels 1 and 9, card and CPU
PROGRAM_MB = 8                # phase 15: levels 1 and 6, ZStream, sharded
PROGRAM_L9_MB = 2             # phase 15: level 9
# phase 15: the encode stages' counters of codec/deflate.py read_batch
STAGE_COUNTERS = ("encode.match_ns", "encode.launch_wait_ns",
                  "encode.code_ns", "encode.entropy_ns")
PROFILE_SPIN = 64             # device_ms: throwaway launches opening a session
PROFILE_TRIES = 3             # device_ms: sessions before it gives up
# crc32 kernel: a round trip's 1 MiB payload, the largest Silesia file
CRC_SIZES = (1 << 20, 51_220_480)
_T0 = time.perf_counter()
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate (data sheet)
BATCH = dict(max_batch_bits=1 << 25, max_batch_blocks=256,
             max_batch_out=1 << 23)
# the reference's err decisions on the 32 MiB corpus, (windowed batch, err)
# of each logged batch that errs: engine 2 errs where its last
# pseudo-entry's segment clamps (ROADMAP C5), v5 at its seed window first
# (ROADMAP C3); each decode goes native from there
E2_ERRS = [(27, 64)]
V5_ERRS = [(0, 1)]


def stamp(what: str) -> None:
    """A phase boundary: the script's clock, and once the card is in use
    its memory_reserved and the program cache's bytes (after the phase
    before)."""
    mem = ""
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        from jdeflate_tpu_torch.codec import program
        mem = (f"; memory_reserved {torch.cuda.memory_reserved()} B, "
               f"program cache {program.stats['bytes']} B in "
               f"{len(program._programs)} programs "
               f"({program.stats['evictions']} evicted so far)")
    print(f"[{time.perf_counter() - _T0:.1f} s] {what}{mem}", flush=True)


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


def device_ms(fn, names, reps: int = 5) -> float:
    """Device time per call of the kernels whose names contain one of
    `names`, over reps calls of fn after one warm call (torch.profiler): the
    kernels' own time, without the gaps where the device waits for the
    host to launch the next call.

    torch.profiler loses the device records of a session's first kernel
    launches, whatever their kernel (on an H100 with torch 2.11: the first
    one or two early in this script, the first ten or eleven by phase 15,
    so all ten of one session's launches), and a sum over reps read low or
    nothing. So each session opens with PROFILE_SPIN short spin kernels
    (torch.cuda._sleep) to take that loss, and counts only if every launch
    after them has its device record (matched by correlation id); else it
    is profiled again, up to PROFILE_TRIES sessions."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.autograd.DeviceType.CUDA
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_SPIN):
                torch.cuda._sleep(10_000)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = list(prof.profiler.kineto_results.events())
        launches = sorted((e for e in events if e.device_type() != cuda
                           and "LaunchKernel" in e.name()),
                          key=lambda e: e.start_ns())[PROFILE_SPIN:]
        kept = {e.correlation_id(): e for e in events
                if e.device_type() == cuda}
        lost = sum(e.correlation_id() not in kept for e in launches)
        if not lost:
            break
        print(f"device_ms {names}: {lost} of the {len(launches)} launches "
              f"after the spin kernels have no device record; profiling "
              f"again", flush=True)
    else:
        fail(f"the profiler lost the device records of {lost} of "
             f"{len(launches)} launches for {names} in each of "
             f"{PROFILE_TRIES} sessions")
    ns = sum(e.duration_ns() for e in kept.values()
             if any(n in e.name() for n in names))
    if ns <= 0:
        fail(f"the profiler saw no device time for {names}")
    return ns / 1e6 / reps


def profile_run(what: str, fn, span_s: float) -> None:
    """Device time by kernel over one run of fn (torch.profiler), and the
    device's busy share of the run's span. Only device-side events are
    recorded: the host's operator events add nothing to the device time,
    and a 32 MiB encode launches about 320,000 kernels to analyse."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(r[0] for r in rows)
    took = time.perf_counter() - t0
    if busy <= 0:
        print(f"profile {what}: the profiler saw no device time", flush=True)
        return
    top = sorted(rows, reverse=True)[:6]
    scans = [r for r in rows if "scan" in r[2]]
    print(f"profile {what}: device busy {busy:.1f} ms of the "
          f"{span_s * 1e3:.1f} ms span ({100 * busy / (span_s * 1e3):.1f}%); "
          f"{sum(r[1] for r in rows)} device events; scan kernels "
          f"{sum(r[0] for r in scans):.1f} ms x{sum(r[1] for r in scans)}; "
          "top: "
          + "; ".join(f"{k[:48]} x{c} {ms:.1f} ms" for ms, c, k in top)
          + f"; profiled and analysed in {took:.1f} s", flush=True)


def timed_runs(fn, check):
    """Median wall (host clock to a synchronise) and device span (CUDA
    events) of 3 runs of fn after one warm run; check(result) each time."""
    import torch
    fn()
    torch.cuda.synchronize()
    walls, spans = [], []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        res = fn()
        b.record()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        spans.append(a.elapsed_time(b) / 1e3)
        check(res)
    return statistics.median(walls), statistics.median(spans), walls


def encode_phase(data: bytes, zlib6_len: int, card: str) -> tuple:
    """Phase 7: the level-6 encoder on the card. Returns the match-walk
    kernel's entry of the kernels line, the crc32 kernel's launches in
    the gzip encode (one: the CRC-32 of the input), the match probe
    kernel's and the exact extension kernel's (one a batch each)."""
    import torch
    from jdeflate_tpu_torch.codec import deflate as D
    from jdeflate_tpu_torch.codec import inflate as I
    from jdeflate_tpu_torch.ops import checksum as cs
    from jdeflate_tpu_torch.ops import lz77
    from jdeflate_tpu_torch.stream import zstrm
    enc_kw = dict(level=6, block_size=1 << 16, batch=16)
    nbatch = -(-len(data) // (enc_kw["block_size"] * enc_kw["batch"]))

    # ---- 7a. main path: compress_with_index -> decompress, on the card
    lz77.match_walk.launches = 0
    lz77.match_probe.launches = 0
    lz77.extend_top.launches = 0
    cs.crc32_kernel.launches = 0
    t0 = time.perf_counter()
    gz, idx, hl = zstrm.compress_with_index(data, format="gzip",
                                            device="cuda", **enc_kw)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = lz77.match_walk.launches
    probe_launches = lz77.match_probe.launches
    ext_launches = lz77.extend_top.launches
    crc_launches = cs.crc32_kernel.launches
    if launches != nbatch:
        fail(f"match walk launches {launches} != {nbatch} batches")
    if probe_launches != nbatch:
        fail(f"match probe launches {probe_launches} != {nbatch} batches")
    if ext_launches != nbatch:
        fail(f"exact extension launches {ext_launches} != {nbatch} batches")
    if crc_launches != 1:
        fail(f"crc32 kernel launches in the gzip encode {crc_launches} != 1")
    if zlib.decompress(gz, 31) != data:
        fail("zlib does not inflate the port's gzip stream to the corpus")
    I.STATS_LOG.clear()
    if zstrm.decompress(gz, index=idx, header_len=hl, device="cuda") != data:
        fail("the port does not decode its own stream to the corpus")
    kinds = [k for k, _, _ in I.STATS_LOG]
    if "win" not in kinds or any(e != 0 for _, _, e in I.STATS_LOG):
        fail(f"own-stream decode: batch kinds {set(kinds)}, errs "
             f"{[e for _, _, e in I.STATS_LOG if e]}")
    # bytes the logged batches produced; the native decoder did the rest
    # (a batch whose output disagrees with the index ends the device path:
    # ROADMAP C7)
    dev_bytes = sum(p for _, p, _ in I.STATS_LOG)
    # a FEXTRA field holds at most 65,535 bytes of index (about 1.7 MiB of
    # this corpus), so the self-indexed member takes the first MiB
    part = data[:1 << 20]
    emb = zstrm.compress(part, format="gzip", embed_index=True,
                         device="cuda", **enc_kw)
    I.STATS_LOG.clear()
    if zstrm.decompress(emb, device="cuda") != part or "win" not in [
            k for k, _, _ in I.STATS_LOG]:
        fail("the FEXTRA self-indexed member does not decode on the "
             "windowed path")
    raw_len = len(gz) - hl - 8
    print(f"encode main path: {len(data)} B -> {raw_len} B raw "
          f"(ratio {len(data) / raw_len:.4f}; zlib level 6 {zlib6_len} B, "
          f"{raw_len / zlib6_len:.4f}x zlib), {len(idx['block_bits'])} index "
          f"entries, match walk, match probe and exact extension launches "
          f"{launches}, {probe_launches}, {ext_launches} = batches, crc32 "
          f"kernel launches "
          f"{crc_launches}; first call {first_s:.2f} s; "
          f"zlib inflate, own windowed decode "
          f"({kinds.count('win')} win batches at err 0; the batches cover "
          f"{dev_bytes} B, the native decoder the other "
          f"{len(data) - dev_bytes} B) and a FEXTRA member of the first MiB "
          f"({len(emb)} B) ok", flush=True)

    # ---- 7b. encode wall and device span, then a profile of one encode
    enc = D.RawDeflater(device="cuda", **enc_kw)

    def one():
        return enc.compress(data)

    enc.capture_calls = True
    wall, span, walls = timed_runs(one, lambda r: r[0] == gz[hl:-8] or fail(
        "timed encode differs from the main path's stream"))
    calls, statics = list(enc.last_calls), enc.call_statics
    enc.capture_calls = False
    print(f"encode ({card}): wall {wall * 1e3:.1f} ms = "
          f"{len(data) / wall / 1e9:.4f} GB/s; device span "
          f"{span * 1e3:.1f} ms; runs {[round(w * 1e3, 1) for w in walls]} ms",
          flush=True)
    profile_run("encode", one, span)

    # ---- 7c. the match walk against its plain version on every batch's
    # inputs, and the integer stages on the card against the CPU
    bl = statics[0]
    win = match_walk_inputs([(*c, *statics) for c in calls])
    err = match_walk_checks(win, bl)
    call_cpu = (calls[0][0].cpu(), *calls[0][1:])
    for stage in ("match", "walk"):
        gpu = D.encode_batch(*calls[0], *statics, stage=stage)
        cpu = D.encode_batch(*call_cpu, *statics, stage=stage)
        if any(not torch.equal(g.cpu(), c) for g, c in zip(gpu, cpu)):
            fail(f"encode stage {stage!r} on the card differs from the CPU")
    print("stages 'match' and 'walk' of batch 0 equal on card and CPU",
          flush=True)

    ms, plain, bound, counts = [], [], [], []
    for cn, ln, blen in win:
        ms.append(gpu_ms(lambda: lz77.match_walk(cn, ln, blen, bl)))
        plain.append(gpu_ms(lambda: lz77.match_walk_ref(cn, ln, blen, bl),
                            1))
        c = (lz77.match_walk(cn, ln, blen, bl)[:, 0] - 1).cpu()
        counts.append(c)
        # least bytes: the two words each emitted match reads (its length,
        # then the next candidate), the start word and block length of each
        # block, and the whole plist written once
        nb = cn.shape[0]
        moved = 4 * (2 * int(c.sum()) + 2 * nb) + 4 * nb * lz77.WALK_CAP
        bound.append(moved / HBM_BYTES_PER_S * 1e3)
    dev_ms = device_ms(lambda: [lz77.match_walk(*w, bl) for w in win],
                       ("match_walk_kernel",), 3) / len(win)
    per_step = [m * 1e6 / int(c.max()) for m, c in zip(ms, counts)
                if int(c.max()) > 0]
    print(f"lz77walk ({card}): {statistics.mean(ms):.3f} ms/launch x "
          f"{launches} per 32 MiB encode (range {min(ms):.3f}-{max(ms):.3f}); "
          f"plain {statistics.mean(plain):.3f} ms; bound "
          f"{statistics.mean(bound):.5f} ms; matches per block mean "
          f"{float(torch.cat(counts).float().mean()):.0f}, max per launch "
          f"mean {statistics.mean(int(c.max()) for c in counts):.0f}; "
          f"{statistics.mean(per_step):.1f} ns per match of the longest "
          f"block; the kernel's device time {dev_ms:.4f} ms/launch",
          flush=True)
    return {"name": "lz77walk", "route": "cuda",
            "source": "jdeflate_tpu_torch/csrc/lz77walk.cu",
            "replaces": "jdeflate_tpu/ops/lz77.py:388",
            "launches": launches, "max_abs_err": err,
            "ms": statistics.mean(ms), "dev_ms": dev_ms,
            "plain_ms": statistics.mean(plain),
            "bound_ms": statistics.mean(bound), "bound_by": "bytes",
            "library_ms": None}, crc_launches, probe_launches, ext_launches


def _mean(xs):
    return statistics.mean(xs) if xs else None


def batch_offsets(dec, raw: bytes, index: dict, kind: str) -> list:
    """(output offset, output length) of each planned batch of `kind`, in
    plan order: stored batches are host copies, the others end at their
    blocks' total output."""
    from jdeflate_tpu_torch.codec import inflate as I
    W_pad = I._bucket((len(raw) >> 2) + 18, 1 << 13)
    work, _ = dec._plan(raw, index, b"", W_pad)
    res, pos = [], 0
    for k, item in work:
        n = len(item) if k == "stored" else (item[5] if k == "win"
                                             else item[12])
        if k == kind:
            res.append((pos, n))
        pos += n
    return res


def corpus_halo(data: bytes, o0: int):
    """The 32 KiB of the corpus before output offset o0 (zeros before the
    start), on the card: the history a batch starting there resolves
    behind."""
    import torch
    h = data[max(o0 - 32768, 0):o0]
    halo = torch.zeros(32768, dtype=torch.uint8, device="cuda")
    if h:
        halo[32768 - len(h):] = torch.frombuffer(bytearray(h),
                                                 dtype=torch.uint8).cuda()
    return halo


def card_share(runs: list, n: int) -> str:
    """Who produced the n output bytes of the decompress calls whose
    last_stats are `runs`."""
    from jdeflate_tpu_torch.codec.inflate import card_bytes
    card = sum(card_bytes(r)[0] for r in runs)
    host = sum(card_bytes(r)[1] for r in runs)
    return (f"the card produced {card} B ({100 * card / n:.1f}%), stored "
            f"copies {host} B, the native decoder {n - card - host} B")


def scan_kernel_phase(card: str, path_launches: dict) -> dict:
    """The running scan kernel (csrc/rowscan.cu) on the coding stages' own
    inputs of one 1 MiB batch at levels 6 and 9 (16 blocks of 64 KiB,
    Silesia-like bytes): every tensor that
    code_batch hands scan.running (the match walk's next candidate, the
    groups and their ends, the precode runs, the pack's word bounds, the
    window anchors), recorded in an eager encode with the plain route in
    the kernel's place. It must equal the plain route (running_ref) on the
    card; then, at each site, its time per launch (CUDA events over
    back-to-back launches), its device time (profiler), its bound (8 bytes
    in and 8 out an element over 3.35 TB/s), the plain route's time and
    one torch.cummax / torch.cummin call's; and each level's sums over its
    batch's sites. Returns the kernel's row: `launches` the main path's
    (phase 15's captured level-6 encode, `path_launches`: 7 a batch),
    `check_launches` this phase's own checking calls."""
    import torch
    from benchmark import corpus
    from jdeflate_tpu_torch.codec import deflate as D
    from jdeflate_tpu_torch.codec import program
    from jdeflate_tpu_torch.ops import scan

    real = scan.running
    row = {"name": "rowscan", "route": "cuda",
           "source": "jdeflate_tpu_torch/csrc/rowscan.cu",
           "replaces": None, "sites": [],
           "launches": path_launches.get("program_level6", 0),
           "path_launches": dict(path_launches), "check_launches": 0,
           "max_abs_err": 0, "ms": [], "dev_ms": [], "plain_ms": [],
           "bound_ms": [], "bound_by": "bytes", "library_ms": []}
    payload = corpus.make_payload(1 << 20, 2121, 0, corpus.MIX)
    for level in (6, 9):
        rec = []

        def keep(x, op, reverse=False):
            rec.append((x.clone(), op, reverse))
            return scan.running_ref(x, op, reverse)
        scan.running = keep
        try:
            with program.eager():
                D.RawDeflater(level=level, block_size=1 << 16, batch=16,
                              device="cuda").compress(payload)
        finally:
            scan.running = real
        want_n = 9 if level >= 8 else 7
        if len(rec) != want_n:
            fail(f"scan kernel: a level-{level} batch made {len(rec)} "
                 f"running scans, not {want_n}")
        sums = [0.0] * 5
        for x, op, rev in rec:
            before = real.launches
            got = real(x, op, rev)
            want = scan.running_ref(x, op, rev)
            row["check_launches"] += real.launches - before
            err = max_abs_err((got,), (want,))
            row["max_abs_err"] = max(row["max_abs_err"], err)
            if err:
                fail(f"scan kernel on {tuple(x.shape)} {op} reverse {rev}: "
                     f"differs from the plain route by {err}")
            lib = torch.cummax if op == "max" else torch.cummin
            vals = (gpu_ms(lambda: real(x, op, rev), 20),
                    device_ms(lambda: real(x, op, rev), ("rowscan",), 10),
                    x.numel() * 16 / HBM_BYTES_PER_S * 1e3,
                    gpu_ms(lambda: scan.running_ref(x, op, rev), 5),
                    gpu_ms(lambda: lib(x, -1), 5))
            for key, v in zip(("ms", "dev_ms", "bound_ms", "plain_ms",
                               "library_ms"), vals):
                row[key].append(v)
            sums = [a + b for a, b in zip(sums, vals)]
            row["sites"].append([level, list(x.shape), op, rev])
            print(f"rowscan ({card}) level {level} {op}"
                  f"{' reversed' if rev else ''} on {tuple(x.shape)}: = the "
                  f"plain route; {vals[0]:.4f} "
                  f"ms/launch, device {vals[1]:.4f} ms/launch, bound "
                  f"{vals[2]:.4f} ms ({vals[1] / vals[2]:.2f}x the bound); "
                  f"plain route {vals[3]:.4f} ms, torch.cum{op} "
                  f"{vals[4]:.4f} ms", flush=True)
        print(f"rowscan ({card}) level {level}, the {len(rec)} scans of a "
              f"1 MiB batch: {sums[0]:.4f} ms back to back, device "
              f"{sums[1]:.4f} ms, bound {sums[2]:.4f} ms; plain route "
              f"{sums[3]:.4f} ms, torch.cummax/cummin alone {sums[4]:.4f} ms",
              flush=True)
    return row


def profile_slice(what: str, fn) -> None:
    """profile_run of fn, a slice of a path (PROFILE_MB of its input): the
    span from one run, then the profile of another. A profile of a whole
    32 MiB path holds up to a million device events, whose analysis takes
    minutes."""
    _, _, span = one_run(fn)
    profile_run(f"{what} (first {PROFILE_MB} MiB)", fn, span)


def capture_s() -> float:
    """Seconds of the program layer's first calls so far (each an eager run
    and a capture): the span program.capture's process total."""
    from jdeflate_tpu_torch import trace
    return trace.totals()["spans"].get("program.capture", 0.0)


def one_run(fn):
    """fn() once: (result, wall on the host clock to a synchronise, device
    span from CUDA events)."""
    import torch
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a.record()
    res = fn()
    b.record()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, a.elapsed_time(b) / 1e3


@contextlib.contextmanager
def wrapped(owner, name, before=None, after=None):
    """Within the block, a call of owner.name first calls before(*args),
    then after(args, kwargs, result, seconds) once it returns: how the
    script sees the calls a path makes, to hold a kernel to its plain
    version on their arguments or to time them."""
    orig = getattr(owner, name)

    def call(*a, **k):
        if before is not None:
            before(*a)
        t0 = time.perf_counter()
        r = orig(*a, **k)
        if after is not None:
            after(a, k, r, time.perf_counter() - t0)
        return r

    setattr(owner, name, call)
    try:
        yield
    finally:
        setattr(owner, name, orig)


def checksum_calls(secs: list):
    """Within the block, the host seconds of every ops.checksum crc32 and
    adler32 call go to secs: each is a round trip (upload, reduction on
    the card, readback of the value)."""
    from jdeflate_tpu_torch.ops import checksum as cs
    stack = contextlib.ExitStack()
    for name in ("crc32", "adler32"):
        stack.enter_context(wrapped(
            cs, name, after=lambda a, k, r, sec: secs.append(sec)))
    return stack


def round_trips(secs: list, wall: float) -> str:
    """The checksum calls of a run that took `wall` seconds: their count,
    total and median. A call reads its value back, so it also waits for
    the work queued on the card before it; the median is a call's own
    cost where most calls wait for nothing."""
    if not secs:
        return "checksum round trips: none"
    med = statistics.median(secs)
    return (f"checksum round trips {len(secs)} calls, {sum(secs) * 1e3:.1f} "
            f"ms ({100 * sum(secs) / wall:.1f}% of the wall), median "
            f"{med * 1e3:.2f} ms/call (median x calls {med * len(secs) * 1e3:.1f} "
            f"ms, {100 * med * len(secs) / wall:.1f}% of the wall)")


def match_walk_inputs(calls: list) -> list:
    """The match walk's inputs (cnext, len, block_len) of each encode batch,
    from encode_batch's full argument tuples: the match stage and the
    parse run again on the card."""
    import torch
    from jdeflate_tpu_torch.codec import deflate as D
    from jdeflate_tpu_torch.ops import lz77
    win = []
    for call in calls:
        total, bl, batch, level = call[2], call[5], call[6], call[7]
        cfg = D.levels_mod.get_level(level)
        length, dist = D.encode_batch(*call, stage="match")
        blen = torch.clamp(
            total - torch.arange(batch, device=length.device) * bl, 0, bl)
        take = lz77.parse_take(length, dist, blen, cfg.lazy, cfg.good_length)
        cn, ln = lz77.walk_inputs(length, take, blen, bl)
        win.append((cn, ln, blen.to(torch.int32)))
    return win


def v5_phase(dec, raw: bytes, data: bytes, idx: dict, e2_errs: list,
             card: str) -> list:
    """Phase 8: the v5 expansion engine (JDT_EXPAND=5) on the 32 MiB
    decode. Returns the seed and resolve kernels' entries of the kernels
    line."""
    import numpy as np
    import torch
    from jdeflate_tpu_torch.codec import inflate as I
    from jdeflate_tpu_torch.ops import expand5 as ex5
    from jdeflate_tpu_torch.ops import walk as wk

    nwin = len(e2_errs)
    os.environ["JDT_EXPAND"] = "5"
    try:
        # ---- 8a. main path: one decompress, counts zeroed just before
        dec.capture_calls = True
        ex5.seed_plane.launches = 0
        ex5.resolve.launches = 0
        t0 = time.perf_counter()
        out = dec.decompress(raw, index=idx)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = {"seed": ex5.seed_plane.launches,
                    "resolve": ex5.resolve.launches}
        stats, calls = list(dec.last_stats), list(dec.last_calls)
        dec.capture_calls = False
        if out != data:
            fail("v5 decode differs from the corpus")
        if launches != {"seed": nwin, "resolve": nwin}:
            fail(f"v5 launches {launches} != {nwin} windowed batches")
        if any(k not in ("win", "stored") for k, _, _ in stats):
            fail(f"v5 decode: unexpected batch kinds {stats}")

        # ---- 8b. why batches err: the reference's two limits (ROADMAP C3),
        # recomputed per batch from the walk's tokens, on top of the walk's
        # own checks (engine 2's err of the same batch)
        per = []
        for words, metas, row, halo, npe, nb, oc, ww in calls:
            tok, _, outlen, lo = wk.walk_checked(*I._walk_inputs(
                words, metas[row], npe, nb, ww))[:4]
            S16, off, seed = ex5.seed_plane(tok, lo, oc)
            werr = int(ex5.seed_window_err(off, seed, oc))
            serr = int(ex5.spill_pass(tok, lo, S16, oc)[1])
            per.append((tok, outlen, halo, oc, lo, S16, werr, serr))
        logged = [e for k, _, e in stats if k == "win"]
        if [(i, e) for i, e in enumerate(logged) if e] != V5_ERRS:
            fail(f"v5 err decisions {logged} != the reference's {V5_ERRS}")
        want = [e2 + p[6] + p[7] for e2, p in zip(e2_errs, per)]
        if logged != want[:len(logged)]:
            fail(f"v5 errs {logged} != walk + seed window + spill "
                 f"{want[:len(logged)]}")
        nwerr = sum(1 for p in per if p[6])
        nserr = sum(1 for p in per if p[7])
        first_bad = next((i for i, e in enumerate(logged) if e), None)
        if first_bad != next((i for i, e in enumerate(want) if e), None):
            fail("v5: the logged errs disagree with the recomputed limits")
        native = ("none: every windowed batch decoded on the card"
                  if first_bad is None else
                  f"from windowed batch {first_bad} on (its err "
                  f"{logged[first_bad]}), the native decoder")
        print(f"v5 main path: {nwin} win batches, launches {launches}; "
              f"first call {first_s:.2f} s; batches over the reference's "
              f"seed window {nwerr} (regions "
              f"{[p[6] for p in per if p[6]]}), over SPILL_K {nserr}; "
              f"native re-decode {native}", flush=True)

        # ---- 8c. each kernel against its plain version on every batch,
        # and on the synthetic plans' tokens (adversarial_plans): the seed
        # plane and slot arrays, and the resolve
        seed_err = res_err = 0
        plans = []
        for tok, outlen, halo, oc, lo, S16, _, _ in per:
            seed_err = max(seed_err, max_abs_err(
                ex5.seed_plane(tok, lo, oc), ex5.seed_plane_ref(tok, lo, oc)))
            S16f, _ = ex5.spill_pass(tok, lo, S16, oc)
            P = ex5.propagate(ex5.seed16_to_plan(S16f)).contiguous()
            plans.append(P)
            res_err = max(res_err, max_abs_err(
                [ex5.resolve(P, halo, oc)[0]],
                [ex5.resolve_ref(P, halo, oc)]))
        if seed_err or res_err:
            fail(f"v5 kernels differ from plain versions: seed {seed_err}, "
                 f"resolve {res_err}")
        names = []
        for name, tok, outlen, P, halo in adversarial_plans(seed=0,
                                                            cap=1 << 21):
            tok = torch.from_numpy(tok).cuda()
            lo = torch.from_numpy(np.cumsum(outlen, dtype=np.int64)
                                  - outlen).cuda()
            e = max_abs_err(ex5.seed_plane(tok, lo, P.shape[0]),
                            ex5.seed_plane_ref(tok, lo, P.shape[0]))
            if e:
                fail(f"v5 seed plane adversarial plan {name}: {e} max abs "
                     "err")
            P, halo = torch.from_numpy(P).cuda(), torch.from_numpy(halo).cuda()
            o, e = ex5.resolve(P, halo, P.numel())
            r = ex5.resolve_ref(P, halo, P.numel())
            if int(e) or not torch.equal(o, r):
                fail(f"v5 resolve adversarial plan {name}: err {int(e)}, "
                     f"{max_abs_err([o], [r])} max abs err")
            names.append(f"{name} {int(outlen.sum())} B")
        print(f"v5 seed and resolve kernels equal their plain versions on all "
              f"{nwin} batches (max abs err 0; the seed plane with its slot "
              f"arrays), and on the adversarial plans of {1 << 21} "
              f"positions: {', '.join(names)}", flush=True)

        # ---- 8c'. every batch's card output against the corpus slice it
        # covers: the decode above is native from the first erring batch,
        # so this is where the kernels' bytes meet the corpus. Each batch
        # resolves behind the corpus's own 32 KiB before it. Skipped: a
        # batch whose walk errs (C5), whose tokens are wrong, and one over
        # SPILL_K, whose extra seeds the reference drops.
        offs = batch_offsets(dec, raw, idx, "win")
        checked = skipped = 0
        for k, ((tok, outlen, _, oc, _, _, _, serr), P, (o0, n_out)) in \
                enumerate(zip(per, plans, offs)):
            if e2_errs[k] or serr:
                skipped += 1
                continue
            produced = int(outlen.sum())
            got = ex5.resolve(P, corpus_halo(data, o0), oc)[0][
                :produced].cpu().numpy()
            if produced != n_out or got.tobytes() != data[o0:o0 + n_out]:
                fail(f"v5 windowed batch {k}: the card's {produced} B differ "
                     f"from the corpus's {n_out} B at offset {o0}")
            checked += 1
        if checked + skipped != nwin or checked == 0:
            fail(f"v5: {checked} batches held to the corpus of {nwin}")
        print(f"v5 card output equals the corpus on {checked} of {nwin} "
              f"windowed batches ({skipped} skipped: walk err C5 or spill "
              "over SPILL_K)", flush=True)

        # ---- 8d. times
        sd_ms, sd_plain, sd_lib, sd_bound = [], [], [], []
        rs_ms, rs_plain, rs_bound = [], [], []
        for k, ((tok, outlen, halo, oc, lo, _, _, _), P) in enumerate(
                zip(per, plans)):
            sd_ms.append(gpu_ms(lambda: ex5.seed_plane(tok, lo, oc)))
            sd_plain.append(gpu_ms(
                lambda: ex5.seed_plane_ref(tok, lo, oc), 1))
            _, off, seed = ex5.seed_plane(tok, lo, oc)
            lidx = torch.where((seed != 0) & (off < oc), off,
                               torch.full_like(off, oc)).long()
            sd_lib.append(gpu_ms(lambda: torch.zeros(
                oc + 1, dtype=torch.int32, device="cuda").scatter_reduce_(
                0, lidx, seed, "amax")[:oc]))
            # least bytes: the fast slice of the tokens (and the last
            # lane's row) and laneoff read once; the whole plane and the
            # slot arrays written once
            n = off.numel()
            sd_bound.append((4 * n + 4 * wk.S_SLOTS + 8 * lo.numel()
                             + 4 * oc + 8 * n) / HBM_BYTES_PER_S * 1e3)
            rs_ms.append(gpu_ms(lambda: ex5.resolve(P, halo, oc), 1))
            if k < 4:
                rs_plain.append(gpu_ms(lambda: ex5.resolve_ref(P, halo, oc),
                                       1))
            # the plan of the bytes produced read once, the halo read once,
            # the bytes produced written once
            produced = int(outlen.sum())
            rs_bound.append((4 * produced + I.HALO + produced)
                            / HBM_BYTES_PER_S * 1e3)
        sd_dev = device_ms(lambda: [ex5.seed_plane(p[0], p[4], p[3])
                                    for p in per], ("seed_plane_kernel",),
                           3) / nwin
        rs_dev = device_ms(lambda: [ex5.resolve(P, p[2], p[3])
                                    for p, P in zip(per, plans)],
                           ("PlanFront",), 3) / nwin
        print(f"expand5_seed ({card}): {_mean(sd_ms):.4f} ms/launch x "
              f"{launches['seed']}; plain {_mean(sd_plain):.4f} ms; "
              f"scatter_reduce_ {_mean(sd_lib):.4f} ms; bound "
              f"{_mean(sd_bound):.5f} ms; the kernel's device time "
              f"{sd_dev:.4f} ms/launch", flush=True)
        print(f"expand5_resolve ({card}): {_mean(rs_ms):.3f} ms/launch x "
              f"{launches['resolve']} (range {min(rs_ms):.3f}-"
              f"{max(rs_ms):.3f}); plain {_mean(rs_plain):.3f} ms (first "
              f"{len(rs_plain)} batches); bound {_mean(rs_bound):.5f} ms; "
              f"the kernel's device time {rs_dev:.4f} ms/launch", flush=True)
        wall, span, walls = timed_runs(
            lambda: dec.decompress(raw, index=idx),
            lambda o: o == data or fail("timed v5 decode differs"))
        print(f"v5 decode ({card}): wall {wall * 1e3:.1f} ms = "
              f"{len(data) / wall / 1e9:.4f} GB/s; device span "
              f"{span * 1e3:.1f} ms; runs "
              f"{[round(w * 1e3, 1) for w in walls]} ms; of the output, "
              f"{card_share([dec.last_stats], len(data))}", flush=True)
        profile_run("v5 decode", lambda: dec.decompress(raw, index=idx),
                    span)
    finally:
        os.environ.pop("JDT_EXPAND", None)
    return [
        {"name": "expand5_seed", "route": "cuda",
         "source": "jdeflate_tpu_torch/csrc/expand5seed.cu",
         "replaces": "jdeflate_tpu/ops/expand5.py:185",
         "launches": launches["seed"], "max_abs_err": seed_err,
         "ms": _mean(sd_ms), "dev_ms": sd_dev, "plain_ms": _mean(sd_plain),
         "bound_ms": _mean(sd_bound), "bound_by": "bytes",
         "library_ms": _mean(sd_lib)},
        {"name": "expand5_resolve", "route": "cuda",
         "source": "jdeflate_tpu_torch/csrc/expand5resolve.cu",
         "replaces": "jdeflate_tpu/ops/expand5.py:358",
         "launches": launches["resolve"], "max_abs_err": res_err,
         "ms": _mean(rs_ms), "dev_ms": rs_dev, "plain_ms": _mean(rs_plain),
         "bound_ms": _mean(rs_bound), "bound_by": "bytes",
         "library_ms": None},
    ]


def _pack_lanes(rng, toks: list, lit_lanes: int = 0) -> tuple:
    """Flat u32 tokens -> lane-major (L, 32) int32 rows and per-lane output
    bytes. Each lane takes 0-32 consecutive tokens (0 and short counts are
    lanes that end early); the first `lit_lanes` lanes take 32 each."""
    import numpy as np
    lanes, i = [], 0
    while i < len(toks):
        k = 32 if len(lanes) < lit_lanes else int(rng.choice(
            [0, 1, 2, 5, 17, 31, 32], p=[.05, .15, .3, .25, .1, .05, .1]))
        lanes.append(toks[i:i + k])
        i += k
    tok = np.zeros((len(lanes), 32), np.uint32)
    outlen = np.zeros(len(lanes), np.int32)
    for l, row in enumerate(lanes):
        tok[l, :len(row)] = row
        outlen[l] = sum(_tok_len(t) for t in row)
    return tok.view(np.int32), outlen


def _lit(b) -> int:
    """A literal walk token (u32)."""
    return (1 << 30) | int(b)


def _match(n, d) -> int:
    """A match walk token (u32) of length n at distance d."""
    return (2 << 30) | int(n) | ((int(d) - 1) << 9)


def _chains(rng, n_out: int, dmax: int, pos: int = 0) -> list:
    """Walk tokens for at least n_out bytes from output offset pos (behind a
    32 KiB halo): 15% literals, matches of 3-258 bytes at distances up to
    dmax that never reach before the halo, so chains of copies of copies
    cross the output."""
    out, end = [], pos + n_out
    while pos < end:
        if rng.random() < 0.15:
            out.append(_lit(rng.integers(256)))
            pos += 1
            continue
        n = int(rng.integers(3, 259))
        out.append(_match(n, int(rng.integers(1, min(dmax, 32768 + pos)
                                              + 1))))
        pos += n
    return out


def _tok_len(t: int) -> int:
    return 1 if t >> 30 == 1 else t & 0x1FF


def adversarial_tokens(seed: int = 0, scale: int = 1 << 17) -> list:
    """Synthetic token batches for the token expansion, each about `scale`
    output bytes: [(name, tok (L, 32) int32, outlen (L,) int32, halo
    (32768,) uint8, out_cap)] as numpy arrays. Cases: runs of d = 1,
    len = 258 matches; d = 32768 matches reaching the first halo byte;
    overlapping copies (d < len) with every d in 1..8; chains of matches
    copying earlier matches across many 4 KiB and 16 KiB tile seams; lanes
    of 32 literals and lanes that end early; out_cap equal to the bytes
    produced and below them."""
    import numpy as np
    rng = np.random.default_rng(seed)
    halo = rng.integers(0, 256, 32768, dtype=np.uint8)
    lit, match = _lit, _match

    def chains(n_out, dmax):
        return _chains(rng, n_out, dmax)

    cases = []

    def add(name, toks, lit_lanes=0, cap=None):
        tok, outlen = _pack_lanes(rng, toks, lit_lanes)
        produced = int(outlen.sum())
        cases.append((name, tok, outlen, halo,
                      produced if cap is None else cap(produced)))

    n258 = scale // 258
    add("d1_runs", [lit(7)] + [match(258, 1)] * n258)
    add("d32768_halo", [match(258, 32768)] * 4 + chains(scale, 32768))
    ov = []
    while len(ov) < scale // 40:
        d = int(rng.integers(1, 9))
        ov += [lit(rng.integers(256)) for _ in range(d)]
        ov.append(match(int(rng.integers(d + 1, 259)), d))
    add("overlap_d1_8", ov)
    add("chains_near", chains(scale, 64))
    add("chains_far", chains(scale, 32768))
    add("all_literal", [lit(b) for b in rng.integers(0, 256, scale // 4)],
        lit_lanes=1 << 30)
    add("lanes_end_early", chains(scale, 4096))
    add("cap_exact", chains(scale, 20000), cap=lambda p: p)
    add("cap_short", chains(scale, 20000), cap=lambda p: p - p // 3)
    return cases


def adversarial_walks(seed: int = 0, bl: int = 1 << 16) -> list:
    """Synthetic match-walk inputs: [(name, length (B, bl) int32, take (B, bl)
    bool, block_len (B,) int32)] as numpy arrays. Cases: block_len 0, 1,
    bl - 1 and bl; no candidates; length-3 matches at every position (the
    count nears the plist capacity); a match ending exactly at block_len."""
    import numpy as np
    rng = np.random.default_rng(seed)
    pos = np.arange(bl)[None, :]

    def rand(block_len):
        B = len(block_len)
        length = rng.integers(3, 259, (B, bl))
        length[rng.random((B, bl)) < 0.7] = 0
        length = np.minimum(length, block_len[:, None] - pos)
        length = np.where(length >= 3, length, 0).astype(np.int32)
        return length, length >= 3

    cases = []
    bl_edges = np.asarray([0, 1, bl - 1, bl], np.int32)
    cases.append(("block_len_edges", *rand(bl_edges), bl_edges))
    full = np.full(2, bl, np.int32)
    length, _ = rand(full)
    cases.append(("no_candidates", length, np.zeros_like(length, bool), full))
    three = np.where(pos < full[:, None] - 2, 3, 0).astype(np.int32)
    cases.append(("len3_everywhere", three, three > 0, full))
    ends = np.asarray([bl, bl - 7, 4096, 3], np.int32)
    length, _ = rand(ends)
    for b, e in enumerate(ends):
        # nothing in the 258 bytes before it can jump over it
        n = min(int(e), 9)
        length[b, max(e - n - 258, 0):e] = 0
        length[b, e - n] = n
    cases.append(("match_ends_at_block_len", length, length >= 3, ends))
    return cases


def _trim(toks: list, n: int) -> list:
    """The prefix of toks that produces exactly n bytes (the last match cut
    to fit, or literals where fewer than 3 bytes are left)."""
    out, pos = [], 0
    for t in toks:
        k = _tok_len(t)
        if pos + k > n:
            break
        out.append(t)
        pos += k
    left = n - pos
    if left >= 3 and len(out) < len(toks):      # the next token is a match
        return out + [(toks[len(out)] & ~0x1FF) | left]
    return out + [_lit(7)] * left


def _seams(rng, pos: int, n_out: int, dmax: int) -> list:
    """_chains with a 258-byte match across every 64 KiB mark it passes."""
    out, end = [], pos + n_out
    while pos < end:
        mark = (pos // 65536 + 1) * 65536
        t = (_match(258, int(rng.integers(1, min(dmax, 32768 + pos) + 1)))
             if mark - pos < 258 else _chains(rng, 1, dmax, pos)[0])
        out.append(t)
        pos += _tok_len(t)
    return out


def adversarial_slots(seed: int = 0, scale: int = 1 << 17) -> list:
    """Synthetic token slots for the v1 match expansion (B6) through
    codec/inflate.py::_assemble_kernel: [(name, o_len, o_lit, o_dist (S,)
    int32, halo (32768,) uint8, out_cap, first_slots (nblocks + 1,) int32)]
    as numpy arrays, one shape for every case of a scale. About `scale`
    output bytes in blocks of at most 60,000 (the reference kernel takes at
    most 64 KiB a block), tokens in slots with empty slots between them,
    each block starting on a 64-slot lane; block 1 has no slots (an empty
    range). Cases: chains of matches across many 16 KiB tile seams; runs of
    d = 1, then d = 3, over a third of the blocks each (the reference kernel
    in interpret mode takes most of its time on these); d = 32768 matches
    into the halo; 258-byte matches across every 64 KiB mark, each block
    ending in one and the next block's first match reading back across the
    seam; slots before the first block (matches outside every range) and a
    literal-only block (its match range is empty)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    halo = rng.integers(0, 256, 32768, dtype=np.uint8)
    nfill = -(-scale // 60000)             # blocks with output
    per = scale // nfill
    S = 64 * (scale // 2048 + 2 * nfill + 8)
    cases = []

    def add(name, blocks, lead=()):
        o_len, o_lit, o_dist = (np.zeros(S, np.int32) for _ in range(3))
        first, s = [], 0

        def put(toks):
            nonlocal s
            for t in toks:
                s += int(rng.random() < 0.25)      # an empty slot
                o_len[s] = _tok_len(t)
                if t >> 30 == 1:
                    o_lit[s] = t & 0xFF
                else:
                    o_dist[s] = ((t >> 9) & 0x7FFF) + 1
                s += 1
            s = -(-s // 64) * 64

        put(lead)
        for k, toks in enumerate(blocks):
            first.append(s)
            if k == 1:
                first.append(s)                    # the empty block
            put(toks)
        if s > S:
            raise ValueError(f"{name}: {s} slots > {S}")
        cases.append((name, o_len, o_lit, o_dist, halo, 2 * scale,
                      np.asarray(first + [S], np.int32)))

    def fill(dmax, pos=0):
        blocks = []
        for _ in range(nfill):
            blocks.append(_trim(_chains(rng, per, dmax, pos), per))
            pos += per
        return blocks

    add("chains_tile_seams", fill(32768))
    blocks = fill(32768)
    k = max(1, nfill // 3)
    for b in range(min(2 * k, nfill)):
        blocks[b] = _trim([_lit(5)] + [_match(258, 1 if b < k else 3)]
                          * (per // 258 + 1), per)
    add("d1_d3_runs", blocks)
    blocks = fill(32768)
    blocks[0] = _trim([_match(258, 32768)] * (40000 // 258)
                      + _chains(rng, per, 32768, 40000 // 258 * 258), per)
    add("d32768_halo", blocks)
    blocks, pos = [], 0
    for k in range(nfill):
        head = ([_match(258, int(rng.integers(259, 4000)))] if k else [])
        body = _seams(rng, pos + 258 * len(head), per - 516, 2048)
        toks = head + body
        pos += sum(_tok_len(t) for t in toks)
        toks.append(_match(258, int(rng.integers(1, 300))))
        pos += 258
        blocks.append(toks)
    add("block_seams_258", blocks)
    lead = _chains(rng, 3000, 2048)
    nlead = sum(_tok_len(t) for t in lead)
    blocks = fill(32768, nlead)
    blocks[0] = [_lit(b) for b in rng.integers(0, 256, 1500)]
    add("ranges_edges", blocks, lead)
    return cases


def adversarial_match_lists(seed: int = 0, n: int = (1 << 16) + 3) -> list:
    """Synthetic inputs of ops/expand.py::expand_matches (B6) with the
    edges its match lists can have, over a buffer of n bytes (not a whole
    number of 4-byte words): [(name, buf (n,) uint8, m_off, m_d, m_len
    (T,) int32, ranges (nblocks, 4) int32)] as numpy arrays. The expanded
    matches write disjoint ranges at increasing offsets. Cases: matches
    outside every range and empty ranges; overlapping ranges; d <= 0,
    len <= 0, off < 0 and off >= n among them, a match running past n and
    one reaching further back than 32 KiB; sources before byte 0."""
    import numpy as np
    rng = np.random.default_rng(seed)

    def matches(q, lo_d=1):
        out = []
        while True:
            q += int(rng.integers(0, 24))
            ln = 258 if rng.random() < 0.2 else int(rng.integers(3, 259))
            if q + ln > n - 300:
                return out, q
            d = int(rng.integers(lo_d, min(q, 32768) + 1)) if q >= lo_d \
                else lo_d
            out.append((q, d, ln))
            q += ln

    def case(name, ms, ranges):
        buf = rng.integers(0, 256, n, dtype=np.uint8)
        m = np.asarray(ms, np.int64).reshape(-1, 3).astype(np.int32)
        return (name, buf, m[:, 0].copy(), m[:, 1].copy(), m[:, 2].copy(),
                np.asarray([[a, b, 0, 0] for a, b in ranges], np.int32))

    ms, _ = matches(32768)
    T = len(ms)
    a, b, c = T // 4, T // 2, 3 * T // 4
    cases = [case("outside_and_empty_ranges", ms,
                  [(0, a), (a, a), (b, c), (c, c), (T + 5, T + 9)])]
    cases.append(case("overlapping_ranges", ms, [(0, b), (a, c), (a, T)]))
    bad = []
    for k, m in enumerate(ms):
        bad.append(m)
        if k % 7 == 3:
            q = m[0]
            bad += [(q, 0, 10), (q, -5, 10), (q, 4, 0), (q, 4, -3),
                    (-100, 4, 200), (n, 1, 10), (n + 5, 3, 4)]
    far = (n - 200, 40000, 258)            # runs past n, reaches far back
    bad.append(far)
    cases.append(case("bad_fields", bad, [(0, len(bad))]))
    low = [(q, q + int(rng.integers(1, 300)), int(rng.integers(3, 259)))
           for q in range(0, 2400, 300)]
    tail, _ = matches(2400)
    cases.append(case("source_before_zero", low + tail,
                      [(0, len(low) + len(tail))]))
    return cases


def adversarial_plans(seed: int = 0, cap: int = 1 << 17) -> list:
    """Synthetic plans of the v5 resolve (B5), each of `cap` positions:
    [(name, tok (L, 32) int32, outlen (L,) int32, P (cap,) int32, halo
    (32768,) uint8)] as numpy arrays; P is the plan the port's plain seed
    placement and butterfly (ops/expand5.py) give the tokens. Cases: chains
    of matches across many 16 KiB tile seams; runs of d = 1, then d = 3,
    over many tiles; d = 32768 matches into the halo; an invalid tail past
    the bytes produced (in every case but the last); exactly cap bytes
    produced."""
    import numpy as np
    import torch
    from jdeflate_tpu_torch.ops import expand5 as ex5
    rng = np.random.default_rng(seed)
    halo = rng.integers(0, 256, 32768, dtype=np.uint8)
    half = cap // 2 - 2048
    cases = []
    for name, toks in (
            ("chains_tile_seams", _chains(rng, cap - cap // 16, 32768)),
            ("d1_d3_runs", [_lit(9)] + [_match(258, 1)] * (half // 258)
             + [_match(258, 3)] * (half // 258)),
            ("d32768_halo", [_match(258, 32768)] * 200
             + _chains(rng, cap - 60000, 32768, 51600)),
            ("invalid_tail", _chains(rng, cap // 3, 4096)),
            ("exact_cap", _trim(_chains(rng, cap, 32768), cap))):
        tok, outlen = _pack_lanes(rng, toks)
        off, seed_ = ex5.slot_attrs(torch.from_numpy(tok),
                                    torch.from_numpy(outlen))
        P = ex5.propagate(ex5.seed_scatter_ref(off, seed_, cap))
        cases.append((name, tok, outlen, P.numpy(), halo))
    return cases


def adversarial_windows(meta, npe: int, ne: int, seed: int = 0) -> list:
    """Edge cases of the walk's checks (B1's epilogue: the exit chain, the
    lane offsets, the far-offset check), as changes to one real windowed
    batch's meta row [word_lo, hist, pe_word0(npe), pe_tab(npe),
    alanes(npe*1024), ll(ne*288), dl(ne*32)] (numpy int32, as
    codec/inflate.py::_walk_inputs unpacks it): [(name, meta, ne)]. Cases:
    hist 0 (every match reaching before the batch is far) and 2^30 (none
    is); every other pseudo-entry's tree given a new id holding the same
    tree (the chain then ends at each pseudo-entry instead of running into
    the next one's head); a pseudo-entry with no anchor; anchors moved one
    bit, among them a pseudo-entry's head; anchors 32-63 bits into their
    window (active for the chain, idle for the walk); a negative word of a
    pseudo-entry (its anchor base clamps at 0); the last pseudo-entry's
    words past the word window (its segment clamps, ROADMAP C5)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    PE = 1024
    meta = np.asarray(meta, np.int32)
    o_w, o_t, o_a = 2, 2 + npe, 2 + 2 * npe
    o_ll = o_a + npe * PE
    end = o_ll + ne * 320
    al = meta[o_a:o_ll].reshape(npe, PE)
    act = np.argwhere(al >= 0)
    cases = []

    def add(name, m, n_e=ne):
        cases.append((name, m, n_e))

    for name, h in (("hist_0", 0), ("hist_2p30", 1 << 30)):
        m = meta.copy()
        m[1] = h
        add(name, m)
    # a new tree id for every odd pseudo-entry: the trees, then ll and dl
    ll = meta[o_ll:o_ll + ne * 288].reshape(ne, 288)
    dl = meta[o_ll + ne * 288:end].reshape(ne, 32)
    tab = meta[o_t:o_t + npe]
    odd = np.arange(npe) % 2 == 1
    new_ll, new_dl = [ll], [dl]
    for p in np.nonzero(odd)[0]:
        new_ll.append(ll[tab[p]][None])
        new_dl.append(dl[tab[p]][None])
    relabel = tab.copy()
    relabel[odd] = ne + np.arange(int(odd.sum()))
    m = np.concatenate([meta[:o_t], relabel, meta[o_a:o_ll],
                        np.concatenate(new_ll).reshape(-1),
                        np.concatenate(new_dl).reshape(-1), meta[end:]])
    add("tree_relabel", m, ne + int(odd.sum()))
    live = [p for p in range(npe) if (al[p] >= 0).any()]
    runs = [p for p in live[1:] if p - 1 in live and tab[p - 1] == tab[p]]
    m = meta.copy()
    p = runs[len(runs) // 2] if runs else live[len(live) // 2]
    m[o_a + p * PE:o_a + (p + 1) * PE] = -1
    add("empty_pe", m)
    m = meta.copy()
    heads = [p * PE + int(np.argmax(al[p] >= 0)) for p in runs]
    pick = rng.choice(len(act), min(8, len(act)), replace=False)
    for i in [int(act[k][0]) * PE + int(act[k][1]) for k in pick] + heads[:2]:
        m[o_a + i] += 1
    add("anchor_shift", m)
    m = meta.copy()
    flat = m[o_a:o_ll]
    for k in rng.choice(len(act) - 1, min(16, len(act) - 1), replace=False):
        (p, j), (p2, j2) = act[k], act[k + 1]
        if p2 == p and j2 == j + 1:         # the next window's anchor
            flat[p * PE + j] = flat[p * PE + j2]
    add("late_anchors", m)
    m = meta.copy()
    m[o_w + live[len(live) // 3]] = -5
    add("negative_pe_word0", m)
    # the last pseudo-entry with anchors moved 2^16 words on, anchors and
    # all: only its segment start clamps into the word window
    m = meta.copy()
    p = live[-1]
    m[o_w + p] += 1 << 16
    row = m[o_a + p * PE:o_a + (p + 1) * PE]
    row[row >= 0] += 32 << 16
    add("segment_clamp", m)
    return cases


def symbol_anchors(raw: bytes, index: dict, dev: str) -> list:
    """Every 64th symbol's bit offset (ordinals 64, 128, ...) of each Huffman
    block, from the symbol lattice that the port's wavefront_decode and
    orbits compute over the whole stream on `dev`."""
    import numpy as np
    import torch
    from jdeflate_tpu_torch.ops import decode as dk
    from jdeflate_tpu_torch.stream import host_inflate as hi
    from jdeflate_tpu_torch.stream import native
    bits = list(index["block_bits"])
    recs = (native.parse_block_headers(raw, bits) if native.available()
            else [hi.parse_block_header(raw, b) for b in bits])
    nb = len(bits)
    nbits = len(raw) * 8
    w = np.zeros(len(raw) // 4 + 4, np.uint32)
    w.view(np.uint8)[:len(raw)] = np.frombuffer(raw, np.uint8)
    ll = np.zeros((nb, 288), np.int32)
    dl = np.zeros((nb, 32), np.int32)
    for k, r in enumerate(recs):
        if r.btype:
            ll[k, :len(r.litlen_lengths)] = r.litlen_lengths
            dl[k, :len(r.dist_lengths)] = r.dist_lengths
    ltab = dk.build_tables_batch(torch.from_numpy(ll).to(dev),
                                 *dk.litlen_attrs())
    dtab = dk.build_tables_batch(torch.from_numpy(dl).to(dev),
                                 *dk.dist_attrs())
    p = torch.arange(nbits, device=dev)
    bid = torch.searchsorted(torch.tensor(bits, device=dev), p,
                             right=True) - 1
    f = dk.wavefront_decode(torch.from_numpy(w.astype(np.int64)).to(dev), 0,
                            nbits, bid.clamp(0, nb - 1), ltab, dtab)[0]
    huff = [k for k in range(nb) if recs[k].btype]
    bb = list(index["block_bytes"]) + [index["n"]]
    P = dk.orbits(f, torch.tensor([recs[k].sym_bit_offset for k in huff],
                                  device=dev),
                  max(bb[k + 1] - bb[k] for k in huff) + 2).cpu().numpy()
    anchors = [None] * nb
    for row, k in zip(P, huff):
        a = row[dk.ANCHOR_STRIDE::dk.ANCHOR_STRIDE]
        anchors[k] = a[a < nbits]
    return anchors


def anchored_phase(data: bytes, card: str) -> dict:
    """Phase 9: the anchored decode with the v1 match expansion, on the
    level-6 stream of the port's own encoder re-indexed with symbol
    anchors. Returns the expand1 kernel's entry of the kernels line."""
    import torch
    from jdeflate_tpu_torch.codec import deflate as D
    from jdeflate_tpu_torch.codec import inflate as I
    from jdeflate_tpu_torch.ops import expand as ex

    part = data[:ANCH_MB << 20]
    raw, _ = D.RawDeflater(level=6, block_size=1 << 16, batch=16,
                           device="cuda").compress(part)
    dec = I.RawInflater(device="cuda", **BATCH)
    idx = dec.build_index(raw)
    t0 = time.perf_counter()
    anchors = symbol_anchors(raw, idx, "cuda")
    anchor_s = time.perf_counter() - t0
    index = {**{k: v for k, v in idx.items() if k != "win"},
             "anchors": anchors}
    bb = list(idx["block_bytes"]) + [idx["n"]]
    maxout = max(bb[k + 1] - bb[k] for k in range(len(anchors))
                 if anchors[k] is not None)

    # ---- 9a. main path
    dec.capture_calls = True
    ex.expand_matches.launches = 0
    out = dec.decompress(raw, index=index)
    torch.cuda.synchronize()
    launches = ex.expand_matches.launches
    stats, inputs = list(dec.last_stats), list(dec.last_calls)
    dec.capture_calls = False
    if out != part:
        fail("anchored decode differs from the corpus")
    kinds = [k for k, _, _ in stats]
    nanch = kinds.count("anchored")
    if set(kinds) - {"anchored", "stored"} or any(e for _, _, e in stats):
        fail(f"anchored decode: kinds {set(kinds)}, errs "
             f"{[e for _, _, e in stats if e]}")
    if nanch == 0 or launches != nanch or len(inputs) != nanch:
        fail(f"expand1 launches {launches}, captured {len(inputs)} != "
             f"{nanch} anchored batches")
    print(f"anchored main path: {len(part)} B encoded at level 6 by the "
          f"port -> {len(raw)} B, {len(idx['block_bits'])} blocks re-indexed "
          f"by build_index (largest Huffman block {maxout} B), "
          f"{sum(len(a) for a in anchors if a is not None)} symbol anchors "
          f"from the card's lattice in {anchor_s:.2f} s; {nanch} anchored + "
          f"{kinds.count('stored')} stored batches at err 0, expand1 "
          f"launches {launches}", flush=True)

    # ---- 9b. the kernel against its plain version on every batch's inputs,
    # the synthetic slots (adversarial_slots) and match lists
    # (adversarial_match_lists); then its times on the main path's inputs
    def held(buf, mats):
        return max_abs_err([ex.expand_matches(buf.clone(), *mats)],
                           [ex.expand_matches_ref(buf, *mats)])

    err = max(held(buf, mats) for buf, mats, _ in inputs)
    names = []
    for name, *slots, cap, first in adversarial_slots(seed=0, scale=1 << 21):
        b, mats, produced, _ = I._expand1_inputs(
            *(torch.from_numpy(x).cuda() for x in slots), cap,
            torch.from_numpy(first).cuda(), first.shape[0] - 1)
        err = max(err, held(b, mats))
        names.append(f"{name} {int(produced)} B")
    for name, *lst in adversarial_match_lists(seed=0):
        a = [torch.from_numpy(x).cuda() for x in lst]
        err = max(err, held(a[0], a[1:]))
        names.append(name)
    if err:
        fail(f"expand1 differs from its plain version: {err}")
    print(f"expand1 equals its plain version on all {len(inputs)} anchored "
          f"batches and the adversarial cases: {', '.join(names)} (max abs "
          "err 0)", flush=True)
    ms, plain, bound, nmat, done = [], [], [], [], []
    for buf, mats, produced in inputs:
        # expanding an expanded buffer gives it back (csrc/expand1.cu)
        done.append(ex.expand_matches(buf.clone(), *mats))
        ms.append(gpu_ms(lambda: ex.expand_matches(done[-1], *mats)))
        if not torch.equal(done[-1], ex.expand_matches_ref(buf, *mats)):
            fail("expand1: expanding an expanded buffer changed it")
        plain.append(gpu_ms(lambda: ex.expand_matches_ref(buf, *mats), 1))
        nm = int(mats[3][:, 1].max())
        nmat.append(nm)
        # least bytes: the halo and the bytes produced read once, the bytes
        # produced written once, each match's three words and each block's
        # range read once
        bound.append((I.HALO + 2 * int(produced) + 12 * nm
                      + 16 * mats[3].shape[0]) / HBM_BYTES_PER_S * 1e3)
    dev = device_ms(lambda: [ex.expand_matches(d, *c[1])
                             for d, c in zip(done, inputs)],
                    ("expand1_fill_kernel", "expand1_place_kernel",
                     "MatchFront"), 3) / len(inputs)
    print(f"expand1 ({card}): {_mean(ms):.3f} ms/launch x {launches} "
          f"(per batch {[round(x, 3) for x in ms]}); plain "
          f"{_mean(plain):.3f} ms; bound {_mean(bound):.5f} ms; "
          f"{sum(nmat)} matches, {sum(ms) * 1e6 / max(sum(nmat), 1):.1f} "
          f"ns/match; the kernels' device time {dev:.4f} ms/launch",
          flush=True)
    wall, span, walls = timed_runs(
        lambda: dec.decompress(raw, index=index),
        lambda o: o == part or fail("timed anchored decode differs"))
    print(f"anchored decode ({card}): wall {wall * 1e3:.1f} ms = "
          f"{len(part) / wall / 1e9:.4f} GB/s; device span "
          f"{span * 1e3:.1f} ms; runs {[round(w * 1e3, 1) for w in walls]} "
          f"ms; of the output, {card_share([dec.last_stats], len(part))}",
          flush=True)
    profile_run("anchored decode", lambda: dec.decompress(raw, index=index),
                span)
    return {"name": "expand1", "route": "cuda",
            "source": "jdeflate_tpu_torch/csrc/expand1.cu",
            "replaces": "jdeflate_tpu/ops/expand.py:43",
            "launches": launches, "max_abs_err": err,
            "ms": _mean(ms), "dev_ms": dev, "plain_ms": _mean(plain),
            "bound_ms": _mean(bound), "bound_by": "bytes",
            "library_ms": None}


def dense_phase(data: bytes, card: str) -> None:
    """Phase 10: the dense decode (an index with block offsets only) of a
    zlib level-6 stream; its stages are plain PyTorch, so the first batch of
    a 1 MiB stream is also held against the same stages on the CPU."""
    import torch
    from jdeflate_tpu_torch.codec import inflate as I

    def zraw(b):
        co = zlib.compressobj(6, zlib.DEFLATED, -15)
        return co.compress(b) + co.flush()

    part = data[:DENSE_MB << 20]
    raw = zraw(part)
    dec = I.RawInflater(device="cuda", **BATCH)
    idx = dec.build_index(raw)
    index = {k: v for k, v in idx.items() if k != "win"}
    planned = len(batch_offsets(dec, raw, index, "dense"))
    out = dec.decompress(raw, index=index)
    torch.cuda.synchronize()
    stats = list(dec.last_stats)
    if out != part:
        fail("dense decode differs from the corpus")
    kinds = [k for k, _, _ in stats]
    if set(kinds) - {"dense", "stored"} or "dense" not in kinds:
        fail(f"dense decode: unexpected batch kinds {set(kinds)}")
    errs = [e for k, _, e in stats if k == "dense"]
    first_bad = next((i for i, e in enumerate(errs) if e), None)
    print(f"dense main path: {len(part)} B -> {len(raw)} B zlib-6, "
          f"{planned} dense batches planned and run on the card; logged "
          f"{len(errs)} with errs {errs}; native re-decode "
          + ("none" if first_bad is None else
             f"from dense batch {first_bad} on (segmented orbits unconverged "
             "after the reference's 3 stitch passes, ROADMAP C8)"),
          flush=True)

    # card against CPU on the first batch of a 1 MiB stream
    small = part[:1 << 20]
    sraw = zraw(small)
    sidx = {k: v for k, v in dec.build_index(sraw).items() if k != "win"}
    res = []
    for dev in ("cuda", "cpu"):
        d2 = I.RawInflater(device=dev, max_batch_bits=1 << 22)
        o = d2.decompress(sraw, index=sidx)
        res.append((o, [(k, int(p), int(e)) for k, p, e in d2.last_stats]))
    if res[0] != res[1] or res[0][0] != small:
        fail(f"dense decode on the card differs from the CPU: "
             f"{res[0][1]} vs {res[1][1]}")
    print(f"dense decode of 1 MiB: card and CPU give equal bytes and "
          f"last_stats {res[0][1]}", flush=True)
    wall, span, walls = timed_runs(
        lambda: dec.decompress(raw, index=index),
        lambda o: o == part or fail("timed dense decode differs"))
    print(f"dense decode ({card}): wall {wall * 1e3:.1f} ms = "
          f"{len(part) / wall / 1e9:.4f} GB/s; device span "
          f"{span * 1e3:.1f} ms; runs {[round(w * 1e3, 1) for w in walls]} "
          f"ms; of the output, {card_share([dec.last_stats], len(part))}",
          flush=True)


def zstream_phase(data: bytes, gz: bytes, card: str) -> int:
    """Phase 11: ZStream on the card. Deflate: the corpus in writes of
    ZS_WRITE bytes, one sync flush midway, through ZStream("deflate",
    gzip, level 6, 64 KiB blocks in batches of 16); zlib must inflate it,
    its CRC32 must be zlib's, and it must come in one piece per segment
    with one match walk launch per non-empty segment. Inflate:
    the zlib-6 gzip stream and trailing garbage fed in 1 MiB chunks.
    Returns the match walk's launches on the deflate."""
    from jdeflate_tpu_torch.ops import lz77
    from jdeflate_tpu_torch.stream import zstrm
    kw = dict(level=6, block_size=1 << 16, batch=16)
    n, step, half = len(data), ZS_WRITE, len(data) // 2

    def deflate(src=data):
        pieces = []
        z = zstrm.ZStream("deflate", format="gzip", target_fn=pieces.append,
                          device="cuda", **kw)
        for pos in range(0, len(src), step):
            z.write(src[pos:pos + step])
            if pos < len(src) // 2 <= pos + step:
                z.flush(final=False)
        z.flush(final=True)
        return z, pieces

    # ---- 11a. deflate, counts zeroed just before
    secs = []
    lz77.match_walk.launches = 0
    with checksum_calls(secs):
        (z, pieces), wall, span = one_run(deflate)
    launches = lz77.match_walk.launches
    blob = b"".join(pieces)
    # segments: full ones of block_size x batch, the sync flush's cut after
    # the write that reaches half, and the final flush's (maybe empty) one
    seg = kw["block_size"] * kw["batch"]
    cut = min(n, ((half - 1) // step + 1) * step)
    nseg = -(-cut // seg) + (n - cut) // seg + 1
    nonempty = -(-cut // seg) + -(-(n - cut) // seg)
    if zlib.decompress(blob, 31) != data:
        fail("zlib does not inflate the ZStream deflate to the corpus")
    if (z.crc32, z.total_in, z.total_out) != (zlib.crc32(data), n,
                                              len(blob)):
        fail(f"ZStream counters: crc32 {z.crc32:#x} (zlib "
             f"{zlib.crc32(data):#x}), total_in {z.total_in}, total_out "
             f"{z.total_out} of {len(blob)}")
    if len(pieces) != nseg + 2 or launches != nonempty:
        fail(f"ZStream deflate: {len(pieces)} pieces for {nseg} "
             f"segments, match walk launches {launches} != {nonempty}")
    print(f"ZStream deflate main path: {n} B in writes of {step} B, a sync "
          f"flush at {cut} B -> {len(blob)} B gzip in {nseg} segments; "
          f"zlib inflates it; crc32 {z.crc32:#010x} = zlib's; match walk "
          f"launches {launches} = non-empty segments", flush=True)
    print(f"ZStream deflate ({card}): wall {wall * 1e3:.1f} ms = "
          f"{n / wall / 1e9:.4f} GB/s; device span {span * 1e3:.1f} ms; "
          f"{round_trips(secs, wall)}", flush=True)
    profile_slice("ZStream deflate",
                  lambda: deflate(data[:PROFILE_MB << 20]))

    stamp("11b")
    # ---- 11b. inflate of the zlib-6 gzip stream with trailing garbage
    garbage = b"TRAILING GARBAGE"

    def inflate(feed=gz + garbage):
        zi = zstrm.ZStream("inflate", format="gzip", device="cuda")
        out = bytearray()
        for i in range(0, len(feed), 1 << 20):
            zi.feed(feed[i:i + (1 << 20)])
            out += zi.read()
        out += zi.finish()
        return zi, bytes(out)

    isecs = []
    with checksum_calls(isecs):
        (zi, out), iwall, ispan = one_run(inflate)
    if out != data or zi.used_input != len(gz) or zi.unused_data != garbage:
        fail(f"ZStream inflate: bytes ok {out == data}, used_input "
             f"{zi.used_input} of {len(gz)}, unused {zi.unused_data[:32]!r}")
    print(f"ZStream inflate main path: {len(gz)} B gzip + {len(garbage)} B "
          f"of garbage fed in 1 MiB chunks -> {len(out)} B = the corpus; "
          f"used_input {zi.used_input} = the stream, unused_data = the "
          f"garbage", flush=True)
    print(f"ZStream inflate ({card}): wall {iwall * 1e3:.1f} ms = "
          f"{n / iwall / 1e9:.4f} GB/s; device span {ispan * 1e3:.1f} ms; "
          f"{round_trips(isecs, iwall)}", flush=True)
    profile_run("ZStream inflate", inflate, ispan)
    return launches


# The level-9 members cases of tests/test_torch_parallel.py::
# test_level9_member_index_matches_jax (ROADMAP C11, C16), name: (seed,
# sha256 of the 16 KiB, bytes each member's windowed batch produces). At
# seed 1064 a match crosses the second member's 2 KiB split seam at byte
# 6,144, the sub-block after it starts one byte late, and that member's
# batch produces 4,097 bytes; at seed 0 no match crosses a seam. The counts
# hold at the tests' capped probe depths and at the full ones.
L9_MEMBER_CASES = {
    "seam_exact": (
        0, "078235d829230189f6a4407f3975ae7d91835bfe689a54df5fbc5fbc6c8720b7",
        (4096, 4096)),
    "match_across_seam": (
        1064,
        "bcd0017cf2b45af75be52dde5594482a4bb12fb66753c4bbaa171dfa5dfdf09d",
        (4096, 4097)),
}
L9_WORDS = [b"the ", b"quick ", b"brown ", b"fox ", b"jumps ", b"over ",
            b"lazy ", b"dog ", b"pack ", b"my ", b"box ", b"with ",
            b"five ", b"dozen ", b"liquor ", b"jugs \n"]


def l9_member_data(seed: int) -> bytes:
    """The 16 KiB of a level-9 members case: ("text", "random") * 4 pieces
    of 2,048 B from np.random.default_rng(seed), by the rule of the "text"
    and "random" kinds of tests/conftest.py::make_corpus (copied: the tests'
    conftest imports jax)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    parts = []
    for kind in ("text", "random") * 4:
        if kind == "text":
            out = bytearray()
            while len(out) < 2048:
                out += L9_WORDS[int(rng.integers(len(L9_WORDS)))]
            parts.append(bytes(out[:2048]))
        else:
            parts.append(rng.integers(0, 256, 2048, dtype=np.uint8).tobytes())
    return b"".join(parts)


def l9_members_phase(card: str) -> None:
    """Phase 12f: the level-9 members cases (L9_MEMBER_CASES) on
    SHARD_RANKS ranks of cuda:0, 4 KiB blocks, 2 per shard: the card's blob
    and info must equal the port's CPU run's, decompress_members on the
    card must give the bytes back, and its per-batch record (kind, bytes
    produced, err) must equal the CPU decode's, with each member's batch
    stopping short of the member (C11) at the case's byte counts."""
    import hashlib
    import torch
    from jdeflate_tpu_torch.codec import inflate as I
    from jdeflate_tpu_torch.ops import expand2 as ex2
    from jdeflate_tpu_torch.ops import lz77
    from jdeflate_tpu_torch.ops import walk as wk
    from jdeflate_tpu_torch.parallel import shard
    kw = dict(level=9, block_size=4096, blocks_per_device=2, mode="members")
    enc = shard.ShardedDeflater(mesh=[torch.device("cuda", 0)] * SHARD_RANKS,
                                **kw)
    cenc = shard.ShardedDeflater(mesh=["cpu"] * SHARD_RANKS, **kw)
    for name, (seed, sha, produced) in L9_MEMBER_CASES.items():
        data = l9_member_data(seed)
        if hashlib.sha256(data).hexdigest() != sha:
            fail(f"level-9 members {name}: the bytes of seed {seed} are not "
                 f"the tests' ({hashlib.sha256(data).hexdigest()})")
        cblob, cinfo = cenc.compress(data)
        I.STATS_LOG.clear()
        if shard.decompress_members(cblob, cinfo, device="cpu") != data:
            fail(f"level-9 members {name}: the CPU decode differs")
        crec = list(I.STATS_LOG)
        lz77.match_walk.launches = 0
        (blob, info), ewall, _ = one_run(lambda: enc.compress(data))
        b3 = lz77.match_walk.launches
        if blob != cblob or canonical(info) != canonical(cinfo):
            fail(f"level-9 members {name}: the card's blob ({len(blob)} B) "
                 f"or info differs from the CPU's ({len(cblob)} B)")
        if [m[3]["block_bytes"] for m in info["members"]] != [[0, 4096]] * 2:
            fail(f"level-9 members {name}: the index lists "
                 f"{[m[3]['block_bytes'] for m in info['members']]}")
        wk.walk_checked.launches = 0
        ex2.expand_tokens.launches = 0
        I.STATS_LOG.clear()
        out, dwall, _ = one_run(
            lambda: shard.decompress_members(blob, info, device="cuda"))
        rec = list(I.STATS_LOG)
        dm = (wk.walk_checked.launches, ex2.expand_tokens.launches)
        if out != data:
            fail(f"level-9 members {name}: decompress_members on the card "
                 f"does not give the bytes back")
        if rec != crec or tuple(p for _, p, _ in rec) != produced or not all(
                k == "win" and p < 8192 and e for k, p, e in rec):
            fail(f"level-9 members {name}: the card's record {rec}, the "
                 f"CPU's {crec}, bytes produced expected {produced}")
        if b3 == 0 or dm != (len(rec), len(rec)):
            fail(f"level-9 members {name}: match walk launches {b3}, walk "
                 f"and expand2 launches {dm} for {len(rec)} batches")
        print(f"level-9 members {name} (seed {seed}, {len(data)} B, sha256 "
              f"{sha[:16]}; {card}): blob and info equal to the CPU's; "
              f"decompress_members gives the bytes; per-batch record {rec} "
              f"= the CPU's; launches match walk {b3}, walk and expand2 "
              f"{dm}; wall encode {ewall * 1e3:.1f} ms, decode "
              f"{dwall * 1e3:.1f} ms (one call each; the first case's "
              f"include the capture of their programs)", flush=True)


def sharded_phase(data: bytes, card: str) -> tuple:
    """Phase 12: ShardedDeflater on SHARD_RANKS ranks of cuda:0 at the
    reference's defaults (64 KiB blocks, 8 per shard). Members mode over
    the corpus, then decompress_members on the card; stream mode over the
    first SHARD_STREAM_MB MiB; a verify=True run there whose fault hook
    corrupts one shard; the level-9 members cases (l9_members_phase). The
    match walk is held to its plain version on the members encode's
    batches, the walk and the token expansion on the member decodes'.
    Returns (match walk launches by path, its max abs err,
    windowed batches of decompress_members, walk and expand2 max abs err,
    the results phase 13 is held to: {run: (blob, info, retries, wall,
    match walk launches)}).
    """
    import torch
    from jdeflate_tpu_torch.codec import deflate as D
    from jdeflate_tpu_torch.codec import inflate as I
    from jdeflate_tpu_torch.ops import expand2 as ex2
    from jdeflate_tpu_torch.ops import lz77
    from jdeflate_tpu_torch.ops import walk as wk
    from jdeflate_tpu_torch.parallel import shard
    mesh = [torch.device("cuda", 0)] * SHARD_RANKS
    launches = {}

    # ---- 12a. members mode over the corpus, counts zeroed just before
    enc = shard.ShardedDeflater(mesh=mesh, level=6)
    nshard = -(-len(data) // (enc.bl * enc.bpd))
    calls, secs = [], []
    lz77.match_walk.launches = 0
    with wrapped(D, "launch_batch",
                 after=lambda a, k, r, sec: calls.append(a)), \
            checksum_calls(secs):
        (blob, info), wall, span = one_run(lambda: enc.compress(data))
    launches["sharded_members"] = lz77.match_walk.launches
    if launches["sharded_members"] != nshard or len(calls) != nshard \
            or len(info["members"]) != nshard:
        fail(f"sharded members: {launches['sharded_members']} match walk "
             f"launches, {len(calls)} encodes, {len(info['members'])} "
             f"members for {nshard} shards")
    if gzip.decompress(blob) != data:
        fail("gzip does not decompress the sharded members blob")
    print(f"sharded members main path: {len(data)} B on {SHARD_RANKS} ranks "
          f"of cuda:0 -> {len(blob)} B in {nshard} gzip members; gzip "
          f"decompresses it; match walk launches "
          f"{launches['sharded_members']} = shards", flush=True)
    print(f"sharded members encode ({card}): wall {wall * 1e3:.1f} ms = "
          f"{len(data) / wall / 1e9:.4f} GB/s; device span "
          f"{span * 1e3:.1f} ms; {round_trips(secs, wall)}", flush=True)
    profile_slice("sharded members encode",
                  lambda: enc.compress(data[:PROFILE_MB << 20]))

    stamp("12b")
    # ---- 12b. decompress_members on the card, counts zeroed just before;
    # every member decode keeps its batches' device arguments
    rec = []

    def keep(dec, *_):
        dec.capture_calls = True

    def seen(a, k, r, sec):
        rec.append((a[1], k["index"], list(a[0].last_stats),
                    list(a[0].last_calls)))

    wk.walk_checked.launches = 0
    ex2.expand_tokens.launches = 0
    dsecs = []
    with wrapped(I.RawInflater, "decompress", before=keep, after=seen), \
            checksum_calls(dsecs):
        out, dwall, dspan = one_run(
            lambda: shard.decompress_members(blob, info, device="cuda"))
    dm = {"walk": wk.walk_checked.launches,
          "expand2": ex2.expand_tokens.launches}
    nwin = sum(len(r[3]) for r in rec)
    if out != data or len(rec) != nshard or nwin == 0 \
            or dm != {"walk": nwin, "expand2": nwin}:
        fail(f"decompress_members: bytes ok {out == data}, {len(rec)} "
             f"member decodes, launches {dm} for {nwin} windowed batches")
    errs = [(i, e) for i, r in enumerate(rec) for _, _, e in r[2] if e]
    print(f"decompress_members main path: {nshard} members, {nwin} "
          f"windowed batches, launches {dm}, erring batches {errs or 'none'}"
          f"; of the output, {card_share([r[2] for r in rec], len(data))}",
          flush=True)
    # the first member and each erring one: the CPU encode of its input
    # gives the card's member bytes, and the CPU decode of the member the
    # same batches, bytes produced and err decisions
    shard_bytes = enc.bl * enc.bpd
    held, cpu_errs = sorted({0} | {i for i, _ in errs}), []
    for i in held:
        part = data[i * shard_bytes:(i + 1) * shard_bytes]
        cblob, _ = shard.ShardedDeflater(mesh=["cpu"], level=6).compress(part)
        mstart, mlen = info["members"][i][:2]
        body, index, stats, _ = rec[i]
        cdec = I.RawInflater(device="cpu")
        cout = cdec.decompress(body, index=index)
        cpu_errs += [(i, e) for _, _, e in cdec.last_stats if e]
        if cblob != blob[mstart:mstart + mlen] or cout != part or [
                (k, p, e > 0) for k, p, e in cdec.last_stats] != [
                (k, p, e > 0) for k, p, e in stats]:
            fail(f"member {i}: the CPU gives other bytes or decisions "
                 f"({cdec.last_stats} against the card's {stats})")
    print(f"members {held}: the CPU encode gives the card's member bytes and "
          f"the CPU decode the same batches, bytes produced and err "
          f"decisions (errs on the CPU {cpu_errs or 'none'}; on the card the "
          f"token expansion's err is produced > out_cap, as in the "
          f"reference's kernel path, so the counts may differ)", flush=True)
    print(f"decompress_members ({card}): wall {dwall * 1e3:.1f} ms = "
          f"{len(data) / dwall / 1e9:.4f} GB/s; device span "
          f"{dspan * 1e3:.1f} ms; {round_trips(dsecs, dwall)}", flush=True)
    k = min((PROFILE_MB << 20) // (enc.bl * enc.bpd), nshard - 1)
    head = {**info, "members": info["members"][:k]}
    profile_slice("decompress_members", lambda: shard.decompress_members(
        blob[:info["members"][k][0]], head, device="cuda"))

    stamp("12c")
    # ---- 12c. B3 on the members encode's batches, B1 and B2 on the member
    # decodes' batches, against their plain versions
    b3_err = match_walk_checks(match_walk_inputs(calls), enc.bl,
                               synthetic=False)
    per, flat, offs = [], [], []
    o0 = 0
    plan = I.RawInflater(device="cuda")
    for body, index, _, mcalls in rec:
        offs += [(o0 + a, b) for a, b in batch_offsets(plan, body, index,
                                                       "win")]
        for words, metas, row, halo, npe, nb, oc, ww in mcalls:
            args = I._walk_inputs(words, metas[row], npe, nb, ww)
            e2 = int(I.decode_batch_windows_stacked(
                words, metas, row, halo, npe, nb, oc, ww)[2])
            per.append((args, halo, oc, e2))
            flat.append((words, metas, row, halo, npe, nb, oc, ww))
        o0 += index["n"]
    walk_err = walk_checks(per, flat, synthetic=False)
    exp_err = expand2_checks(per, offs, data, synthetic=False)
    print(f"the match walk equals its plain version on all {len(calls)} "
          f"sharded encode batches; the walk and the token expansion on all "
          f"{len(per)} member decode batches (max abs err "
          f"{max(b3_err, walk_err, exp_err)})", flush=True)

    stamp("12d")
    # ---- 12d. stream mode over the first SHARD_STREAM_MB MiB
    part = data[:SHARD_STREAM_MB << 20]
    senc = shard.ShardedDeflater(mesh=mesh, level=6, mode="stream")
    lz77.match_walk.launches = 0
    ssecs = []
    with checksum_calls(ssecs):
        (sblob, _), swall, sspan = one_run(lambda: senc.compress(part))
    launches["sharded_stream"] = lz77.match_walk.launches
    want = -(-len(part) // (senc.bl * senc.bpd))
    crc, isize = struct.unpack("<II", sblob[-8:])
    if gzip.decompress(sblob) != part or crc != zlib.crc32(part) \
            or isize != len(part) or launches["sharded_stream"] != want:
        fail(f"sharded stream: crc {crc:#x} (zlib {zlib.crc32(part):#x}), "
             f"isize {isize}, match walk launches "
             f"{launches['sharded_stream']} != {want}")
    print(f"sharded stream main path: {len(part)} B -> {len(sblob)} B, one "
          f"gzip stream; the combined crc32 {crc:#010x} = zlib's; match "
          f"walk launches {launches['sharded_stream']} = shards", flush=True)
    print(f"sharded stream encode ({card}): wall {swall * 1e3:.1f} ms = "
          f"{len(part) / swall / 1e9:.4f} GB/s; device span "
          f"{sspan * 1e3:.1f} ms; {round_trips(ssecs, swall)}", flush=True)
    profile_slice("sharded stream encode",
                  lambda: senc.compress(part[:PROFILE_MB << 20]))

    stamp("12e")
    # ---- 12e. verify=True, one shard corrupted: one retry, right output
    renc = shard.ShardedDeflater(mesh=mesh, level=6, verify=True)
    renc.fault_hook = corrupt_first(1)
    lz77.match_walk.launches = 0
    (rblob, rinfo), rwall, _ = one_run(lambda: renc.compress(part))
    launches["sharded_retry"] = lz77.match_walk.launches
    shard_bytes = renc.bl * renc.bpd
    if renc.retries != [(shard_bytes, shard_bytes)] \
            or launches["sharded_retry"] != want + 1:
        fail(f"fault retry: retries {renc.retries}, match walk launches "
             f"{launches['sharded_retry']} != {want + 1}")
    if gzip.decompress(rblob) != part or shard.decompress_members(
            rblob, rinfo, device="cuda") != part:
        fail("fault retry: the blob does not decode to the input")
    print(f"sharded fault retry: shard 1 corrupted, retries {renc.retries}, "
          f"match walk launches {launches['sharded_retry']} = {want} shards "
          f"+ 1 re-encode; gzip and decompress_members give the input; wall "
          f"{rwall * 1e3:.1f} ms", flush=True)
    stamp("12f")
    l9_members_phase(card)
    ref = {"12a": (blob, info, [], wall, launches["sharded_members"]),
           "12d": (sblob, None, [], swall, launches["sharded_stream"]),
           "12e": (rblob, rinfo, renc.retries, rwall,
                   launches["sharded_retry"])}
    return launches, b3_err, nwin, walk_err, exp_err, ref


def corrupt_first(rank: int):
    """A ShardedDeflater fault hook that zeroes bytes 4-11 of global rank
    `rank`'s first shard."""
    killed = []

    def hook(k, seg):
        if k == rank and not killed:
            killed.append(k)
            return seg[:4] + bytes(8) + seg[12:]
        return seg
    return hook


def canonical(x):
    """x with numpy arrays as lists, so that == compares infos exactly."""
    import numpy as np
    if isinstance(x, np.ndarray):
        return ("ndarray", x.tolist())
    if isinstance(x, dict):
        return {k: canonical(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(canonical(v) for v in x)
    return x


def gloo_threads() -> list:
    """The names of this process's gloo threads: the process group's run
    loops (pt_gloo_runloop) and its transport's event loop
    (gloo_tcp_loop)."""
    names = []
    for task in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{task}/comm") as f:
                name = f.read().strip()
        except OSError:         # the thread ended while listed
            continue
        if "gloo" in name:
            names.append(name)
    return sorted(names)


def spawn_workers(tmp: str, world: int, local: int, corpus: str,
                  runs: list) -> tuple:
    """Run `world` worker processes of this script (mp_worker), each with
    `local` ranks on cuda:0, in one gloo group, through `runs`. Every
    worker must exit 0 within MP_WORKER_S, with no gloo thread left after
    its teardown; on expiry all are killed. Returns (each worker's results,
    each worker's return code)."""
    import pickle
    os.makedirs(tmp)
    job = os.path.join(tmp, "job.pkl")
    with open(job, "wb") as f:
        pickle.dump({"corpus": corpus, "world": world, "local": local,
                     "init": os.path.join(tmp, "pg"), "runs": runs}, f)
    procs = []
    for r in range(world):
        with open(os.path.join(tmp, f"log{r}.txt"), "wb") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--mp-worker",
                 job, str(r)], stdout=log, stderr=subprocess.STDOUT,
                cwd=REPO))
    deadline = time.monotonic() + MP_WORKER_S
    expired = False
    for p in procs:
        try:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            expired = True
            break
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    bad = [r for r, p in enumerate(procs) if expired or p.returncode != 0]
    for r in bad:
        with open(os.path.join(tmp, f"log{r}.txt"), errors="replace") as f:
            print(f"---- worker {r} (exit {procs[r].returncode}):\n"
                  + f.read()[-3000:], flush=True)
    if bad:
        fail(f"multi-process workers {bad} of {world} "
             + ("timed out" if expired else "failed"))
    outs = []
    for r in range(world):
        with open(os.path.join(tmp, f"out{r}.pkl"), "rb") as f:
            outs.append(pickle.load(f))
    left = {r: o["threads"] for r, o in enumerate(outs) if o["threads"]}
    if left:
        fail(f"gloo threads left after the workers' teardown: {left}")
    return outs, [p.returncode for p in procs]


def mp_worker(job_path: str, rank: int) -> None:
    """One process of phase 13: join the gloo group, run the job's runs
    (mp_runs), then tear down in the order of parallel/mesh.py: the group
    ends with its last reference, before the interpreter finalizes. Writes
    {run: results, "threads": gloo threads left after the teardown} to
    out<rank>.pkl."""
    import datetime
    import pickle
    import torch.distributed as dist
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    dist.init_process_group(
        "gloo", init_method="file://" + job["init"],
        world_size=job["world"], rank=rank,
        timeout=datetime.timedelta(seconds=60))
    try:
        # every mesh, deflater and group reference is local to mp_runs
        res = mp_runs(job)
    finally:
        dist.destroy_process_group()
    res["threads"] = gloo_threads()
    with open(os.path.join(os.path.dirname(job_path), f"out{rank}.pkl"),
              "wb") as f:
        pickle.dump(res, f)


def mp_runs(job: dict) -> dict:
    """Phase 13's runs in one worker, on the default group: for each run a
    warm compress of the first round, the counts zeroed, a barrier, the
    timed compress, and B3 held to its plain version on this process's
    first round. Returns {run: results}."""
    import hashlib
    import torch
    import torch.distributed as dist
    from jdeflate_tpu_torch.codec import deflate as D
    from jdeflate_tpu_torch.ops import lz77
    from jdeflate_tpu_torch.parallel import mesh as M
    from jdeflate_tpu_torch.parallel import shard
    if any(m == "jax" or m.startswith(("jax.", "jdeflate_tpu."))
           or m == "jdeflate_tpu" for m in sys.modules):
        fail("the port pulled in jax or jdeflate_tpu")
    with open(job["corpus"], "rb") as f:
        data = f.read()
    world, local = job["world"], job["local"]
    group = dist.group.WORLD
    # one card per process is make_mesh's own layout; two ranks of cuda:0
    # in each process are given as devices with the group
    mesh = dict(mesh=M.make_mesh(group=group)) if local == 1 else dict(
        mesh=[torch.device("cuda", 0)] * local, group=group)
    res = {}
    for name, nbytes, mode, verify, hook_rank in job["runs"]:
        part = data[:nbytes]
        enc = shard.ShardedDeflater(**mesh, level=6, mode=mode,
                                    verify=verify)
        shard.ShardedDeflater(**mesh, level=6, mode=mode).compress(
            part[:world * local * enc.bl * enc.bpd])
        if hook_rank is not None:
            enc.fault_hook = corrupt_first(hook_rank)
        calls, gsecs, secs = [], [], []
        torch.cuda.synchronize()
        lz77.match_walk.launches = 0
        with wrapped(D, "launch_batch",
                     after=lambda a, k, r, sec: calls.append(a)
                     if len(calls) < local else None), \
                wrapped(dist, "all_gather_object",
                        after=lambda a, k, r, sec: gsecs.append(sec)), \
                checksum_calls(secs):
            dist.barrier(group)
            t0 = time.monotonic()
            blob, info = enc.compress(part)
            t1 = time.monotonic()
        launches = lz77.match_walk.launches
        b3_err = match_walk_checks(match_walk_inputs(calls), enc.bl,
                                   synthetic=False)
        res[name] = {"sha256": hashlib.sha256(blob).hexdigest(),
                     "blob": blob, "info": info, "retries": enc.retries,
                     "t0": t0, "t1": t1, "gather_s": gsecs,
                     "crc_s": secs, "launches": launches, "b3_err": b3_err}
    return res


def multiproc_phase(data: bytes, card: str, ref: dict) -> tuple:
    """Phase 13: ShardedDeflater over a gloo group of worker processes of
    this script, every rank on cuda:0, each run held to its phase-12 run
    on the same global rank count: 13a 4 processes x 1 rank, members over
    the corpus (12a); 13b 4 x 1, stream over the first SHARD_STREAM_MB MiB
    (12d); 13c 2 processes x 2 ranks, members with verify=True and 12e's
    fault hook on global rank 1 (12e). Returns (match walk launches summed
    over the workers, by run; the workers' max abs err of B3)."""
    import tempfile
    part = SHARD_STREAM_MB << 20
    launches, b3_err = {}, 0
    with tempfile.TemporaryDirectory() as tmp:
        corpus = os.path.join(tmp, "corpus.bin")
        with open(corpus, "wb") as f:
            f.write(data)
        t0 = time.perf_counter()
        outs4, rc4 = spawn_workers(os.path.join(tmp, "w4"), 4, 1, corpus, [
            ("13a", len(data), "members", False, None),
            ("13b", part, "stream", False, None)])
        t4 = time.perf_counter() - t0
        t0 = time.perf_counter()
        outs2, rc2 = spawn_workers(os.path.join(tmp, "w2"), 2, 2, corpus, [
            ("13c", part, "members", True, 1)])
        t2 = time.perf_counter() - t0
    print(f"multi-process spawns: 4 workers (13a, 13b) {t4:.1f} s, 2 "
          f"workers (13c) {t2:.1f} s, start-up and warm runs included; "
          f"return codes {rc4} (4x1), {rc2} (2x2); no gloo thread left "
          "after any worker's teardown", flush=True)
    for name, outs, layout, was, key in (
            ("13a", outs4, "4 processes x 1 rank", "12a", "multiproc_members"),
            ("13b", outs4, "4 processes x 1 rank", "12d", "multiproc_stream"),
            ("13c", outs2, "2 processes x 2 ranks", "12e",
             "multiproc_retry")):
        rblob, rinfo, rretries, rwall, want_l = ref[was]
        got = [o[name] for o in outs]
        launches[key] = sum(g["launches"] for g in got)
        b3_err = max([b3_err] + [g["b3_err"] for g in got])
        nbytes = len(data) if name == "13a" else part
        for r, g in enumerate(got):
            if g["blob"] != rblob or g["retries"] != rretries or (
                    rinfo is not None
                    and canonical(g["info"]) != canonical(rinfo)):
                fail(f"{name}: process {r}'s blob, info or retries differ "
                     f"from {was}'s (sha256 {g['sha256'][:16]}, retries "
                     f"{g['retries']} against {rretries})")
        if launches[key] != want_l:
            fail(f"{name}: {launches[key]} match walk launches over the "
                 f"processes, {was} {want_l}")
        if name == "13b":
            crc, isize = struct.unpack("<II", got[0]["blob"][-8:])
            if crc != zlib.crc32(data[:part]) or isize != part:
                fail(f"13b: crc {crc:#x} != zlib's")
        wall = max(g["t1"] for g in got) - min(g["t0"] for g in got)
        print(f"{name} multi-process {layout} of cuda:0, "
              f"{'stream' if name == '13b' else 'members'}"
              f"{', verify, fault on global rank 1' if name == '13c' else ''}"
              f": {nbytes} B -> {len(got[0]['blob'])} B; every process's "
              f"blob (sha256 {got[0]['sha256'][:16]}), info and retries "
              f"{got[0]['retries']} = {was}'s; match walk launches "
              f"{[g['launches'] for g in got]} = {launches[key]}"
              + (f"; crc32 {crc:#010x} = zlib's" if name == "13b" else ""),
              flush=True)
        ms = [[round(x * 1e3, 1) for x in (
            g["t1"] - g["t0"] - sum(g["gather_s"]), *g["gather_s"])]
            for g in got]
        print(f"{name} ({card}): wall {wall * 1e3:.1f} ms from the barrier "
              f"to the last process's return ({was}, one process: "
              f"{rwall * 1e3:.1f} ms); per process, encode "
              f"{[m[0] for m in ms]} ms, input check {[m[1] for m in ms]} "
              f"ms, gather {[m[2] for m in ms]} ms (the collectives' waits "
              "included); "
              + "; ".join(f"process {r}: "
                          + round_trips(g["crc_s"], g["t1"] - g["t0"])
                          for r, g in enumerate(got)), flush=True)
    print(f"the match walk equals its plain version on every worker's first "
          f"round (max abs err {b3_err})", flush=True)
    return launches, b3_err


def levels_phase(data: bytes, card: str) -> tuple:
    """Phase 14: the encoder at levels 1 (greedy, 2 probes) and 9 (lazy,
    512 probes, 2 KiB split chunks, two-queue trees) on the card, over the
    first LEVELS_KB KiB in 64 KiB blocks, one batch of 4: the stream and
    index must equal the CPU's, zlib must inflate it, and the match walk
    (B3) is held to its plain version on every batch of both levels.
    Returns (B3 launches by level, B3's max abs err)."""
    import torch
    from jdeflate_tpu_torch.codec import deflate as D
    from jdeflate_tpu_torch.ops import lz77
    part = data[:LEVELS_KB << 10]
    kw = dict(block_size=1 << 16, batch=4)
    launches, err = {}, 0
    for level in (1, 9):
        enc = D.RawDeflater(level=level, device="cuda", **kw)
        enc.capture_calls = True
        lz77.match_walk.launches = 0
        t0 = time.perf_counter()
        raw, idx = enc.compress(part)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        n = lz77.match_walk.launches
        calls, statics = list(enc.last_calls), enc.call_statics
        t0 = time.perf_counter()
        craw, cidx = D.RawDeflater(level=level, device="cpu",
                                   **kw).compress(part)
        cpu_s = time.perf_counter() - t0
        if raw != craw:
            k = next((i for i, (a, b) in enumerate(zip(raw, craw)) if a != b),
                     min(len(raw), len(craw)))
            fail(f"level {level}: the card's stream ({len(raw)} B) differs "
                 f"from the CPU's ({len(craw)} B) first at byte {k}")
        if canonical(idx) != canonical(cidx):
            fail(f"level {level}: the card's index differs from the CPU's")
        if zlib.decompress(raw, -15) != part:
            fail(f"level {level}: zlib does not inflate the card's stream")
        if n != len(calls) or n == 0:
            fail(f"level {level}: match walk launches {n} != "
                 f"{len(calls)} batches")
        win = match_walk_inputs([(*c, *statics) for c in calls])
        err = max(err, match_walk_checks(win, statics[0], synthetic=False))
        launches[f"level{level}_{LEVELS_KB}KiB"] = n
        print(f"level {level} ({card}): {len(part)} B -> {len(raw)} B on the "
              f"card ({card_s:.2f} s, first call) and on the CPU "
              f"({cpu_s:.2f} s), byte-equal with equal indexes; zlib "
              f"inflates it; match walk launches {n}, equal to its plain "
              f"version on every batch (max abs err {err})", flush=True)
    return launches, err


def program_phase(data: bytes, card: str, ext_enc: int) -> dict:
    """Phase 15: the captured encode and checksum programs
    (jdeflate_tpu_torch/codec/program.py, the card's default, which every
    earlier phase ran) against the eager path (program.eager()), the
    program cache cleared first. RawDeflater at levels 1 and 6 over the
    first PROGRAM_MB MiB and level 9 over the first PROGRAM_L9_MB MiB (64
    KiB blocks in batches of 16), ZStream("deflate") in ZS_WRITE-byte
    writes and ShardedDeflater members and stream on SHARD_RANKS ranks of
    cuda:0 over the first PROGRAM_MB MiB: in each, the stream (blob), the
    index and its window anchors are byte-equal (sha256) between the two
    paths, and so are the match walk's launches (replays count theirs).
    Every encode batch is two programs, the match stage and the coding
    stages: at each level the first batch's two-stage handle equals
    encode_batch in one eager call (the clock stamps at the end of its meta
    left out), and each level prints its captured run's four stage
    counters (STAGE_COUNTERS, the request record) per batch.
    Phase 1 of RawDeflater (launch) runs under
    torch.cuda.set_sync_debug_mode("error") in both paths, after a warm
    run. Printed: each path's wall and device span, the graphs captured and
    their capture time (in the first run), the device busy share of the
    level-6 encode of PROFILE_MB MiB in both paths, and adler32's time
    per call on 1 MiB and 8 MiB in both paths. At each level the exact
    extension kernel (csrc/lz77extend.cu) must equal its plain loop
    (extend_top_ref) on the card on the first batch's stage-1 inputs, and
    its time per launch (CUDA events over back-to-back launches), device
    time (profiler), bound (rows, plen and pdist in, the result out, over
    3.35 TB/s) and the plain loop's time are printed. Each level's record
    must count encode.scan_kernel equal to the running scan kernel's
    launches, 7 a batch at levels 1 and 6 and 9 at level 9. Returns B3's,
    the match probe kernel's and the tree kernel's launches by captured run
    (the tree kernel's by level only), the exact extension kernel's row:
    `launches` the main path's (phase 7's level-6 gzip encode, `ext_enc`:
    one a batch), its launches by captured run in path_launches beside
    it, and the running scan kernel's launches by captured run."""
    import hashlib
    import torch
    from jdeflate_tpu_torch import trace
    from jdeflate_tpu_torch.codec import deflate as D
    from jdeflate_tpu_torch.codec import program
    from jdeflate_tpu_torch.ops import checksum as cs
    from jdeflate_tpu_torch.ops import huffman, lz77, scan
    from jdeflate_tpu_torch.parallel import shard
    from jdeflate_tpu_torch.stream import zstrm

    def digest(x) -> str:
        b = x if isinstance(x, bytes) else repr(canonical(x)).encode()
        return hashlib.sha256(b).hexdigest()[:16]

    counted = (lz77.match_walk, lz77.match_probe, huffman.code_lengths,
               lz77.extend_top, scan.running)

    def both(name, fn, out_digest):
        """fn() captured (a first run that captures, then a timed one) and
        eager (a warm run, then a timed one); fail unless the two give the
        same digest and the same launches of the match walk, the match
        probe, the tree kernel, the exact extension kernel and the running
        scan kernel. Returns the captured run's launches of the five."""
        st0, c0 = dict(program.stats), capture_s()
        _, first, _ = one_run(fn)
        caps = program.stats["captures"] - st0["captures"]
        cap_s = capture_s() - c0
        for w in counted:
            w.launches = 0
        res, wall, span = one_run(fn)
        n_cap = tuple(w.launches for w in counted)
        with program.eager():
            fn()
            for w in counted:
                w.launches = 0
            eres, ewall, espan = one_run(fn)
            n_eager = tuple(w.launches for w in counted)
        dg, edg = out_digest(res), out_digest(eres)
        if dg != edg or n_cap != n_eager:
            fail(f"phase 15 {name}: captured {dg} ({n_cap} match walk, "
                 f"probe, tree, extension and scan launches) != eager {edg} "
                 f"({n_eager})")
        print(f"program {name} ({card}): captured wall {wall * 1e3:.1f} ms, "
              f"span {span * 1e3:.1f} ms; eager wall {ewall * 1e3:.1f} ms, "
              f"span {espan * 1e3:.1f} ms ({ewall / wall:.2f}x); first "
              f"captured run {first * 1e3:.1f} ms with {caps} graphs "
              f"captured, first calls (eager run and capture) "
              f"{cap_s * 1e3:.1f} ms; sha256 {dg} equal; match "
              f"walk, probe, tree, extension and scan launches {n_cap} in "
              f"both",
              flush=True)
        return n_cap

    program.clear()
    launches, probes, trees, ext_args, scans = {}, {}, {}, {}, {}
    exts = {"gzip_encode": ext_enc}
    ext_row = {"name": "lz77extend", "route": "cuda",
               "source": "jdeflate_tpu_torch/csrc/lz77extend.cu",
               "replaces": None, "levels": [1, 6, 9], "launches": ext_enc,
               "path_launches": exts, "check_launches": 0,
               "max_abs_err": 0, "ms": [], "dev_ms": [], "plain_ms": [],
               "bound_ms": [], "selected": [], "bound_by": "bytes",
               "library_ms": None}
    kw = dict(block_size=1 << 16, batch=16)
    for level, mb in ((1, PROGRAM_MB), (6, PROGRAM_MB), (9, PROGRAM_L9_MB)):
        part = data[:mb << 20]
        enc = D.RawDeflater(level=level, device="cuda", **kw)
        key = f"program_level{level}"
        launches[key], probes[key], trees[key], exts[key], scans[key] = both(
            f"RawDeflater level {level}, {mb} MiB",
            lambda: enc.compress(part),
            lambda r: (digest(r[0]), digest(r[1]), digest(r[1]["win"])))
        enc.capture_calls = True
        enc.compress(part)
        stage = trace.last_request()["counters"]
        enc.capture_calls = False
        statics = enc.call_statics
        two = D.unstamped(D.launch_batch(*enc.last_calls[0], *statics))
        with program.eager():
            one = D.unstamped(D.batch_handle(D.encode_batch(
                *enc.last_calls[0], *statics)))
        if not all(torch.equal(a, b) for a, b in zip(two, one, strict=True)):
            fail(f"level {level}: the two-stage batch differs from "
                 f"encode_batch in one call")
        if not all(stage.get(k, 0) > 0 for k in STAGE_COUNTERS):
            fail(f"level {level}: no stage times in the record: {stage}")
        if stage.get("encode.match_kernel") != probes[key]:
            fail(f"level {level}: encode.match_kernel "
                 f"{stage.get('encode.match_kernel')} != the probe kernel's "
                 f"{probes[key]} launches")
        if stage.get("encode.tree_kernel", 0) != trees[key] \
                or (trees[key] > 0) != (level >= 8):
            fail(f"level {level}: encode.tree_kernel "
                 f"{stage.get('encode.tree_kernel')}, the tree kernel's "
                 f"launches {trees[key]}")
        if stage.get("encode.ext_kernel") != exts[key] \
                or exts[key] != len(enc.last_calls):
            fail(f"level {level}: encode.ext_kernel "
                 f"{stage.get('encode.ext_kernel')}, the extension kernel's "
                 f"launches {exts[key]}, {len(enc.last_calls)} batches")
        per_batch = 9 if level >= 8 else 7
        if stage.get("encode.scan_kernel") != scans[key] \
                or scans[key] != per_batch * len(enc.last_calls):
            fail(f"level {level}: encode.scan_kernel "
                 f"{stage.get('encode.scan_kernel')}, the scan kernel's "
                 f"launches {scans[key]}, {len(enc.last_calls)} batches of "
                 f"{per_batch}")
        ext_args[level] = ext_stage_inputs(enc.last_calls[0], statics)
        ext_check(ext_row, level, ext_args[level])
        nb = len(enc.last_calls)
        print(f"level {level}: two-stage batch equals encode_batch in one "
              f"call; captured run, ms a batch of {nb}: "
              + ", ".join(f"{k} {stage[k] / 1e6 / nb:.3f}"
                          for k in STAGE_COUNTERS), flush=True)
        # Phase 1 alone, warm, with every synchronising CUDA call an error
        for mode in ("captured", "eager"):
            with program.eager() if mode == "eager" \
                    else contextlib.nullcontext():
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    launched = enc.launch(part)
                except RuntimeError as e:
                    fail(f"level {level} {mode}: Phase 1 synchronised: {e}")
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                if digest(enc.finish(launched)[0]) != digest(
                        enc.compress(part)[0]):
                    fail(f"level {level} {mode}: launch + finish differs")
        print(f"level {level}: Phase 1 (launch) made no synchronising call "
              f"under set_sync_debug_mode('error'), captured and eager",
              flush=True)
    part = data[:PROGRAM_MB << 20]
    enc = D.RawDeflater(level=6, device="cuda", **kw)
    profile_slice("program: level-6 encode, captured",
                  lambda: enc.compress(part[:PROFILE_MB << 20]))
    with program.eager():
        profile_slice("program: level-6 encode, eager",
                      lambda: enc.compress(part[:PROFILE_MB << 20]))
    ext_timing(ext_row, ext_args, card)

    def zdeflate():
        pieces = []
        z = zstrm.ZStream("deflate", format="gzip", target_fn=pieces.append,
                          device="cuda", level=6, **kw)
        for pos in range(0, len(part), ZS_WRITE):
            z.write(part[pos:pos + ZS_WRITE])
        z.flush(final=True)
        return b"".join(pieces), z.crc32
    launches["program_zstream"], probes["program_zstream"], _, \
        exts["program_zstream"], scans["program_zstream"] = both(
        f"ZStream deflate, {PROGRAM_MB} MiB", zdeflate,
        lambda r: (digest(r[0]), r[1] == zlib.crc32(part)
                   or fail("phase 15 ZStream: crc32 differs from zlib's")))
    mesh = [torch.device("cuda", 0)] * SHARD_RANKS
    for mode in ("members", "stream"):
        senc = shard.ShardedDeflater(mesh=mesh, level=6, mode=mode)
        key = f"program_sharded_{mode}"
        launches[key], probes[key], _, exts[key], scans[key] = both(
            f"sharded {mode}, {PROGRAM_MB} MiB", lambda: senc.compress(part),
            lambda r: (digest(r[0]), digest(r[1])))

    for mb in (1, 8):
        buf = data[:mb << 20]
        if cs.adler32(buf) != zlib.adler32(buf):
            fail(f"phase 15: adler32 of {mb} MiB differs from zlib's")
        per = []
        for ctx in (contextlib.nullcontext, program.eager):
            with ctx():
                cs.adler32(buf)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(5):
                    cs.adler32(buf)
                per.append((time.perf_counter() - t0) / 5 * 1e3)
        print(f"adler32 per call on {mb} MiB of bytes ({card}): captured "
              f"{per[0]:.3f} ms, eager {per[1]:.3f} ms", flush=True)
    print(f"program cache: {len(program._programs)} programs, "
          f"{program.stats['captures']} captures, first calls (eager run "
          f"and capture) {capture_s():.1f} s, "
          f"{program.stats['replays']} replays this run", flush=True)
    return launches, probes, trees, ext_row, scans


def ext_stage_inputs(args, statics) -> tuple:
    """The arguments (ext, plen, pdist, topd) that one encode batch's match
    stage hands lz77.extend_top, recorded in an eager run of the stage with
    the plain loop in the kernel's place (the kernel counts its launches
    through its module name, so it cannot be wrapped)."""
    from jdeflate_tpu_torch.codec import deflate as D
    from jdeflate_tpu_torch.codec import program
    from jdeflate_tpu_torch.ops import lz77

    rec = []

    def keep(*a):
        rec.append(tuple(x.clone() for x in a))
        return lz77.extend_top_ref(*a)
    real = lz77.extend_top
    lz77.extend_top = keep
    try:
        with program.eager():
            D.encode_batch(*args, *statics, stage="match")
    finally:
        lz77.extend_top = real
    if len(rec) != 1:
        fail(f"the match stage called extend_top {len(rec)} times, not once")
    return rec[0]


def ext_check(row: dict, level: int, args: tuple) -> None:
    """The exact extension kernel against its plain loop on one batch's
    stage-1 inputs `args`; the share of positions it selects into `row`."""
    import torch
    from jdeflate_tpu_torch.ops import lz77

    _, plen, pdist, topd = args
    before = lz77.extend_top.launches
    got = lz77.extend_top(*args)
    want = lz77.extend_top_ref(*args)
    row["check_launches"] += lz77.extend_top.launches - before
    err = max_abs_err((got,), (want,))
    row["max_abs_err"] = max(row["max_abs_err"], err)
    if err:
        fail(f"exact extension at level {level}: the kernel differs from "
             f"the plain loop by {err}")
    sel = int(((plen > 0) & torch.isin(pdist, topd)).sum())
    row["selected"].append(sel / plen.numel())


def ext_timing(row: dict, args_by_level: dict, card: str) -> None:
    """The exact extension kernel's time per launch (CUDA events over
    back-to-back launches), device time (device_ms), bound and its plain
    loop's time on each level's stage-1 inputs, into `row`."""
    from jdeflate_tpu_torch.ops import lz77

    for (level, args), sel in zip(args_by_level.items(), row["selected"]):
        ext, plen, _, topd = args
        row["ms"].append(gpu_ms(lambda: lz77.extend_top(*args), 20))
        row["dev_ms"].append(device_ms(lambda: lz77.extend_top(*args),
                                       ("extend_kernel",), 10))
        row["plain_ms"].append(gpu_ms(lambda: lz77.extend_top_ref(*args), 1))
        moved = ext.numel() + plen.numel() * 8 * 3 + topd.numel() * 8
        row["bound_ms"].append(moved / HBM_BYTES_PER_S * 1e3)
        print(f"lz77extend ({card}) level {level} (T {topd.numel()}) on "
              f"{tuple(ext.shape)} rows: = the plain loop; "
              f"{row['ms'][-1]:.4f} ms/launch, device "
              f"{row['dev_ms'][-1]:.4f} ms/launch, bound "
              f"{row['bound_ms'][-1]:.4f} ms "
              f"({100 * row['bound_ms'][-1] / row['dev_ms'][-1]:.1f}% of "
              f"the roofline); plain loop {row['plain_ms'][-1]:.2f} ms; "
              f"{100 * sel:.1f}% of positions selected", flush=True)


def decode_program_phase(data: bytes, raw: bytes, idx: dict,
                         card: str) -> dict:
    """Phase 16: the decode programs (codec/inflate.py's windowed, anchored
    and dense batches as codec/program.py programs, the card's default,
    which every earlier phase ran) against program.eager(), the program
    cache cleared first: engine 2 and v5 (JDT_EXPAND=5) on the 32 MiB
    zlib-6 stream, and on the zlib-6 stream of its first ANCH_MB MiB the
    anchored decode (symbol anchors from symbol_anchors; its blocks over 64
    KiB take the plain assembly) and the dense decode. In each branch the
    output's sha256, last_stats, the first erring batch (where the native
    decoder takes over) and every kernel's launches (a replay adds its own,
    program.COUNTED) are equal between the two paths. Printed: walls and
    spans, the programs, captures, capture seconds and replays. Then the
    engine-2 decode's host time by phase over 3 captured runs after a warm
    one, from each run's request record (trace.last_request(): the spans
    decode.plan, decode.upload, decode.launch, decode.finish and the native
    re-decode inside it, decode.native). Returns each captured run's kernel
    launches, by path."""
    import collections
    import hashlib
    import torch
    from jdeflate_tpu_torch.codec import inflate as I
    from jdeflate_tpu_torch.codec import program
    from jdeflate_tpu_torch.ops import expand as ex
    from jdeflate_tpu_torch.ops import expand2 as ex2
    from jdeflate_tpu_torch.ops import expand5 as ex5
    from jdeflate_tpu_torch import trace
    from jdeflate_tpu_torch.ops import walk as wk

    counted = {"walk": wk.walk_checked, "expand2": ex2.expand_tokens,
               "expand5_seed": ex5.seed_plane,
               "expand5_resolve": ex5.resolve, "expand1": ex.expand_matches}

    def zero():
        for f in counted.values():
            f.launches = 0

    def launches():
        return {k: f.launches for k, f in counted.items() if f.launches}

    def first_bad(stats):
        return next((i for i, (_, _, e) in enumerate(stats) if e), None)

    part = data[:ANCH_MB << 20]
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    raw8 = co.compress(part) + co.flush()
    dec = I.RawInflater(device="cuda", **BATCH)
    idx8 = dec.build_index(raw8)
    plain8 = {k: v for k, v in idx8.items() if k != "win"}
    branches = (
        ("engine2", "engine 2, 32 MiB", raw, idx, data, "2"),
        ("v5", "v5, 32 MiB", raw, idx, data, "5"),
        ("anchored", f"anchored, {ANCH_MB} MiB", raw8,
         {**plain8, "anchors": symbol_anchors(raw8, idx8, "cuda")}, part,
         "2"),
        ("dense", f"dense, {ANCH_MB} MiB", raw8, plain8, part, "2"))
    program.clear()
    found = {}
    for key, name, r, index, want, engine in branches:
        def fn():
            return dec.decompress(r, index=index)
        os.environ["JDT_EXPAND"] = engine
        try:
            st0, c0 = dict(program.stats), capture_s()
            _, first, _ = one_run(fn)
            caps = program.stats["captures"] - st0["captures"]
            cap_s = capture_s() - c0
            grew = program.stats["pool_growth"] - st0["pool_growth"]
            reps = program.stats["replays"]
            zero()
            out, wall, span = one_run(fn)
            reps = program.stats["replays"] - reps
            n_cap, stats = launches(), list(dec.last_stats)
            with program.eager():
                fn()
                zero()
                eout, ewall, espan = one_run(fn)
                n_eager, estats = launches(), list(dec.last_stats)
        finally:
            os.environ.pop("JDT_EXPAND", None)
        dg = hashlib.sha256(out).hexdigest()[:16]
        edg = hashlib.sha256(eout).hexdigest()[:16]
        if out != want or dg != edg:
            fail(f"phase 16 {name}: captured {dg}, eager {edg}, corpus "
                 f"{out == want}")
        if stats != estats or first_bad(stats) != first_bad(estats):
            fail(f"phase 16 {name}: last_stats differ: captured "
                 f"{stats} eager {estats}")
        if n_cap != n_eager:
            fail(f"phase 16 {name}: launches captured {n_cap} != eager "
                 f"{n_eager}")
        found[key] = n_cap
        kinds = collections.Counter(k for k, _, _ in stats)
        print(f"program decode {name} ({card}): captured wall "
              f"{wall * 1e3:.1f} ms, span {span * 1e3:.1f} ms; eager wall "
              f"{ewall * 1e3:.1f} ms, span {espan * 1e3:.1f} ms "
              f"({ewall / wall:.2f}x); first captured run "
              f"{first * 1e3:.1f} ms with {caps} programs captured, first "
              f"calls (eager run and capture) {cap_s * 1e3:.1f} ms, "
              f"growing their pools by {grew} B; "
              f"{reps} replays in the timed run; "
              f"{len(program._programs)} programs cached "
              f"({program.stats['bytes']} B, {program.stats['evictions']} "
              f"evicted so far); sha256 {dg} equal; last_stats equal "
              f"({dict(kinds)}; first erring batch {first_bad(stats)}); "
              f"launches {n_cap} in both", flush=True)

    # the engine-2 decode's host time by phase, from its request records
    secs = collections.defaultdict(float)
    walls = []
    dec.decompress(raw, index=idx)      # its programs back in the cache
    for _ in range(3):
        got, w, _ = one_run(lambda: dec.decompress(raw, index=idx))
        if got != data:
            fail("phase 16: the timed engine-2 decode differs")
        walls.append(w)
        for k, v in trace.last_request()["spans"].items():
            secs[k] += v
    ms = collections.defaultdict(float, {k: v / 3 * 1e3
                                         for k, v in secs.items()})
    wall = statistics.mean(walls) * 1e3
    print(f"engine-2 decode of {len(data)} B, host time by phase ({card}), "
          f"mean of 3 warm captured runs: decode.plan "
          f"{ms['decode.plan']:.1f} ms; decode.upload "
          f"{ms['decode.upload']:.1f} ms; decode.launch "
          f"{ms['decode.launch']:.1f} ms; readback with _fill (decode.finish "
          f"less decode.native) "
          f"{ms['decode.finish'] - ms['decode.native']:.1f} ms; native "
          f"re-decode (decode.native) {ms['decode.native']:.1f} ms; "
          f"decode.inflater {ms['decode.inflater']:.1f} ms; wall "
          f"{wall:.1f} ms (runs {[round(x * 1e3, 1) for x in walls]})",
          flush=True)
    return found


def walk_checks(per: list, calls: list, synthetic: bool = True) -> int:
    """Kernel B1 (csrc/walk.cu) against its plain version: on every
    windowed batch, tokens and meta against walk_windows_ref and outlen,
    laneoff and err against walk_checked_ref; then (synthetic) the
    adversarial changes of adversarial_windows to three batches (the first,
    the one with the most pseudo-entries, the one whose segment clamps).
    per: (walk args, halo, out_cap, engine-2 err) of each batch; calls: the
    captured device arguments. Returns the max abs err."""
    import torch
    from jdeflate_tpu_torch.codec import inflate as I
    from jdeflate_tpu_torch.ops import walk as wk

    def held(args):
        return max_abs_err(wk.walk_checked(*args), wk.walk_checked_ref(*args))

    err = 0
    for args, _, _, _ in per:
        err = max(err, held(args))
    if err:
        fail(f"walk kernel differs from its plain version: {err}")
    if not synthetic:
        return err
    pick = {0, max(range(len(calls)), key=lambda i: calls[i][4])}
    pick |= {i for i, c in enumerate(calls) if clamps_segment(c)}
    names = set()
    for i in sorted(pick):
        words, metas, row, _, npe, nb, _, ww = calls[i]
        for name, m, ne in adversarial_windows(metas[row].cpu().numpy(), npe,
                                               nb, seed=i):
            args = I._walk_inputs(words, torch.from_numpy(m).cuda(), npe, ne,
                                  ww)
            e = held(args)
            if e:
                fail(f"walk kernel, adversarial window {name} of batch {i}: "
                     f"{e} max abs err")
            names.add(name)
    print(f"walk kernel equals its plain version on all {len(per)} windowed "
          f"batches (tokens and meta; outlen, laneoff and err) and on the "
          f"adversarial windows of batches {sorted(pick)}: "
          f"{', '.join(sorted(names))} (max abs err 0)", flush=True)
    return err


def expand2_checks(per: list, offs: list, data: bytes,
                   synthetic: bool = True) -> int:
    """Kernel B2 (csrc/expand.cu) against its plain version and the corpus.
    per: (walk args, halo, out_cap, engine-2 err) of each windowed batch;
    offs: each batch's (output offset, length). On every batch at err 0,
    behind the corpus's own 32 KiB: the card's bytes equal the plain
    version's and the corpus slice; then (synthetic) literal-run
    annotation changes no byte, three runs on the largest batch give the
    same bytes, and every synthetic adversarial stream (2 MiB each) equals
    the plain version. Returns the max abs err."""
    import torch
    from jdeflate_tpu_torch.ops import expand2 as ex2
    from jdeflate_tpu_torch.ops import walk as wk
    err = checked = 0
    largest = None
    for k, ((args, _, oc, e2), (o0, n_out)) in enumerate(zip(per, offs)):
        if e2:
            continue
        tok, _, outlen, lo, _ = wk.walk_checked(*args)
        halo = corpus_halo(data, o0)
        o, p, e = ex2.expand_tokens(tok, outlen, halo, oc, lo)
        ro, rp, re_ = ex2.expand_tokens_ref(tok, outlen, halo, oc)
        n = int(rp)
        if int(p) != n or int(e) or int(re_):
            fail(f"expand2 batch {k}: produced {int(p)} err {int(e)}, plain "
                 f"{n} err {int(re_)}")
        err = max(err, max_abs_err([o[:n]], [ro[:n]]))
        if n != n_out or o[:n].cpu().numpy().tobytes() != data[o0:o0 + n]:
            fail(f"expand2 windowed batch {k}: the card's {n} B differ from "
                 f"the corpus's {n_out} B at offset {o0}")
        if largest is None or n > largest[0]:
            largest = (n, tok, outlen, halo, oc)
        checked += 1
    if err or checked == 0:
        fail(f"expand2 differs from its plain version ({err}) or no batch "
             "was held")
    if not synthetic:
        return err
    n, tok, outlen, halo, oc = largest
    ann = ex2.expand_tokens(wk.annotate_lit_runs(tok), outlen, halo, oc)[0]
    runs = [ex2.expand_tokens(tok, outlen, halo, oc)[0][:n].clone()
            for _ in range(3)]
    if not torch.equal(ann[:n], runs[0]) or not all(
            torch.equal(r, runs[0]) for r in runs[1:]):
        fail("expand2: annotated tokens or repeated runs give other bytes")
    print(f"expand2 equals its plain version and the corpus on {checked} of "
          f"{len(per)} windowed batches (those at engine-2 err 0, each behind "
          f"the corpus's 32 KiB; max abs err 0); annotated tokens and 3 runs "
          f"of the largest batch ({n} B) give the same bytes", flush=True)
    names = []
    for name, tok, outlen, halo, oc in adversarial_tokens(seed=0,
                                                          scale=1 << 21):
        tok, outlen, halo = (torch.from_numpy(x).cuda()
                             for x in (tok, outlen, halo))
        o, p, e = ex2.expand_tokens(tok, outlen, halo, oc)
        ro, rp, re_ = ex2.expand_tokens_ref(tok, outlen, halo, oc)
        k = min(int(rp), oc)
        if (int(p) != int(rp) or bool(e) != bool(re_)
                or bool(e) != (name == "cap_short")
                or not torch.equal(o[:k], ro[:k])):
            fail(f"expand2 adversarial stream {name}: produced {int(p)} vs "
                 f"{int(rp)}, err {int(e)} vs {int(re_)}, "
                 f"{max_abs_err([o[:k]], [ro[:k]])} max abs err")
        names.append(f"{name} {int(rp)} B")
    print(f"expand2 equals its plain version on the adversarial streams: "
          f"{', '.join(names)}", flush=True)
    return err


def match_walk_checks(win: list, bl: int, synthetic: bool = True) -> int:
    """Kernel B3 (csrc/lz77walk.cu) against its plain version on every
    encode batch's inputs (win: (cnext, len, block_len) per batch) and
    (synthetic) on the synthetic adversarial cases. Returns the max abs
    err."""
    import torch
    from jdeflate_tpu_torch.ops import lz77
    err = 0
    for cn, ln, blen in win:
        err = max(err, max_abs_err([lz77.match_walk(cn, ln, blen, bl)],
                                   [lz77.match_walk_ref(cn, ln, blen, bl)]))
    if err:
        fail(f"match walk differs from its plain version: {err}")
    if not synthetic:
        return err
    names = []
    for name, length, take, block_len in adversarial_walks(seed=0, bl=bl):
        blt = torch.from_numpy(block_len).cuda()
        cn, ln = lz77.walk_inputs(torch.from_numpy(length).long().cuda(),
                                  torch.from_numpy(take).cuda(), blt, bl)
        got = lz77.match_walk(cn, ln, blt, bl)
        want = lz77.match_walk_ref(cn, ln, blt, bl)
        if not torch.equal(got, want):
            fail(f"match walk adversarial case {name}: "
                 f"{max_abs_err([got], [want])} max abs err")
        names.append(f"{name} (counts {(want[:, 0] - 1).tolist()})")
    print(f"match walk equals its plain version on all {len(win)} encode "
          f"batches and on the adversarial cases: {', '.join(names)}",
          flush=True)
    return err


def clamps_segment(call) -> bool:
    """Whether a captured windowed batch's last pseudo-entry reads past its
    word window, so its segment start clamps (ROADMAP C5)."""
    from jdeflate_tpu_torch.ops import walk as wk
    _, metas, row, _, npe, _, _, ww = call
    pe_word0 = metas[row][2:2 + npe].clamp(min=0)
    return bool((pe_word0 > ww - (wk.PE_LANES + 8)).any())


def max_abs_err(got, want) -> int:
    import torch
    err = 0
    for g, w in zip(got, want):
        d = (g.to(torch.int64) - w.to(torch.int64)).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    return err


def crc32_phase(card: str, path: dict) -> dict:
    """The crc32 kernel (csrc/crc32.cu) at CRC_SIZES of seeded random
    bytes: crc32 from bytes and from a device tensor, and the kernel's own
    result, must equal zlib.crc32; then its time per launch (CUDA events
    over 50 back-to-back launches), its device time (profiler), the bound
    (n over 3.35 TB/s), the plain program chain on the card (crc32's route
    before the kernel) and the whole crc32 call from bytes against that
    route's call (host clock, median of 20: pinned copy, upload, launch,
    readback). Returns the kernel's row: `launches` and `path_launches`
    are the main path's (`path`: the gzip decode's and the gzip encode's
    launches, each counted from 0 around its call), `check_launches` this
    phase's own checking calls."""
    import torch
    from jdeflate_tpu_torch.ops import checksum as cs

    def plain(x):
        return cs._checksum(cs._crc32_program, x, 0, cs._CRC_CHUNK, True,
                            "cuda")

    def call_ms(fn, x):
        fn(x)
        secs = []
        for _ in range(20):
            t0 = time.perf_counter()
            fn(x)
            secs.append(time.perf_counter() - t0)
        return statistics.median(secs) * 1e3

    row = {"name": "crc32", "route": "cuda",
           "source": "jdeflate_tpu_torch/csrc/crc32.cu",
           "replaces": None, "sizes": list(CRC_SIZES),
           "launches": path["gzip_decode"], "path_launches": dict(path),
           "check_launches": 0, "max_abs_err": 0, "ms": [], "dev_ms": [], "plain_ms": [],
           "bound_ms": [], "bound_by": "bytes", "library_ms": None,
           "call_ms": [], "plain_call_ms": []}
    for n in CRC_SIZES:
        data = random.Random(n).randbytes(n)
        dev = torch.frombuffer(bytearray(data), dtype=torch.uint8).cuda()
        want = zlib.crc32(data)
        before = cs.crc32_kernel.launches
        got = (cs.crc32(data), cs.crc32(dev),
               int(cs.crc32_kernel(dev).item()) & 0xFFFFFFFF, plain(dev))
        row["check_launches"] += cs.crc32_kernel.launches - before
        if any(g != want for g in got):
            fail(f"crc32 of {n} B: bytes, tensor, kernel, plain "
                 f"{[hex(g) for g in got]} != zlib's {want:#x}")
        row["ms"].append(gpu_ms(lambda: cs.crc32_kernel(dev), 50))
        row["dev_ms"].append(device_ms(lambda: cs.crc32_kernel(dev),
                                       ("crc32_kernel",), 20))
        row["plain_ms"].append(gpu_ms(lambda: plain(dev), 5))
        row["bound_ms"].append(n / HBM_BYTES_PER_S * 1e3)
        row["call_ms"].append(call_ms(cs.crc32, data))
        row["plain_call_ms"].append(call_ms(plain, data))
        print(f"crc32 ({card}) on {n} B: = zlib's; "
              f"{row['ms'][-1]:.4f} ms/launch, device "
              f"{row['dev_ms'][-1]:.4f} ms/launch, bound "
              f"{row['bound_ms'][-1]:.4f} ms "
              f"({100 * row['bound_ms'][-1] / row['dev_ms'][-1]:.1f}% of "
              f"the roofline); plain program chain {row['plain_ms'][-1]:.3f}"
              f" ms; a call from bytes {row['call_ms'][-1]:.3f} ms, the "
              f"plain route's {row['plain_call_ms'][-1]:.3f} ms", flush=True)
    return row


def probe_visits(skey, vf, plen, pdist, k: int, pw: int) -> int:
    """The candidates the probe kernel's walk visits over one batch (a
    one-off diagnostic), from the bounds that end the walk and its result:
    sorted index j visits its same-hash predecessors back to the last at or
    after max(its position - WINDOW_SIZE, valid_from), at most k of them,
    and stops early at the first whose prefix reaches the cap 4 * pw: the
    one (plen, pdist) names, since no later one replaces it."""
    import torch
    from jdeflate_tpu_torch.formats import constants as C
    p, h = skey & 0x1FFFF, skey >> 17
    j = torch.arange(skey.shape[1], device=skey.device)[None, :]
    lo = torch.maximum(p - C.WINDOW_SIZE, vf.to(torch.int64)[:, None])
    live = torch.clamp(j - torch.searchsorted(skey, (h << 17) | lo), 0, k)
    capped = j - torch.searchsorted(skey, (h << 17) | (p - pdist.gather(1,
                                                                      p)))
    return int(torch.where(plen.gather(1, p) == 4 * pw, capped, live).sum())


def match_probe_phase(card: str, path_launches: int) -> dict:
    """The bucket probe kernel (csrc/lz77probe.cu) on the encoder's own
    rows of one 1 MiB batch (16 blocks of 64 KiB behind their 32 KiB halo,
    Silesia-like bytes) at levels 1, 6 and 9, each at its own depth: it
    must equal the plain loop (match_probe_ref) on the card; then its time
    per launch (CUDA events over back-to-back launches), its device time
    (profiler), its bound (rows, keys and both outputs over 3.35 TB/s), the
    plain loop's time on the same input, and the mean candidates its walk
    visits per position (probe_visits). Returns the kernel's row:
    `launches` the main path's (phase 7's level-6 gzip encode,
    `path_launches`: one a batch), `check_launches` this phase's own
    checking calls."""
    import numpy as np
    import torch
    from benchmark import corpus
    from jdeflate_tpu_torch.codec import deflate as D
    from jdeflate_tpu_torch.codec import levels
    from jdeflate_tpu_torch.ops import lz77

    bl, batch = 1 << 16, 16
    payload = corpus.make_payload(bl * batch, 2121, 0, corpus.MIX)
    buf = np.zeros(D.HALO + bl * batch + D.PAD, np.uint8)
    buf[D.HALO:D.HALO + bl * batch] = np.frombuffer(payload, np.uint8)
    data = torch.from_numpy(buf).cuda()
    _, vf, _, ext = D._batch_rows(data, 0, bl * batch, 0, batch - 1, bl,
                                  batch)
    nh = D.HALO + bl
    _, skey = lz77.probe_keys(ext.to(torch.int64), nh)
    moved = ext.numel() + skey.numel() * 8 * 3 + vf.numel() * 8
    row = {"name": "lz77probe", "route": "cuda",
           "source": "jdeflate_tpu_torch/csrc/lz77probe.cu", "replaces": None,
           "levels": [1, 6, 9], "launches": path_launches,
           "path_launches": {"gzip_encode": path_launches},
           "check_launches": 0, "max_abs_err": 0, "ms": [], "dev_ms": [],
           "plain_ms": [], "visits": [],
           "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
           "library_ms": None}
    for level in row["levels"]:
        k, pw = levels._CHAIN[level], 16 if level >= 8 else 8
        before = lz77.match_probe.launches
        got = lz77.match_probe(ext, skey, vf, k, pw)
        want = lz77.match_probe_ref(ext, skey, vf, k, pw)
        row["check_launches"] += lz77.match_probe.launches - before
        err = max_abs_err(got, want)
        row["max_abs_err"] = max(row["max_abs_err"], err)
        if err:
            fail(f"match probe at level {level}: the kernel differs from "
                 f"the plain loop by {err}")
        row["ms"].append(gpu_ms(lambda: lz77.match_probe(ext, skey, vf, k,
                                                         pw), 20))
        row["dev_ms"].append(device_ms(
            lambda: lz77.match_probe(ext, skey, vf, k, pw), ("probe_kernel",),
            10))
        row["plain_ms"].append(gpu_ms(
            lambda: lz77.match_probe_ref(ext, skey, vf, k, pw), 1))
        visits = probe_visits(skey, vf, *got, k, pw) / skey.numel()
        row["visits"].append(visits)
        print(f"lz77probe ({card}) level {level} (k {k}, {pw} words) on "
              f"{batch} x {bl} B: = the plain loop; "
              f"{row['ms'][-1]:.4f} ms/launch, device "
              f"{row['dev_ms'][-1]:.4f} ms/launch, bound "
              f"{row['bound_ms']:.4f} ms "
              f"({100 * row['bound_ms'] / row['dev_ms'][-1]:.1f}% of the "
              f"roofline); plain loop {row['plain_ms'][-1]:.2f} ms; "
              f"{visits:.2f} candidates visited a position", flush=True)
    return row


def tree_kernel_phase(card: str, path_launches: dict) -> dict:
    """The two-queue Huffman kernel (csrc/huffman2q.cu) on the encoder's
    own rows of one 1 MiB level-9 batch (16 blocks of 64 KiB, Silesia-like
    bytes, the level's full probe depth): the (512, 286) literal/length and
    (512, 30) distance frequencies that code_batch hands it, recorded in an
    eager encode. It must equal the plain loop (code_lengths_ref) on the
    card; then its time per launch (CUDA events over back-to-back
    launches), its device time (profiler), its bound (the frequencies in
    and the lengths out over 3.35 TB/s) and the plain loop's time, eager,
    on the same rows. Returns the kernel's row: `launches` the main path's
    (phase 15's captured level-9 encode, `path_launches`: two a batch),
    `check_launches` this phase's own checking calls."""
    import torch
    from benchmark import corpus
    from jdeflate_tpu_torch.codec import deflate as D
    from jdeflate_tpu_torch.codec import program
    from jdeflate_tpu_torch.formats import constants as C
    from jdeflate_tpu_torch.ops import huffman

    calls = []
    entropy = D._block_entropy

    def record(lfreq, dfreq, *args, **kw):
        calls.extend([(lfreq.clone(), C.MAX_CODE_BITS),
                      (dfreq.clone(), C.MAX_CODE_BITS)])
        return entropy(lfreq, dfreq, *args, **kw)

    payload = corpus.make_payload(1 << 20, 2121, 0, corpus.MIX)
    D._block_entropy = record
    try:
        with program.eager():
            D.RawDeflater(level=9, block_size=1 << 16, batch=16,
                          device="cuda").compress(payload)
    finally:
        D._block_entropy = entropy
    row = {"name": "huffman2q", "route": "cuda",
           "source": "jdeflate_tpu_torch/csrc/huffman2q.cu",
           "replaces": None, "shapes": [list(f.shape) for f, _ in calls],
           "launches": path_launches.get("program_level9", 0),
           "path_launches": dict(path_launches), "check_launches": 0,
           "max_abs_err": 0, "ms": [], "dev_ms": [], "plain_ms": [],
           "bound_ms": [], "bound_by": "bytes", "library_ms": None}
    if [tuple(f.shape) for f, _ in calls] != [(512, 286), (512, 30)]:
        fail(f"tree kernel: a level-9 batch built trees of "
             f"{row['shapes']}, not (512, 286) and (512, 30)")
    kernel = huffman.code_lengths
    for freqs, L in calls:
        before = kernel.launches
        got = kernel(freqs, L)
        want = huffman.code_lengths_ref(freqs, L)
        row["check_launches"] += kernel.launches - before
        err = max_abs_err((got,), (want,))
        row["max_abs_err"] = max(row["max_abs_err"], err)
        if err:
            fail(f"tree kernel on {tuple(freqs.shape)}: differs from the "
                 f"plain loop by {err}")
        row["ms"].append(gpu_ms(lambda: kernel(freqs, L), 50))
        row["dev_ms"].append(device_ms(lambda: kernel(freqs, L),
                                       ("two_queue_kernel",), 20))
        row["plain_ms"].append(gpu_ms(
            lambda: huffman.code_lengths_ref(freqs, L), 1))
        row["bound_ms"].append(freqs.numel() * 16 / HBM_BYTES_PER_S * 1e3)
        print(f"huffman2q ({card}) on {tuple(freqs.shape)}: = the plain "
              f"loop; {row['ms'][-1]:.4f} ms/launch, device "
              f"{row['dev_ms'][-1]:.4f} ms/launch, bound "
              f"{row['bound_ms'][-1]:.5f} ms "
              f"({100 * row['bound_ms'][-1] / row['dev_ms'][-1]:.2f}% of the "
              f"roofline); plain loop {row['plain_ms'][-1]:.2f} ms",
              flush=True)
    return row


def main() -> None:
    try:
        import torch
        from jdeflate_tpu_torch.codec import inflate as I
        from jdeflate_tpu_torch.formats import headers as H
        from jdeflate_tpu_torch.ops import _cuda
        from jdeflate_tpu_torch.ops import checksum as cs
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
    built = _cuda.build(["walk", "expand", "lz77walk", "expand5seed",
                         "expand5resolve", "expand1", "crc32", "lz77probe",
                         "huffman2q", "lz77extend", "rowscan", "stamp"])
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
    wk.walk_checked.launches = 0
    ex2.expand_tokens.launches = 0
    out = dec.decompress(raw, index=idx)
    torch.cuda.synchronize()
    launches = {"walk": wk.walk_checked.launches,
                "expand2": ex2.expand_tokens.launches}
    stats = list(dec.last_stats)
    calls = list(dec.last_calls)
    dec.capture_calls = False
    if out != data:
        fail("raw decode differs from the corpus")
    kinds = [k for k, _, _ in stats]
    if any(k not in ("win", "stored") for k in kinds):
        fail(f"unexpected batch kinds {set(kinds)}")
    # a batch may err only where its last pseudo-entry's word segment clamps
    # into the batch's word window (ROADMAP C5, as in the reference); the
    # decode then goes native from that batch on
    clamped = [clamps_segment(c) for c in calls]
    errs = [e for k, _, e in stats if k == "win"]
    if any(e and not clamped[i] for i, e in enumerate(errs)):
        fail(f"a batch erred on the main path: {stats}")
    c5 = [(i, e) for i, e in enumerate(errs) if e]
    if c5 != E2_ERRS:
        fail(f"engine-2 err decisions {c5} != the reference's {E2_ERRS}")
    nwin = len(calls)
    if nwin == 0 or launches != {"walk": nwin, "expand2": nwin}:
        fail(f"launches {launches} != {nwin} windowed batches")
    print(f"main path: index {index_s:.2f} s, {len(idx['block_bits'])} "
          f"blocks, {nwin} win + {kinds.count('stored')} stored batches "
          f"logged, launches {launches}; batches whose last pseudo-entry "
          f"clamps (C5) {sum(clamped)}, erring "
          + (f"{c5}: native re-decode from windowed batch {c5[0][0]} on "
             f"({len(data) - sum(p for _, p, _ in stats[:-1])} B)"
             if c5 else "none"), flush=True)
    print(f"decode output: {card_share([stats], len(data))}", flush=True)
    cs.crc32_kernel.launches = 0
    outg = zstrm.decompress(gz, index=idx, header_len=hl, device="cuda")
    crc_dec = cs.crc32_kernel.launches
    if outg != data:
        fail("gzip decode differs from the corpus")
    if crc_dec != 1:
        fail(f"crc32 kernel launches in the gzip decode {crc_dec} != 1")
    print(f"gzip-framed decode with CRC32 trailer check: ok; crc32 kernel "
          f"launches {crc_dec}", flush=True)

    # ---- 4. each kernel against its plain version, on the card. Every
    # captured batch is decoded again on its own, which gives its engine-2
    # err also past the first erring batch (the log stops there).
    per = []
    for words, metas, row, halo, npe, nb, oc, ww in calls:
        args = I._walk_inputs(words, metas[row], npe, nb, ww)
        e2 = int(I.decode_batch_windows_stacked(words, metas, row, halo, npe,
                                                nb, oc, ww)[2])
        per.append((args, halo, oc, e2))
    e2_errs = [p[3] for p in per]
    if e2_errs[:len(errs)] != errs:
        fail(f"batch errs decoded alone {e2_errs[:len(errs)]} != the "
             f"decode's {errs}")
    walk_err = walk_checks(per, calls)
    exp_err = expand2_checks(per, batch_offsets(dec, raw, idx, "win"), data)

    # ---- 5. fallback: a tampered anchor errs and is re-decoded natively
    k = max((i for i, w in enumerate(idx["win"]) if w is not None),
            key=lambda i: len(idx["win"][i]))
    win = list(idx["win"])
    win[k] = win[k].copy()
    valid = [i for i, a in enumerate(win[k]) if a >= 0]
    win[k][valid[len(valid) // 2]] += 1
    dec.capture_calls = True
    outt = dec.decompress(raw, index={**idx, "win": win})
    tcalls = list(dec.last_calls)
    dec.capture_calls = False
    bad = [(p, e) for kk, p, e in dec.last_stats if kk == "win" and e > 0]
    if not bad or outt != data:
        fail(f"tampered anchor: err batches {bad}, bytes ok {outt == data}")
    # the batches whose walk checks the tampered anchor changed, held
    # against the plain version
    held = []
    for i, (words, metas, row, halo, npe, nb, oc, ww) in enumerate(tcalls):
        args = I._walk_inputs(words, metas[row], npe, nb, ww)
        if not torch.equal(wk.walk_checked(*args)[4],
                           wk.walk_checked(*per[i][0])[4]):
            walk_err = max(walk_err, max_abs_err(
                wk.walk_checked(*args), wk.walk_checked_ref(*args)))
            held.append(i)
    if walk_err or not held:
        fail(f"tampered anchor: walk checks differ from the plain version "
             f"({walk_err}) or no batch changed ({held})")
    print(f"tampered anchor: batch err {bad[0][1]} -> native re-decode ok; "
          f"the walk's checks equal the plain version on the changed "
          f"windowed batch(es) {held}", flush=True)

    # ---- 6. times
    walk_ms, exp_ms, walk_bound, exp_bound = [], [], [], []
    walk_plain, exp_plain, exp_args = [], [], []
    ntok = 0
    lanes = []
    for args, halo, oc, _ in per:
        start_rel, t1, npe = args[3], args[4], args[1].numel()
        L = start_rel.numel()
        lanes.append(L)
        tok, _, outlen, lo, _ = wk.walk_checked(*args)
        walk_ms.append(gpu_ms(lambda: wk.walk_checked(*args)))
        exp_ms.append(gpu_ms(lambda: ex2.expand_tokens(tok, outlen, halo,
                                                       oc, lo)))
        exp_args.append((tok, outlen, halo, oc, lo))
        walk_plain.append(gpu_ms(lambda: wk.walk_checked_ref(*args), 1))
        exp_plain.append(gpu_ms(
            lambda: ex2.expand_tokens_ref(tok, outlen, halo, oc), 1))
        # least bytes: each input read once (a word per active lane, the
        # anchors, three words per pseudo-entry, hist, the tree rows), each
        # output written once (tokens, meta, outlen, laneoff, err)
        active = int((start_rel >= 0).sum())
        walk_bytes = (active * 4 + L * 4 + 12 * npe + 4
                      + 4 * t1.shape[0] * 128 * 4
                      + L * wk.S_SLOTS * 4 + L * (4 + 4 + 8) + 4)
        produced = int(outlen.sum())
        exp_bytes = L * wk.S_SLOTS * 4 + L * 4 + I.HALO + produced
        walk_bound.append(walk_bytes / HBM_BYTES_PER_S * 1e3)
        exp_bound.append(exp_bytes / HBM_BYTES_PER_S * 1e3)
        ntok += int((tok != 0).sum())

    exp_dev = device_ms(lambda: [ex2.expand_tokens(*a) for a in exp_args],
                        ("expand_place_kernel", "TokenFront"),
                        3) / len(exp_args)
    walk_dev = device_ms(lambda: [wk.walk_checked(*p[0]) for p in per],
                         ("walk_kernel",), 3) / len(per)
    wall, span, walls = timed_runs(
        lambda: dec.decompress(raw, index=idx),
        lambda o: o == data or fail("timed decode differs from the corpus"))
    print(f"decode ({card}): wall {wall * 1e3:.1f} ms = "
          f"{len(data) / wall / 1e9:.4f} GB/s; device span "
          f"{span * 1e3:.1f} ms = {len(data) / span / 1e9:.4f} GB/s; "
          f"runs {[round(w * 1e3, 1) for w in walls]} ms; of the output, "
          f"{card_share([dec.last_stats], len(data))}", flush=True)
    print(f"walk ({card}): {statistics.mean(walk_ms):.3f} ms/launch x "
          f"{launches['walk']} (per batch {[round(x, 3) for x in walk_ms]}); "
          f"plain {statistics.mean(walk_plain):.3f} ms; bound "
          f"{statistics.mean(walk_bound):.4f} ms; "
          f"{statistics.mean(lanes):.0f} lanes/launch; the kernel's device "
          f"time {walk_dev:.4f} ms/launch", flush=True)
    print(f"expand2 ({card}): {statistics.mean(exp_ms):.3f} ms/launch x "
          f"{launches['expand2']} (per batch "
          f"{[round(x, 3) for x in exp_ms]}); "
          f"plain {statistics.mean(exp_plain):.3f} ms; bound "
          f"{statistics.mean(exp_bound):.4f} ms; {ntok} tokens, "
          f"{sum(exp_ms) * 1e6 / ntok:.1f} ns/token; the place and resolve "
          f"kernels' device time {exp_dev:.4f} ms/launch", flush=True)
    profile_run("decode", lambda: dec.decompress(raw, index=idx), span)

    stamp("encode phase")
    enc_kernel, crc_enc, probe_enc, ext_enc = encode_phase(data, len(raw),
                                                           card)
    stamp("crc32 phase")
    crc_kernel = crc32_phase(card, {"gzip_decode": crc_dec,
                                    "gzip_encode": crc_enc})
    stamp("match probe phase")
    probe_kernel = match_probe_phase(card, probe_enc)
    stamp("v5 phase")
    v5_kernels = v5_phase(dec, raw, data, idx, e2_errs, card)
    stamp("anchored phase")
    anch_kernel = anchored_phase(data, card)
    stamp("dense phase")
    dense_phase(data, card)
    stamp("ZStream phase")
    zs_launches = zstream_phase(data, gz, card)
    stamp("sharded phase")
    sh_launches, sh_b3_err, dm_launches, dm_walk_err, dm_exp_err, sh_ref = \
        sharded_phase(data, card)
    stamp("multi-process phase")
    torch.cuda.empty_cache()
    mp_launches, mp_b3_err = multiproc_phase(data, card, sh_ref)
    stamp("levels phase")
    t0 = time.perf_counter()
    lv_launches, lv_b3_err = levels_phase(data, card)
    torch.cuda.empty_cache()
    print(f"phase 14: {time.perf_counter() - t0:.1f} s", flush=True)
    stamp("program phase")
    t0 = time.perf_counter()
    pg_launches, pg_probes, pg_trees, ext_kernel, pg_scans = program_phase(
        data, card, ext_enc)
    print(f"phase 15: {time.perf_counter() - t0:.1f} s", flush=True)
    stamp("tree kernel phase")
    tree_kernel = tree_kernel_phase(card, pg_trees)
    stamp("scan kernel phase")
    scan_kernel = scan_kernel_phase(card, pg_scans)
    stamp("decode program phase")
    t0 = time.perf_counter()
    dp_launches = decode_program_phase(data, raw, idx, card)
    print(f"phase 16: {time.perf_counter() - t0:.1f} s", flush=True)
    stamp("done")
    enc_kernel["path_launches"] = {"zstream_deflate": zs_launches,
                                   **sh_launches, **mp_launches,
                                   **lv_launches, **pg_launches}
    enc_kernel["max_abs_err"] = max(enc_kernel["max_abs_err"], sh_b3_err,
                                    mp_b3_err, lv_b3_err)
    probe_kernel["path_launches"].update(pg_probes)

    kernels = [
        {"name": "walk", "route": "cuda",
         "source": "jdeflate_tpu_torch/csrc/walk.cu",
         "replaces": "jdeflate_tpu/ops/walk.py:266",
         "launches": launches["walk"],
         "path_launches": {"decompress_members": dm_launches},
         "max_abs_err": max(walk_err, dm_walk_err),
         "ms": statistics.mean(walk_ms), "dev_ms": walk_dev,
         "plain_ms": statistics.mean(walk_plain),
         "bound_ms": statistics.mean(walk_bound), "bound_by": "bytes",
         "library_ms": None},
        {"name": "expand2", "route": "cuda",
         "source": "jdeflate_tpu_torch/csrc/expand.cu",
         "replaces": "jdeflate_tpu/ops/expand2.py:47",
         "launches": launches["expand2"],
         "path_launches": {"decompress_members": dm_launches},
         "max_abs_err": max(exp_err, dm_exp_err),
         "ms": statistics.mean(exp_ms), "dev_ms": exp_dev,
         "plain_ms": statistics.mean(exp_plain),
         "bound_ms": statistics.mean(exp_bound), "bound_by": "bytes",
         "library_ms": None},
        enc_kernel,
        *v5_kernels,
        anch_kernel,
        crc_kernel,
        probe_kernel,
        tree_kernel,
        ext_kernel,
        scan_kernel,
    ]
    # phase 16's captured decodes: each kernel's launches, through replays
    for k in kernels:
        for path, counts in dp_launches.items():
            if k["name"] in counts:
                k.setdefault("path_launches", {})[
                    f"program_decode_{path}"] = counts[k["name"]]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    if sys.argv[1:2] == ["--mp-worker"]:
        mp_worker(sys.argv[2], int(sys.argv[3]))
    else:
        main()
