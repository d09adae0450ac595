"""The encoder's two stages (jdeflate_tpu_torch/codec/deflate.py): each
batch runs the match program, then the coding program on its (length,
dist), and on a card the card's own clock, stamped inside the two programs
(ops/stamp.py), gives the open request the counters encode.match_ns,
encode.launch_wait_ns, encode.code_ns and encode.entropy_ns.

On the CPU: a level-9 member of a Silesia-like payload (the benchmark's
corpus) is sound by the benchmark's plain reference (benchmark/reference.py
through generator.member_faults: zlib decodes it to the payload, its
header, CRC-32 and ISIZE hold, its index matches the stream), at the CPU
tests' probe cap (tests/conftest.py); no record carries a stage time, a
graph node count or a replay span, since nothing is captured or stamped;
and the streams and indexes at levels 1, 6 and 9 are the ones the encoder
gave before the stamps (sha256 digests).

On a card (marker cuda): the stamps of a batch are ordered (match first <=
match last <= coding first <= entropy entry <= entropy exit <= coding
last) and match + wait + code is the elapsed time of CUDA events recorded
around launch_batch, within 2% or 20 us, at levels 1, 6 and 9;
encode.code_ns under torch.profiler is within 10% of the same batch's
untraced (the profiler's records of the graph's kernels slow the card by
5-6%; the launch wait it used to hold came to 47%); in a whole call
every counter is in every encode record and positive, and match + wait +
code is at least nine tenths of the call's device busy time under
torch.profiler (the rest is the uploads, the checksum and the readbacks,
outside the stages) and at most the call's wall time. match + code is
more than the busy time: a program's span holds the card's gaps between
its graph's nodes, which the busy time leaves out. RawDeflater.launch is
free of synchronising calls."""
import contextlib
import hashlib
import statistics
import time

import numpy as np
import pytest
import torch

from benchmark import corpus, generator
from jdeflate_tpu_torch import trace
from jdeflate_tpu_torch.codec import deflate as TD
from jdeflate_tpu_torch.codec import levels as tlevels
from jdeflate_tpu_torch.codec.deflate import RawDeflater
from jdeflate_tpu_torch.stream import zstrm

from conftest import make_corpus

STAGES = ("encode.match_ns", "encode.launch_wait_ns", "encode.code_ns",
          "encode.entropy_ns")
PROGRAM = ("program.nodes", "program.replay")
SEED = 2**33 + 2020
# sha256 (first 16 hex digits) of the gzip member and its index that
# compress_with_index gave, before the programs stamped the card's clock,
# for mixed() at each level (16 KiB blocks in batches of 2, probe cap 8 at
# levels 6 and 9)
DIGESTS = {1: "9db769f6c2f37d1c", 6: "9ed82a479557d423",
           9: "616f505e15cc90aa"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def cpu_cap(monkeypatch):
    """The CPU tests' probe depth at level 9 (tests/conftest.py caps the
    JAX package's alike)."""
    monkeypatch.setitem(tlevels._PROBE_CAP, 9, 8)


def payload(n: int) -> bytes:
    return corpus.make_payload(n, SEED, 0, corpus.MIX)


def test_level9_member_is_sound_by_the_reference(cpu_cap):
    data = payload(256 << 10)
    stream, index, hl = zstrm.compress_with_index(
        data, format="gzip", level=9, block_size=65536, batch=4,
        device="cpu")
    got = generator.member_faults(stream, index, hl, data,
                                  np.random.default_rng(SEED), 3)
    assert got["streams_rejected"] == got["bytes_differing"] == 0, got
    assert got["index_faults"] == 0, got["notes"]
    assert len(stream) < len(data)
    assert index["n"] == len(data) and len(index["sync_points"]) == 0


def test_cpu_records_carry_no_stage_times():
    data = payload(40_000)
    for call in (lambda: zstrm.compress_with_index(
                     data, level=6, block_size=16384, batch=2, device="cpu"),
                 lambda: RawDeflater(level=1, block_size=16384, batch=2,
                                     device="cpu").compress(data),
                 lambda: zstrm.decompress(zstrm.compress(
                     data, format="zlib", level=1, block_size=16384,
                     batch=2, device="cpu"), format="zlib", device="cpu")):
        call()
        rec = trace.last_request()
        assert rec["counters"]["d2h.calls"] > 0
        got = set(rec["counters"]) | set(rec["spans"])
        assert not (set(STAGES) | set(PROGRAM)) & got


def mixed() -> bytes:
    rng = np.random.default_rng(2828)
    return b"".join(make_corpus(rng, k, n) for k, n in (
        ("text", 60000), ("binary", 30000), ("random", 10000),
        ("runs", 20000)))


def digest(stream: bytes, index: dict) -> str:
    h = hashlib.sha256(stream)
    for k in ("block_bits", "block_bytes", "sync_points"):
        h.update(np.asarray(index[k], np.int64).tobytes())
    h.update(repr(index["n"]).encode())
    for w in index["win"]:
        h.update(b"-" if w is None else np.asarray(w, np.int64).tobytes())
    return h.hexdigest()[:16]


@pytest.mark.parametrize("level", [1, 6, 9])
def test_cpu_streams_and_indexes_are_unchanged(level, monkeypatch):
    monkeypatch.setitem(tlevels._PROBE_CAP, 6, 8)
    monkeypatch.setitem(tlevels._PROBE_CAP, 9, 8)
    stream, index, hl = zstrm.compress_with_index(
        mixed(), format="gzip", level=level, block_size=16384, batch=2,
        device="cpu")
    assert hl == 10 and digest(stream, index) == DIGESTS[level]


def _busy_ns(prof) -> int:
    """The union of the device operations of a finished profile but the
    spin kernels that open it, ns."""
    cuda = torch.autograd.DeviceType.CUDA
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == cuda and "spin" not in e.name())
    busy, cur = 0, None
    for s, e in spans:
        if cur is None or s > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    return busy + (cur[1] - cur[0] if cur else 0)


@contextlib.contextmanager
def _profiled():
    """torch.profiler over the CPU and the card, opened by 64 spin kernels:
    a session loses the device records of its first launches, and these
    take the loss."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(64):
            torch.cuda._sleep(10_000)
        yield prof


def _card(level, monkeypatch):
    """Skips without a card; else the level at its own probe depth (a test
    module that imports the JAX package's CPU cap, test_torch_program.py,
    lowers it for the whole process)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setitem(tlevels._PROBE_CAP, level, tlevels._CHAIN[level])


def _first_batch(level):
    """A level's encoder with its programs captured, the arguments and
    statics of its first 1 MiB batch, and that batch's chunks per block."""
    data = corpus.make_payload(1 << 20, SEED, 0, corpus.MIX)
    enc = RawDeflater(level=level, block_size=65536, batch=16, device="cuda")
    enc.capture_calls = True
    enc.compress(data)
    enc.compress(data)
    st = enc.call_statics
    return enc.last_calls[0], st, TD._nch(st[0], tlevels.get_level(
        level).chunk)


def _one_batch(args, st, nch):
    """The batch launched and read back in a request of its own: the
    record's counters."""
    with trace.request("stamps"):
        TD.read_batch(TD.launch_batch(*args, *st), st[1], nch)
    return trace.last_request()["counters"]


@pytest.mark.cuda
@pytest.mark.parametrize("level", [1, 6, 9])
def test_stamps_account_for_the_batch_on_card(level, monkeypatch):
    """The card runs the batch behind a 30 ms spin, so the host has
    launched all of it before the first event: between the events lie the
    scalars' upload, the match program's input copies, both programs,
    what lies between them and the coding program's output clones."""
    _card(level, monkeypatch)
    args, st, nch = _first_batch(level)
    for _ in range(3):
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(50_000_000)
        a.record()
        with trace.request("stamps"):
            handle = TD.launch_batch(*args, *st)
            b.record()
            TD.read_batch(handle, st[1], nch)
        c = trace.last_request()["counters"]
        s = handle[1][-TD.STAMPS:].tolist()
        assert s == sorted(s) and s[0] > 0, s
        match, wait, code, entropy = (c[k] for k in STAGES)
        assert (match, wait, code, entropy) == (
            s[1] - s[0], s[2] - s[1], s[5] - s[2], s[4] - s[3])
        elapsed = round(a.elapsed_time(b) * 1e6)
        staged = match + wait + code
        assert staged <= elapsed + 2_000, (staged, elapsed)
        assert elapsed - staged <= max(0.02 * elapsed, 20_000), (
            staged, elapsed, s)


@pytest.mark.cuda
@pytest.mark.parametrize("level", [6, 9])
def test_stage_counters_hold_under_the_profiler_on_card(level,
                                                        monkeypatch):
    """encode.code_ns of one batch under torch.profiler within 10% of the
    same batch's untraced (medians of 5 launches each)."""
    _card(level, monkeypatch)
    args, st, nch = _first_batch(level)

    def code_ns():
        got = []
        for _ in range(5):
            torch.cuda.synchronize()
            got.append(_one_batch(args, st, nch)["encode.code_ns"])
        return statistics.median(got)

    plain = code_ns()
    with _profiled():
        traced = code_ns()
    assert abs(traced - plain) <= 0.1 * plain, (traced, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("level", [6, 9])
def test_stage_counters_on_card(level, monkeypatch):
    _card(level, monkeypatch)
    data = corpus.make_payload(2 << 20, 20260817, 0, corpus.MIX)
    kw = dict(format="gzip", level=level, block_size=65536, batch=16,
              device="cuda")
    want = zstrm.compress_with_index(data, **kw)       # captures
    torch.cuda.synchronize()
    with _profiled() as prof:
        t0 = time.perf_counter_ns()
        got = zstrm.compress_with_index(data, **kw)
        wall = time.perf_counter_ns() - t0
    assert (got[0], got[2]) == (want[0], want[2])
    rec = trace.last_request()
    match, wait, code, entropy = (rec["counters"].get(k, 0) for k in STAGES)
    assert match > 0 and code > 0 and entropy > 0, rec["counters"]
    assert wait >= 0 and entropy < code, rec["counters"]
    busy = _busy_ns(prof)
    assert 0.9 * busy <= match + wait + code <= wall, (
        match, wait, code, busy, wall)

    enc = RawDeflater(level=level, block_size=65536, batch=16, device="cuda")
    enc.compress(data)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        launched = enc.launch(data)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert enc.finish(launched)[0] == enc.compress(data)[0]
