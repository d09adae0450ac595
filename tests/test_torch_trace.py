"""The port's spans and counters (jdeflate_tpu_torch/trace.py) on the CPU:
one request record per public call, spans that nest and carry the call's
id, the native decoder's bytes, the blocking reads of a round trip, the
bounded ring and dispatch log, and stamps on torch.profiler's clock with
no event of their own in the profile. On a card (marker cuda): the program
layer's node counts and replay spans."""
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import jdeflate_tpu_torch as jdt
from jdeflate_tpu_torch import trace
from jdeflate_tpu_torch.codec import inflate as tinf
from jdeflate_tpu_torch.codec.deflate import RawDeflater
from jdeflate_tpu_torch.stream import zstrm

from conftest import make_corpus

BLOCK, BATCH = 16384, 4
PHASES = ("decode.plan", "decode.upload", "decode.launch", "decode.finish")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch's default thread pool only spins against the other test
    workers' JAX compiles."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    return make_corpus(np.random.default_rng(18), "text", 100000)


@pytest.fixture(scope="module")
def member(data):
    return jdt.compress_with_index(data, level=1, block_size=BLOCK,
                                   batch=BATCH, device="cpu")


def traced(fn):
    """fn()'s result, the record it left and the spans stamped during it."""
    t0 = trace.now_ns()
    out = fn()
    t1 = trace.now_ns()
    spans = [s for s in trace.recent() if s[2] >= t0 and s[3] <= t1]
    return out, trace.last_request(), spans


def test_each_public_call_leaves_one_record(data, member):
    stream, index, hl = member
    calls = {
        "zstrm.compress": lambda: zstrm.compress(
            data, level=1, block_size=BLOCK, batch=BATCH, device="cpu"),
        "zstrm.compress_with_index": lambda: zstrm.compress_with_index(
            data, level=1, block_size=BLOCK, batch=BATCH, device="cpu"),
        "zstrm.decompress": lambda: zstrm.decompress(
            stream, index=index, header_len=hl, device="cpu"),
        "RawDeflater.compress": lambda: RawDeflater(
            level=1, block_size=BLOCK, batch=BATCH, device="cpu").compress(
                data),
        "RawInflater.decompress": lambda: tinf.RawInflater(
            device="cpu").decompress(stream[hl:-8], index=index),
    }
    ids = []
    for op, fn in calls.items():
        n0 = trace.totals()["requests"]
        _, rec, spans = traced(fn)
        n1 = trace.totals()["requests"]
        # one record: the nested entries joined the call's
        assert rec["op"] == op
        assert {k: n1[k] - n0.get(k, 0) for k in n1
                if n1[k] != n0.get(k, 0)} == {op: 1}
        assert set(rec) == {"id", "op", "seconds", "spans", "counters"}
        assert spans and all(s[1] == rec["id"] for s in spans)
        assert {s[0] for s in spans} == set(rec["spans"])
        ids.append(rec["id"])
    assert len(set(ids)) == len(ids) and ids == sorted(ids)
    # a public entry inside another joins it
    _, rec, _ = traced(calls["zstrm.compress"])
    assert {"encode", "encode.launch", "encode.finish", "crc32"} <= set(
        rec["spans"])
    _, rec, _ = traced(calls["zstrm.decompress"])
    assert {"decode", "decode.inflater", "crc32", *PHASES} <= set(
        rec["spans"])
    # the CPU runs no captured program
    assert not [k for k in rec["counters"] if k.startswith("program.")]


def test_program_counts_join_the_open_request():
    """The program layer counts its evictions (and captures) in
    program.stats and, as program.evictions, in the open request."""
    from jdeflate_tpu_torch.codec import program

    class Cached:
        dev, pool, nbytes = torch.device("cpu"), object(), 0

    n0 = program.stats["evictions"]
    program._programs["trace.test"] = Cached()
    with trace.request("evict"):
        program._evict("trace.test")
    assert "trace.test" not in program._programs
    assert program.stats["evictions"] == n0 + 1
    assert trace.last_request()["counters"] == {"program.evictions": 1}


def test_request_is_per_thread(data):
    got = {}

    def other():
        zstrm.compress(data[:20000], level=1, block_size=BLOCK, batch=BATCH,
                       device="cpu")
        got["rec"] = trace.last_request()

    with trace.request("outer"):
        with trace.span("outer.work"):
            t = threading.Thread(target=other)
            t.start()
            t.join()
    mine = trace.last_request()
    assert mine["op"] == "outer" and set(mine["spans"]) == {"outer.work"}
    assert got["rec"]["op"] == "zstrm.compress"
    assert got["rec"]["id"] != mine["id"]


def test_span_seconds_nest(member):
    stream, index, hl = member
    _, rec, _ = traced(lambda: zstrm.decompress(
        stream, index=index, header_len=hl, device="cpu"))
    s = rec["spans"]
    assert sum(s[k] for k in PHASES) <= s["decode.inflater"] <= s["decode"]
    assert s["decode"] <= rec["seconds"]


def test_broken_index_counts_native_bytes(data):
    raw, index = RawDeflater(level=1, block_size=BLOCK, batch=BATCH,
                             device="cpu").compress(data)
    win = list(index["win"])
    win[2] = np.asarray(win[2]) + 1     # the second batch's walk errs
    dec = tinf.RawInflater(max_batch_blocks=2, device="cpu")
    out, rec, _ = traced(lambda: dec.decompress(
        raw, index={**index, "win": win}))
    assert out == data
    assert any(e for _, _, e in dec.last_stats)
    card, stored = tinf.card_bytes(dec.last_stats)
    assert card > 0
    assert rec["counters"]["decode.native_bytes"] == len(out) - card - stored
    assert len(out) - card - stored > 0
    assert rec["spans"]["decode.native"] <= rec["spans"]["decode.finish"]
    # the index-less path is the native decoder's alone
    _, rec, _ = traced(lambda: dec.decompress(raw))
    assert rec["counters"]["decode.native_bytes"] == len(data)
    assert "decode.native" in rec["spans"]


def test_round_trip_reads_once_per_site(data):
    """Each encode batch reads its meta, anchors and words (read_batch);
    each checksum its value; the decode each windowed batch's row index,
    its (produced, err) table and the bytes of its device batches
    (_fill)."""
    stream, index, hl = jdt.compress_with_index(
        data, level=1, block_size=BLOCK, batch=BATCH, device="cpu")
    enc = trace.last_request()["counters"]
    out = jdt.decompress(stream, index=index, header_len=hl, device="cpu")
    dec = trace.last_request()["counters"]
    assert out == data
    batches = -(-len(data) // (BLOCK * BATCH))
    assert batches == 2
    assert enc["d2h.calls"] == 3 * batches + 1
    # the windowed batch's row index, the table, _fill, the checksum
    assert dec["d2h.calls"] == 1 + 1 + 1 + 1
    # every batch decoded on the card: nothing for the native decoder
    assert "decode.native_bytes" not in dec


def test_ring_and_dispatch_log_are_bounded():
    for _ in range(trace.RING + 10):
        with trace.span("ring.fill"):
            pass
    got = trace.recent()
    assert len(got) == trace.RING
    assert all(s[0] == "ring.fill" for s in got)
    assert tinf.STATS_LOG.maxlen == tinf.STATS_KEEP >= 1 << 16


def test_stamps_on_the_profilers_clock_and_no_profiler_events(member):
    stream, index, hl = member
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("stamp.warm"):     # the profiler's first range
            pass
        with trace.span("stamp.outer"):
            with record_function("stamp.inner"):
                sum(range(10000))
        zstrm.decompress(stream, index=index, header_len=hl, device="cpu")
    rec = trace.last_request()
    outer = [s for s in trace.recent() if s[0] == "stamp.outer"][-1]
    events = list(prof.profiler.kineto_results.events())
    inner = [e for e in events if e.name() == "stamp.inner"]
    assert len(inner) == 1
    start = inner[0].start_ns()
    end = start + inner[0].duration_ns()
    assert outer[2] <= start <= outer[2] + 1_000_000
    assert end <= outer[3] <= end + 1_000_000
    names = {e.name() for e in events}
    assert not names & (set(rec["spans"]) | {"stamp.outer"})


def _graph_nodes_libcuda(graph) -> int:
    """cuGraphGetNodes, libcuda's count of a cudaGraph_t's nodes, apart
    from the runtime entry the program layer reads (ops/stamp.py)."""
    import ctypes
    lib = ctypes.CDLL("libcuda.so.1")
    fn = lib.cuGraphGetNodes
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.POINTER(ctypes.c_size_t)]
    n = ctypes.c_size_t(0)
    assert fn(graph.raw_cuda_graph(), None, ctypes.byref(n)) == 0
    return n.value


@pytest.mark.cuda
def test_program_nodes_and_replays_on_card(data):
    """On a card: each captured program's node count is libcuda's count of
    its graph; a warm zstrm.compress_with_index adds, per replay, its
    program's count to program.nodes (one match and one coding program a
    batch) and makes one program.replay span a replay; and every such span
    in trace.recent() encloses the profiler's cudaGraphLaunch of its
    replay, so the ring and Kineto's host events share one clock."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from jdeflate_tpu_torch.codec import deflate as TD
    from jdeflate_tpu_torch.codec import program
    program.clear()
    kw = dict(level=6, block_size=BLOCK, batch=BATCH, device="cuda")
    jdt.compress_with_index(data, **kw)                 # captures
    progs = {k[1]: p for k, p in program._programs.items()}
    assert set(progs) == {TD._match_handle, TD._code_handle}
    for p in progs.values():
        assert p.nodes == _graph_nodes_libcuda(p.graph) > 1
    batches = -(-len(data) // (BLOCK * BATCH))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = trace.now_ns()
        jdt.compress_with_index(data, **kw)
        torch.cuda.synchronize()
        t1 = trace.now_ns()
    rec = trace.last_request()
    assert rec["counters"]["program.nodes"] == batches * sum(
        p.nodes for p in progs.values())
    replays = [s for s in trace.recent()
               if s[0] == "program.replay" and t0 <= s[2] and s[3] <= t1]
    assert len(replays) == 2 * batches
    assert all(s[1] == rec["id"] for s in replays)
    launches = sorted(
        (e.start_ns(), e.start_ns() + e.duration_ns())
        for e in prof.profiler.kineto_results.events()
        if e.name().startswith("cudaGraphLaunch"))
    assert len(launches) == len(replays), (len(launches), len(replays))
    for (_, _, s0, s1), (l0, l1) in zip(sorted(replays, key=lambda s: s[2]),
                                        launches):
        assert s0 <= l0 <= l1 <= s1, (s0, l0, l1, s1)
