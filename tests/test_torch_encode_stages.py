"""The encoder's two stages (jdeflate_tpu_torch/codec/deflate.py): each
batch runs the match stage, then the coding stages on its (length, dist),
and on a card the device time of each joins the open request as the
counters encode.match_ns and encode.code_ns.

On the CPU: a level-9 member of a Silesia-like payload (the benchmark's
corpus) is sound by the benchmark's plain reference (benchmark/reference.py
through generator.member_faults: zlib decodes it to the payload, its
header, CRC-32 and ISIZE hold, its index matches the stream), at the CPU
tests' probe cap (tests/conftest.py); and no record carries a stage time,
since there are no events. On a card (marker cuda): both counters in every
encode record and positive; their sum, the elapsed device time of the
stages on their stream (the device's waits inside a stage included), at
least nine tenths of the call's device busy time under torch.profiler
(the rest is the uploads, the checksum and the readbacks, outside the
stages) and at most the call's wall time; RawDeflater.launch free of
synchronising calls."""
import time

import numpy as np
import pytest
import torch

from benchmark import corpus, generator
from jdeflate_tpu_torch import trace
from jdeflate_tpu_torch.codec import levels as tlevels
from jdeflate_tpu_torch.codec.deflate import RawDeflater
from jdeflate_tpu_torch.stream import zstrm

STAGES = ("encode.match_ns", "encode.code_ns")
SEED = 2**33 + 2020


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
                                     device="cpu").compress(data)):
        call()
        rec = trace.last_request()
        assert rec["counters"]["d2h.calls"] > 0
        assert not set(STAGES) & set(rec["counters"])


def _busy_ns(prof) -> int:
    """The union of the device operations of a finished profile, ns."""
    cuda = torch.autograd.DeviceType.CUDA
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == cuda)
    busy, cur = 0, None
    for s, e in spans:
        if cur is None or s > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    return busy + (cur[1] - cur[0] if cur else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("level", [6, 9])
def test_stage_counters_on_card(level, monkeypatch):
    """At the level's own probe depth: a test module that imports the
    JAX package's CPU cap (test_torch_program.py) lowers it for the
    whole process."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile
    monkeypatch.setitem(tlevels._PROBE_CAP, level, tlevels._CHAIN[level])
    data = corpus.make_payload(2 << 20, 20260817, 0, corpus.MIX)
    kw = dict(format="gzip", level=level, block_size=65536, batch=16,
              device="cuda")
    want = zstrm.compress_with_index(data, **kw)       # captures
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter_ns()
        got = zstrm.compress_with_index(data, **kw)
        wall = time.perf_counter_ns() - t0
    assert (got[0], got[2]) == (want[0], want[2])
    rec = trace.last_request()
    match, code = (rec["counters"].get(k, 0) for k in STAGES)
    assert match > 0 and code > 0, rec["counters"]
    busy = _busy_ns(prof)
    assert 0.9 * busy <= match + code <= wall, (match, code, busy, wall)

    enc = RawDeflater(level=level, block_size=65536, batch=16, device="cuda")
    enc.compress(data)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        launched = enc.launch(data)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert enc.finish(launched)[0] == enc.compress(data)[0]
