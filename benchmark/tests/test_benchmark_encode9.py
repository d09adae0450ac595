"""The level-9 Silesia encode cell (deflate9_silesia.encode) and its three
per-layer readers, on the CPU.

- The cell, cut to a CPU size (one 64 KiB payload, 16 KiB blocks in
  batches of 4, level 9 at the CPU tests' probe depth of 8, as
  tests/conftest.py caps it), is correct when sound and not correct under
  each fault of faults.py.
- match_device_ms_per_MiB and code_device_ms_per_MiB read the summed
  encode.match_ns and encode.code_ns counters of the kept encode records
  per MiB encoded; device_idle_share.encode9 the traced stretch's idle
  share. Each gives nothing where its input is missing: a record without
  the counter (the parent, the CPU), a port without records, no device
  timeline.
- The cell's payload is the first 4 MiB of deflate6_silesia's first."""
import time

import pytest
import torch

from benchmark import corpus, faults, generator, harness, spec, tracing

CELL = "deflate9_silesia.encode"
MIB = 1 << 20


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def cpu_cap(monkeypatch):
    from jdeflate_tpu_torch.codec import levels
    monkeypatch.setitem(levels._PROBE_CAP, 9, 8)


def tiny() -> spec.Cell:
    c = spec.load_cell(CELL)
    c.config = dict(c.config, block_size=16384, batch=4)
    c.config["payload"] = dict(c.config["payload"],
                               sizes={"silesia_tar": 65536})
    c.traffic = dict(c.traffic, trace={"calls": 2})
    return c


def run(fault=None, trace=True):
    return harness.run_cell(tiny(), 2**31 + 909, 0.0, trace,
                            time.perf_counter(), device="cpu", fault=fault)


def test_the_cell_is_level_9_on_one_payload():
    c = spec.load_cell(CELL)
    assert (c.config["level"], c.config["block_size"], c.config["batch"]) \
        == (9, 65536, 16)
    assert c.config["payload"]["sizes"] == {"silesia_tar": 4 * MIB}
    assert c.traffic == {"op": "encode", "check": {"per_pass": 1},
                         "index_samples": 3, "trace": {"calls": 1}}
    assert c.chips == 1
    assert [m["name"] for m in c.end_to_end] == [
        "encode_GBps", "compress_ratio", "setup_s"]
    assert {m["name"] for m in c.per_layer} == {
        "match_device_ms_per_MiB", "code_device_ms_per_MiB",
        "device_idle_share.encode9"}


def test_payload_is_the_prefix_of_deflate6_silesias_first():
    c9, c6 = spec.load_cell(CELL), spec.load_cell("deflate6_silesia.encode")
    p6 = c6.config["payload"]
    first = corpus.make_payload(next(iter(p6["sizes"].values())),
                                p6["content_seed"], 0,
                                corpus.KINDS[p6["content"]])
    (got,) = generator.make_payloads(c9.config, c9.traffic)
    assert got == first[:4 * MIB]


@pytest.mark.parametrize("trace", [True, False])
def test_sound_run_is_correct(cpu_cap, trace):
    r = run(trace=trace)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0
    # every answer judged, the fresh payload's too
    assert r["checks"]["answers_checked"]["value"] == r["attempted"] + 1
    if not trace:
        assert set(r["metrics"]) == {"encode_GBps", "compress_ratio",
                                     "setup_s"}


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_fault_is_not_correct(cpu_cap, fault):
    r = run(fault)
    assert not r["correct"], (fault, r["checks"])


def record(**counters):
    return {"id": 1, "op": "zstrm.compress_with_index", "seconds": 1.0,
            "spans": {}, "counters": {"d2h.calls": 13, **counters}}


def reader(name):
    return spec.load_module("layer_metrics", name)


@pytest.mark.parametrize("name,counter", [
    ("match_device_ms_per_MiB", "encode.match_ns"),
    ("code_device_ms_per_MiB", "encode.code_ns")])
def test_stage_readers(name, counter):
    other = ({"encode.match_ns", "encode.code_ns"} - {counter}).pop()
    recs = [record(**{counter: 600_000_000, other: 1}),
            record(**{counter: 1_800_000_000, other: 1})]
    tr = tracing.Trace(CELL, requests=2, encoded=8 * MIB,
                       kept={"encode": recs})
    assert reader(name).read(tr) == pytest.approx(2400.0 / 8)
    # silent: a record without the counter, a port without records, none
    # kept, nothing encoded
    for kept, enc in (([recs[0], record()], 8 * MIB), ([None, None], 8 * MIB),
                      ([], 8 * MIB), (recs, 0)):
        tr = tracing.Trace(CELL, requests=2, encoded=enc,
                           kept={"encode": kept})
        assert reader(name).read(tr) is None


def test_stage_readers_keep_one_record_per_call():
    merged = tracing.merge(*(reader(n).SPANS for n in (
        "match_device_ms_per_MiB", "code_device_ms_per_MiB")))
    assert len(merged) == 1 and len(merged[0][3]) == 1


def test_idle_share_reader():
    r = reader("device_idle_share.encode9")
    tr = tracing.Trace(CELL, busy_s=2.7, window_s=3.0)
    assert r.read(tr) == pytest.approx(10.0)
    assert r.read(tracing.Trace(CELL)) is None
    assert r.read(tracing.Trace(CELL, window_s=3.0)) is None
