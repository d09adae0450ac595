"""The per-layer metrics that read the port's own request records
(benchmark/program_records.py, jdeflate_tpu_torch/trace.py) on the CPU:
the traced run of each cell, cut as test_benchmark_faults.py cuts it,
reports each of them that its cell lists, in range, from one kept record
per call of the stretch; a port without request records reports none."""
import time

import pytest
import torch

from benchmark import harness, program_records, spec, tracing
from test_benchmark_faults import tiny

NEW = ("crc32_share.request", "crc32_share.decode", "host_syncs_per_request",
       "decode_native_time_share")
CELLS = ("deflate6_silesia.decode", "gzip1_1mib.roundtrip",
         "deflate6_silesia.encode")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reports_the_program_metrics(name, monkeypatch):
    seen = {}
    traced = harness.traced

    def keep_trace(*a, **k):
        got = traced(*a, **k)
        seen["trace"], seen["calls"] = got[1], got[2]
        return got

    monkeypatch.setattr(harness, "traced", keep_trace)
    r = harness.run_cell(tiny(name), 2**31 + 1801, 0.0, True,
                         time.perf_counter(), device="cpu")
    assert r["correct"], r["checks"]
    listed = {m["name"] for m in spec.load_cell(name).per_layer} & set(NEW)
    assert set(r["metrics"]) & set(NEW) == listed
    for m in listed:
        v = r["metrics"][m]["value"]
        if m == "host_syncs_per_request":
            assert v >= 1, (m, v)
        else:
            assert 0 < v <= 100 or (m == "decode_native_time_share"
                                    and v == 0), (m, v)
    tr, calls = seen["trace"], seen["calls"]
    kept = {n: tr.kept[n] for n in ("encode", "decode") if n in tr.kept}
    assert bool(kept) == bool(listed)
    for n, recs in kept.items():
        assert len(recs) == len(calls) == tr.requests
        assert len({r["id"] for r in recs}) == len(recs)
        assert all(r["op"] == {"encode": "zstrm.compress_with_index",
                               "decode": "zstrm.decompress"}[n]
                   for r in recs)


def test_one_keep_function_for_every_reader():
    """tracing.merge drops a keep function already listed only when it is
    the same object: two would keep every record twice."""
    groups = [getattr(spec.load_module("layer_metrics", m), "SPANS", ())
              for m in NEW]
    merged = tracing.merge(*groups)
    assert [len(k) for _, _, _, k in merged] == [1] * len(merged)
    assert all(k == [program_records.keep] for _, _, _, k in merged)


@pytest.mark.parametrize("name", NEW)
def test_a_port_without_records_reports_nothing(name):
    tr = tracing.Trace("cell", requests=2,
                       kept={"encode": [None, None], "decode": [None, None]})
    assert spec.load_module("layer_metrics", name).read(tr) is None
    assert spec.load_module("layer_metrics", name).read(
        tracing.Trace("cell")) is None
