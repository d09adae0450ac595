"""Every cell and metric of BENCHMARK.json resolves to its files, and the
file keeps to the benchmark's contract."""
import json
import os
import re

import pytest

from benchmark import generator, spec, tracing

BM = spec.load_json(spec.SPEC)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BM["workloads"]]


def test_top_level_keys():
    assert set(BM) == {"command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"}
    assert BM["command"] == ["python3", "benchmark/run.py"]
    assert "benchmark" in BM["paths"]
    assert 1 <= BM["run_seconds"] <= 51
    assert os.path.getsize(spec.SPEC) < 64 << 10


def test_the_first_three_cells():
    """Later cells come after these."""
    assert CELLS[:3] == ["deflate6_silesia.decode", "gzip1_1mib.roundtrip",
                         "deflate6_silesia.encode"]
    assert len(set(CELLS)) == len(CELLS)
    assert all(w["chips"] in (1, 4) for w in BM["workloads"])
    assert all(w["chips"] == 1 for w in BM["workloads"][:3])


def test_names_units_and_keys():
    names = []
    for c in BM["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names.append(c["name"])
    for w in BM["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200
        names += [w["name"], w["config"], w["traffic"]]
    for m in BM["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BM["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    for m in BM["end_to_end"] + BM["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    for n in names:
        assert NAME.match(n), n


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    c = spec.load_cell(cell)
    kind, spans = generator.load(c.traffic["op"])
    assert issubclass(kind, generator.Operation) and spans
    e2e = [m["name"] for m in c.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.end_to_end:
        spec.load_module("end_to_end", m["name"])
    for m in c.per_layer:
        spec.load_module("layer_metrics", m["name"])
        assert m["moves"] in e2e      # the cell reports what it moves


def test_configs_state_their_cut():
    for c in BM["configs"]:
        assert c["file"].startswith("benchmark/configs/")
        f = spec.load_json(os.path.join(spec.ROOT, c["file"]))
        assert f["name"] == c["name"] and f["source"] == c["source"]
        assert f["reduced"] == c["reduced"]
        assert f["assumed"] and f["guarantees"]
        assert any(w["config"] == c["name"] for w in BM["workloads"])


def test_rooflines_named_for_their_kernel():
    for m in BM["per_layer"]:
        mod = spec.load_module("layer_metrics", m["name"])
        if hasattr(mod, "KERNEL"):
            assert m["name"].endswith("_roofline") and m["unit"] == "%"
            assert set(mod.KERNEL) == {"wrapper", "pattern", "bytes"}


def test_declared_spans_merge():
    """The spans of every operation and reader join without a clash."""
    groups = [generator.load(op)[1] for op in ("decode", "encode",
                                               "roundtrip")]
    groups += [getattr(spec.load_module("layer_metrics", m["name"]),
                       "SPANS", ()) for m in BM["per_layer"]]
    merged = tracing.merge(*groups)
    assert len({(m, a) for m, a, _, _ in merged}) == len(merged)


def test_unknown_operation_is_refused():
    with pytest.raises(spec.SpecError):
        generator.load("no_such_op")


def test_layers_one_name_each():
    by_layer = {}
    for m in BM["per_layer"]:
        by_layer.setdefault(m["layer"], set()).add(m["name"])
    assert len(by_layer) >= 5


def test_unknown_cell_is_refused():
    with pytest.raises(spec.SpecError):
        spec.load_cell("no_such.cell")


def test_spec_is_plain_json():
    assert json.loads(open(spec.SPEC).read()) == BM
