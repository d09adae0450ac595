"""The per-layer readers of the encoder's clock stamps and of the program
layer's replays, on synthetic request records:

- launch_wait_ms_per_MiB and entropy_device_ms_per_MiB read the summed
  encode.launch_wait_ns and encode.entropy_ns counters of the kept encode
  records per MiB encoded;
- program_replay_share.request reads the program.replay span's seconds
  over both request records' seconds, program_replay_share.foreign over
  the decode records' decode span;
- program_nodes_per_request reads the summed program.nodes counter of
  both records per request.

Each gives nothing where its input is missing: a record without the
counter or span (the parent port, the CPU), a port without records, none
kept, nothing encoded. Each is listed for the cells it reads, under the
layer name BENCHMARK.json already gives its layer."""
import pytest

from benchmark import program_records, spec, tracing

MIB = 1 << 20
STAGES = {"launch_wait_ms_per_MiB": "encode.launch_wait_ns",
          "entropy_device_ms_per_MiB": "encode.entropy_ns"}
SHARES = ("program_replay_share.request", "program_replay_share.foreign")
NAMES = (*STAGES, *SHARES, "program_nodes_per_request")


def reader(name):
    return spec.load_module("layer_metrics", name)


def record(op, seconds=2.0, spans=None, **counters):
    return {"id": 1, "op": op, "seconds": seconds, "spans": spans or {},
            "counters": {"d2h.calls": 7, **counters}}


def enc(seconds=2.0, spans=None, **counters):
    return record("zstrm.compress_with_index", seconds, spans, **counters)


def dec(seconds=2.0, spans=None, **counters):
    return record("zstrm.decompress", seconds, spans, **counters)


@pytest.mark.parametrize("name", sorted(STAGES))
def test_stage_readers(name):
    counter = STAGES[name]
    other = ({"encode.launch_wait_ns", "encode.entropy_ns"} - {counter}).pop()
    recs = [enc(**{counter: 300_000_000, other: 1}),
            enc(**{counter: 900_000_000, other: 1})]
    tr = tracing.Trace("cell", requests=2, encoded=4 * MIB,
                       kept={"encode": recs})
    assert reader(name).read(tr) == pytest.approx(1200.0 / 4)
    for kept, n in (([recs[0], enc()], 4 * MIB), ([None, None], 4 * MIB),
                    ([], 4 * MIB), (recs, 0)):
        tr = tracing.Trace("cell", requests=2, encoded=n,
                           kept={"encode": kept})
        assert reader(name).read(tr) is None


def test_replay_share_of_a_request():
    r = reader("program_replay_share.request")
    kept = {"encode": [enc(2.0, {"program.replay": 0.25}),
                       enc(2.0, {"program.replay": 0.15})],
            "decode": [dec(1.0, {"program.replay": 0.1}), dec(1.0)]}
    tr = tracing.Trace("cell", requests=2, kept=kept)
    assert r.read(tr) == pytest.approx(100.0 * 0.5 / 6.0)
    for kept in ({"encode": [enc(), enc()], "decode": [dec(), dec()]},
                 {"encode": [None, None], "decode": [None, None]}, {}):
        assert r.read(tracing.Trace("cell", requests=2, kept=kept)) is None


def test_replay_share_of_a_foreign_decode():
    r = reader("program_replay_share.foreign")
    kept = {"decode": [dec(3.0, {"decode": 2.0, "program.replay": 0.3}),
                       dec(3.0, {"decode": 2.0})]}
    tr = tracing.Trace("cell", requests=2, kept=kept)
    assert r.read(tr) == pytest.approx(100.0 * 0.3 / 4.0)
    for kept in ({"decode": [dec(3.0, {"decode": 2.0})]},
                 {"decode": [dec(3.0, {"program.replay": 0.3})]},
                 {"decode": [None]}, {}):
        assert r.read(tracing.Trace("cell", requests=1, kept=kept)) is None


def test_nodes_per_request():
    r = reader("program_nodes_per_request")
    kept = {"encode": [enc(**{"program.nodes": 5000}),
                       enc(**{"program.nodes": 5200})],
            "decode": [dec(**{"program.nodes": 800}), dec()]}
    tr = tracing.Trace("cell", requests=2, kept=kept)
    assert r.read(tr) == pytest.approx(11000 / 2)
    for kept, n in (({"encode": [enc()], "decode": [dec()]}, 1),
                    ({"encode": [None], "decode": [None]}, 1), ({}, 1),
                    (kept, 0)):
        assert r.read(tracing.Trace("cell", requests=n, kept=kept)) is None


def test_listed_for_their_cells_and_layers():
    bm = spec.load_json(spec.SPEC)
    metrics = {m["name"]: m for m in bm["per_layer"]}
    layers = {m["layer"] for m in bm["per_layer"]
              if m["name"] not in NAMES}
    want = {"launch_wait_ms_per_MiB": ["deflate6_silesia.encode",
                                       "deflate9_silesia.encode"],
            "entropy_device_ms_per_MiB": ["deflate6_silesia.encode",
                                          "deflate9_silesia.encode"],
            "program_replay_share.request": ["gzip1_1mib.roundtrip"],
            "program_replay_share.foreign": ["zlib6_foreign.decode"],
            "program_nodes_per_request": ["gzip1_1mib.roundtrip"]}
    for name, cells in want.items():
        m = metrics[name]
        assert m["workloads"] == cells
        assert m["layer"] in layers
        for cell in cells:
            assert name in {x["name"] for x in spec.load_cell(cell).per_layer}
    assert [m["name"] for m in bm["per_layer"][-len(NAMES):]] == list(NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_one_keep_function(name):
    """Each reader keeps the records through program_records.keep, which
    tracing.merge joins with the other readers' into one per call."""
    spans = reader(name).SPANS
    merged = tracing.merge(spans)
    assert all(k == [program_records.keep] for _, _, _, k in merged)
