"""The foreign zlib cell (zlib6_foreign.decode), its operation, its
reference and its four per-layer readers, on the CPU.

- The cell, cut to a CPU size (two payloads of its content), runs through
  harness.run_cell and is correct, traced and measured.
- Planted faults read not correct: each of faults.py's (the control flips
  a byte of every answer zstrm.decompress returns); an index entry's bit
  offset moved by one (index_faults); a flipped Adler-32 trailer (the port
  raises, so the calls fail: calls_failed). The last two run with no warm
  calls, which would raise outside the judged calls: the port's plan
  rejects the moved entry's block header too. They run untraced: the
  traced run's counting pass for the rooflines calls again outside the
  judged calls. A trailer check skipped
  (right bytes, no check) fails the fresh payload's call, whose stream with
  its trailer flipped has to raise ChecksumError: calls_failed.
- zlib_reference.py imports only __future__, zlib, numpy and
  benchmark.reference, and rejects what RFC 1950 rejects.
- adler32_share.foreign reads the adler32 span over the decode span of the
  kept zstrm.decompress records, decode_card_share.foreign their
  decode.card_bytes over the bytes decoded, decode_batches_per_MiB.foreign
  their decode.win_batches per MiB, device_idle_share.foreign the traced
  stretch's idle share. Each is silent where its input is missing: a port
  whose records lack the span and counters, the CPU's missing device
  timeline. The cell also reads the accepted decode cell's metrics of the
  layers it runs (ACCEPTED)."""
import ast
import os
import time
import zlib

import pytest
import torch

from benchmark import corpus, faults, harness, spec, tracing, zlib_reference

CELL = "zlib6_foreign.decode"
OP = spec.load_module("operations", "foreign_decode", needs="OPERATION")
# payload 0 of the content at 300,000 B makes a zlib-6 stream of two index
# entries
SIZES = {"a": 300_000, "b": 120_000}
SEED = 2**33 + 2626
READERS = ("adler32_share.foreign", "decode_card_share.foreign",
           "decode_batches_per_MiB.foreign", "device_idle_share.foreign")
# the accepted decode cell's metrics of the layers this cell runs: B1, B2,
# the native decoder, the host plan, the program layer
ACCEPTED = ("decode_plan_share", "decode_native_share",
            "program_captures.decode", "walk_roofline", "expand_roofline",
            "decode_native_time_share")
# read on the CPU too (the rooflines and the idle share need the device's
# timeline)
ON_CPU = READERS[:3] + ("decode_plan_share", "decode_native_share",
                        "program_captures.decode", "decode_native_time_share")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny() -> spec.Cell:
    c = spec.load_cell(CELL)
    c.config = dict(c.config, payload=dict(c.config["payload"], sizes=SIZES))
    c.traffic = dict(c.traffic, trace={"calls": 2})
    return c


def run(trace=True, fault=None):
    return harness.run_cell(tiny(), SEED, 0.0, trace, time.perf_counter(),
                            device="cpu", fault=fault)


def test_the_cell():
    c = spec.load_cell(CELL)
    cfg = c.config
    assert (cfg["format"], cfg["encoder"]["level"], cfg["encoder"]["wbits"],
            cfg["encoder"]["mem_level"], cfg["encoder"]["strategy"]) \
        == ("zlib", 6, 15, 8, "Z_DEFAULT_STRATEGY")
    # deflate6_silesia's payloads: its content, content seed and 12 sizes
    own = spec.load_cell("deflate6_silesia.decode").config["payload"]
    assert cfg["payload"] == own
    assert sum(cfg["payload"]["sizes"].values()) == 211938580
    assert cfg["reduced"] == [] and c.chips == 1
    assert c.traffic == {"op": "foreign_decode",
                         "check": {"per_payload": 1, "per_pass": 1},
                         "index_samples": 3, "trace": {"calls": 12}}
    assert [m["name"] for m in c.end_to_end] == ["decode_GBps", "setup_s"]
    assert sorted(m["name"] for m in c.per_layer) \
        == sorted(READERS + ACCEPTED)


@pytest.mark.parametrize("trace", [True, False])
def test_sound_run_is_correct(trace):
    r = run(trace)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0
    # one answer of each payload and of each pass, and the fresh payload's
    assert r["checks"]["answers_checked"]["value"] >= 2
    if trace:
        # the CPU has no device timeline
        got = r["metrics"]
        assert set(got) == set(ON_CPU)
        assert 0 < got["adler32_share.foreign"]["value"] < 100
        assert 0 < got["decode_card_share.foreign"]["value"] <= 100
        assert got["decode_batches_per_MiB.foreign"]["value"] > 0
    else:
        assert set(r["metrics"]) == {"decode_GBps", "setup_s"}


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_planted_fault_is_not_correct(fault):
    r = run(fault=fault)
    assert not r["correct"], (fault, r["checks"])


def _sampled(seed: int, n_entries: int, samples: int) -> list:
    """The entries of the first stream's index that the judge decodes: the
    first draw of the checks' generator (harness.judge, check_setup)."""
    rng = corpus.rng_for(seed, harness._CHECK_STREAM)
    return sorted(set(int(k) for k in rng.integers(0, n_entries, samples)))


def test_moved_index_entry_is_not_correct(monkeypatch):
    real = OP.OPERATION.prepare
    moved = []

    def prepare(self):
        real(self)
        stream, index = self.streams[0]
        bits = list(index["block_bits"])
        ks = [k for k in _sampled(SEED, len(bits),
                                  self.traffic["index_samples"])
              if k + 1 < len(bits)]
        assert ks, "no sampled entry has a next entry"
        # the sampled entry's blocks now end short of the next entry
        bits[ks[0] + 1] += 1
        moved.append(ks[0] + 1)
        self.streams[0] = (stream, {**index, "block_bits": bits})

    monkeypatch.setattr(OP.OPERATION, "prepare", prepare)
    monkeypatch.setattr(OP.OPERATION, "warm_calls", lambda self: [])
    r = run(trace=False)
    assert moved
    assert r["checks"]["index_faults"]["value"] > 0
    assert not r["correct"], r["checks"]


def test_flipped_trailer_fails_the_calls(monkeypatch):
    real = OP.OPERATION.prepare

    def prepare(self):
        real(self)
        self.streams = [(s[:-1] + bytes([s[-1] ^ 1]), idx)
                        for s, idx in self.streams]

    monkeypatch.setattr(OP.OPERATION, "prepare", prepare)
    monkeypatch.setattr(OP.OPERATION, "warm_calls", lambda self: [])
    r = run(trace=False)
    assert r["checks"]["calls_failed"]["value"] > 0
    assert r["checks"]["streams_rejected"]["value"] == len(SIZES)
    assert not r["correct"], r["checks"]


def _no_trailer_check(monkeypatch):
    from jdeflate_tpu_torch.formats import headers
    monkeypatch.setattr(headers, "check_zlib_trailer", lambda data, adler: None)


def _verify_off(monkeypatch):
    from jdeflate_tpu_torch.stream import zstrm
    real = zstrm.decompress
    monkeypatch.setattr(zstrm, "decompress",
                        lambda *a, **k: real(*a, **{**k, "verify": False}))


@pytest.mark.parametrize("plant", [_no_trailer_check, _verify_off],
                         ids=["trailer_check_skipped", "verify_off"])
def test_skipped_checksum_is_not_correct(monkeypatch, plant):
    plant(monkeypatch)
    r = run(trace=False)
    checks = r["checks"]
    # every answer's bytes are right: only the flipped trailer shows it
    assert checks["bytes_differing"]["value"] == 0
    assert checks["streams_rejected"]["value"] == 0
    assert checks["calls_failed"]["value"] == 1
    assert not r["correct"], checks


def test_flipped_twin_of_the_fresh_payload_raises(monkeypatch):
    seen = []
    real = OP.OPERATION.refuses_flipped_trailer

    def spy(self, stream, index):
        seen.append(len(stream))
        return real(self, stream, index)

    monkeypatch.setattr(OP.OPERATION, "refuses_flipped_trailer", spy)
    r = run(trace=False)
    assert r["correct"], r["checks"]
    # the fresh payload's call alone, not the window's nor the warm calls
    assert len(seen) == 1


def test_reference_imports_only_zlib_numpy_and_the_reference():
    path = os.path.join(spec.HERE, "zlib_reference.py")
    got = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            got |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if node.level:
                mod = "benchmark" + ("." + mod if mod else "")
            got |= ({f"{mod}.{a.name}" for a in node.names}
                    if mod == "benchmark" else {mod})
    assert got <= {"__future__", "zlib", "numpy", "benchmark.reference"}, got


def _zlib(data: bytes, **kw) -> bytes:
    co = zlib.compressobj(6, zlib.DEFLATED, 15, 8, zlib.Z_DEFAULT_STRATEGY,
                          **kw)
    return co.compress(data) + co.flush()


def test_reference_judges_rfc1950():
    data = corpus.make_payload(70_000, 7, 0)
    s = _zlib(data)
    got = zlib_reference.check_stream(s, data)
    assert (got["rejected"], got["differing"], got["header_len"]) == (0, 0, 2)
    assert got["raw"] == s[2:-4]
    bad = {
        "trailer": s[:-1] + bytes([s[-1] ^ 1]),
        "fcheck": s[:1] + bytes([s[1] ^ 1]) + s[2:],
        "cm": bytes([s[0] & 0xF0 | 7]) + s[1:],
        "fdict": _zlib(data, zdict=data[:4096]),
        "truncated": s[:-2],
        "extra": s + b"\x00",
    }
    for name, stream in bad.items():
        assert zlib_reference.check_stream(stream, data)["rejected"] == 1, \
            name
    other = bytearray(data)
    other[100] ^= 1
    got = zlib_reference.check_stream(s, bytes(other))
    assert got["rejected"] == 1 and got["differing"] == 1


def record(seconds=2.0, spans=None, op="zstrm.decompress", **counters):
    return {"id": 1, "op": op, "seconds": seconds,
            "spans": spans or {}, "counters": counters}


def reader(name):
    return spec.load_module("layer_metrics", name)


def test_adler32_share_reader():
    r = reader("adler32_share.foreign")
    recs = [record(spans={"decode": 1.5, "adler32": 0.03}),
            record(spans={"decode": 0.5, "adler32": 0.01})]
    assert r.read(tracing.Trace(CELL, kept={"decode": recs})) \
        == pytest.approx(2.0)
    for kept in ([record(spans={"decode": 1.5})], [None], []):
        assert r.read(tracing.Trace(CELL, kept={"decode": kept})) is None


@pytest.mark.parametrize("name,counter,want", [
    ("decode_card_share.foreign", "decode.card_bytes", 75.0),
    ("decode_batches_per_MiB.foreign", "decode.win_batches", 6.0),
])
def test_counter_readers(name, counter, want):
    r = reader(name)
    n = 2 << 20
    vals = {"decode.card_bytes": (1 << 20, 1 << 19),
            "decode.win_batches": (8, 4)}[counter]
    recs = [record(**{counter: v}) for v in vals]
    tr = tracing.Trace(CELL, decoded=n, kept={"decode": recs})
    assert r.read(tr) == pytest.approx(want)
    for kept in ([record(**{counter: vals[0]}), record()], [None], []):
        assert r.read(tracing.Trace(CELL, decoded=n,
                                    kept={"decode": kept})) is None
    assert r.read(tracing.Trace(CELL, kept={"decode": recs})) is None


def test_idle_share_reader():
    r = reader("device_idle_share.foreign")
    assert r.read(tracing.Trace(CELL, busy_s=0.3, window_s=1.5)) \
        == pytest.approx(80.0)
    assert r.read(tracing.Trace(CELL)) is None


def test_readers_keep_one_record_per_call():
    merged = tracing.merge(OP.SPANS, *(getattr(reader(n), "SPANS", ())
                                       for n in READERS))
    keeps = [m for m in merged if m[3]]
    assert len(keeps) == 1 and len(keeps[0][3]) == 1
    assert ("jdeflate_tpu_torch.ops.checksum", "adler32") in {
        (m, a) for m, a, _, _ in merged}
