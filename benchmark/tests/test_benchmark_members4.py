"""The sharded members cell (gzip6_members.4chip), its operation and its
three per-layer readers, on the CPU.

- The cell, cut to a CPU size (four CPU ranks, 4 KiB blocks two to a
  shard, a ragged payload whose last round leaves a rank empty), runs
  through harness.run_cell and is correct, traced and measured.
- Three faults, planted by wrapping the operation's deflater, each read
  not correct: a flipped byte in one member, two members swapped, a
  dropped member. (faults.py's faults wrap zstrm, which this operation
  bypasses.)
- shard_card_busy_share reads the summed encode.match_ns and
  encode.code_ns over shard.ranks times the seconds of the kept
  ShardedDeflater.compress records; shard_gather_share their shard.read
  and shard.assemble spans over their seconds; device_idle_share.members4
  the traced stretch's idle share. Each is silent where its input is
  missing: the parent's sharded call leaves no record, the CPU times no
  stage, no device timeline."""
import time

import pytest
import torch

from benchmark import harness, spec, tracing

CELL = "gzip6_members.4chip"
OP = spec.load_module("operations", "sharded_encode", needs="OPERATION")
BL, BPD, RANKS = 4096, 2, 4
SHARD = BL * BPD
N = 2 * RANKS * SHARD + 2 * SHARD + 1234


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def cpu_cap(monkeypatch):
    from jdeflate_tpu_torch.codec import levels
    monkeypatch.setitem(levels._PROBE_CAP, 6, 8)


def tiny() -> spec.Cell:
    c = spec.load_cell(CELL)
    c.config = dict(c.config, block_size=BL, blocks_per_device=BPD)
    c.config["payload"] = dict(c.config["payload"],
                               sizes={"silesia_tar": N})
    return c


def run(trace=True):
    return harness.run_cell(tiny(), 2**31 + 2424, 0.0, trace,
                            time.perf_counter(), device="cpu")


def test_the_cell():
    c = spec.load_cell(CELL)
    cfg = c.config
    assert (cfg["format"], cfg["level"], cfg["block_size"],
            cfg["blocks_per_device"], cfg["ranks"], cfg["mode"]) \
        == ("gzip", 6, 65536, 16, 4, "members")
    n = cfg["payload"]["sizes"]["silesia_tar"]
    shard = cfg["block_size"] * cfg["blocks_per_device"]
    # 203 members in 51 rounds, the last member 145,408 B
    assert (n, -(-n // shard), -(-n // (4 * shard)), n % shard) \
        == (211957760, 203, 51, 145408)
    assert c.chips == 4
    assert c.traffic == {"op": "sharded_encode", "check": {"sample": 3},
                         "index_samples": 3, "index_members": 3,
                         "trace": {"calls": 1}}
    assert [m["name"] for m in c.end_to_end] == [
        "encode_GBps", "compress_ratio", "setup_s"]
    assert [m["name"] for m in c.per_layer] == [
        "shard_card_busy_share", "shard_gather_share",
        "device_idle_share.members4"]


@pytest.mark.parametrize("trace", [True, False])
def test_sound_run_is_correct(trace):
    r = run(trace)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0
    assert r["checks"]["answers_checked"]["value"] == r["attempted"] + 1
    if trace:
        # the CPU times no stage and has no device timeline
        assert set(r["metrics"]) == {"shard_gather_share"}
        assert 0 < r["metrics"]["shard_gather_share"]["value"] < 100
    else:
        assert set(r["metrics"]) == {"encode_GBps", "compress_ratio",
                                     "setup_s"}


class Faulty:
    """The deflater with `how` applied to every blob it returns."""

    def __init__(self, real, how):
        self.real = real
        self.how = how

    def compress(self, data):
        blob, info = self.real.compress(data)
        return self.how(blob, info), info


def _members(blob, info):
    return [blob[off:off + ln] for off, ln, *_ in info["members"]]


def _flip(blob, info):
    off, ln = info["members"][1][:2]
    k = off + ln // 2
    return blob[:k] + bytes([blob[k] ^ 0x5A]) + blob[k + 1:]


def _swap(blob, info):
    m = _members(blob, info)
    m[2], m[3] = m[3], m[2]
    return b"".join(m)


def _drop(blob, info):
    m = _members(blob, info)
    del m[4]
    return b"".join(m)


@pytest.mark.parametrize("how", [_flip, _swap, _drop])
def test_fault_is_not_correct(monkeypatch, how):
    real = OP.OPERATION.prepare

    def prepare(self):
        real(self)
        self.deflater = Faulty(self.deflater, how)

    monkeypatch.setattr(OP.OPERATION, "prepare", prepare)
    r = run()
    assert r["failed"] == 0 and not r["correct"], r["checks"]


def record(op="ShardedDeflater.compress", seconds=2.0, spans=None,
           **counters):
    return {"id": 1, "op": op, "seconds": seconds, "spans": spans or {},
            "counters": counters}


def reader(name):
    return spec.load_module("layer_metrics", name)


def test_busy_share_reader():
    r = reader("shard_card_busy_share")
    full = {"encode.match_ns": 1_000_000_000, "encode.code_ns": 2_000_000_000,
            "shard.ranks": 4}
    recs = [record(**full), record(seconds=1.0, **dict(full, **{
        "shard.ranks": 2}))]
    tr = tracing.Trace(CELL, kept={"ShardedDeflater.compress": recs})
    # 6 s of stage time over 4 x 2 + 2 x 1 card seconds
    assert r.read(tr) == pytest.approx(60.0)
    for kept in ([record(**{k: v for k, v in full.items()
                            if k != "encode.code_ns"})],
                 [record(op="zstrm.compress_with_index", **full)],
                 [None], []):
        tr = tracing.Trace(CELL, kept={"ShardedDeflater.compress": kept})
        assert r.read(tr) is None


def test_gather_share_reader():
    r = reader("shard_gather_share")
    spans = {"shard": 1.9, "shard.read": 0.5, "shard.assemble": 0.3}
    recs = [record(spans=spans), record(seconds=2.0, spans=spans)]
    tr = tracing.Trace(CELL, kept={"ShardedDeflater.compress": recs})
    assert r.read(tr) == pytest.approx(40.0)
    for kept in ([record(spans={"shard.read": 0.5})],
                 [record(op="RawDeflater.compress", spans=spans)], [None],
                 []):
        tr = tracing.Trace(CELL, kept={"ShardedDeflater.compress": kept})
        assert r.read(tr) is None


def test_idle_share_reader():
    r = reader("device_idle_share.members4")
    assert r.read(tracing.Trace(CELL, busy_s=2.7, window_s=3.0)) \
        == pytest.approx(10.0)
    assert r.read(tracing.Trace(CELL)) is None


def test_readers_keep_one_record_per_call():
    merged = tracing.merge(OP.SPANS, *(reader(n).SPANS for n in (
        "shard_card_busy_share", "shard_gather_share")))
    keeps = [m for m in merged if m[3]]
    assert len(keeps) == 1 and len(keeps[0][3]) == 1
