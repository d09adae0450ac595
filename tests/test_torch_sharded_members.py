"""The port's ShardedDeflater in members mode on a mesh of four CPU ranks,
held to the benchmark's plain reference for multi-member gzip files
(benchmark/members_reference.py), and the request record a sharded call
leaves (trace.last_request()).

- The members of a seeded ragged payload (neither whole rounds nor whole
  shards, so a rank is empty in the last round) pass the reference, and
  each member's index passes reference.check_index.
- The reference finds each planted fault: one flipped byte, two members
  swapped, the last member dropped, a trailer's ISIZE altered.
- The record is op ShardedDeflater.compress with the spans shard,
  shard.upload, shard.launch, shard.read and shard.assemble, and the
  counters shard.rounds, shard.members, shard.ranks and shard.retries
  equal to what n, the shard size and the rank count give.
- AHEAD rounds are launched before the first round is read back."""
import numpy as np
import pytest
import torch

from benchmark import corpus, generator, members_reference
from jdeflate_tpu_torch import trace
from jdeflate_tpu_torch.codec import levels
from jdeflate_tpu_torch.parallel import mesh as tmesh
from jdeflate_tpu_torch.parallel import shard as tshard

RANKS, BL, BPD = 4, 4096, 2
SHARD = BL * BPD
ROUND = RANKS * SHARD
# two whole rounds, two whole shards and a ragged one: 11 members in three
# rounds, the last round's fourth rank empty
N = 2 * ROUND + 2 * SHARD + 1234
SEED = 2**31 + 2424


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def encoded():
    """(payload, blob, info, request record) of one sharded call, at the
    CPU tests' probe depth (tests/conftest.py)."""
    cap = levels._PROBE_CAP.get(6)
    levels._PROBE_CAP[6] = 8
    try:
        data = corpus.make_payload(N, SEED, 0)
        enc = tshard.ShardedDeflater(mesh=tmesh.make_mesh(RANKS, device="cpu"),
                                     level=6, block_size=BL,
                                     blocks_per_device=BPD, mode="members")
        blob, info = enc.compress(data)
        return data, blob, info, trace.last_request()
    finally:
        if cap is None:
            del levels._PROBE_CAP[6]
        else:
            levels._PROBE_CAP[6] = cap


def test_members_pass_the_reference(encoded):
    data, blob, info, _ = encoded
    got = members_reference.check_members(blob, data, SHARD, info)
    assert (got["rejected"], got["differing"], got["info_faults"]) \
        == (0, 0, [])
    assert len(got["members"]) == len(info["members"]) == -(-N // SHARD)
    assert [m[:2] for m in info["members"]] == got["members"]
    rng = np.random.default_rng(SEED)
    for k, (off, ln, size, index) in enumerate(info["members"]):
        faults = generator.member_faults(
            blob[off:off + ln], index, index["header_len"],
            data[k * SHARD:k * SHARD + size], rng, 2)
        assert (faults["streams_rejected"], faults["bytes_differing"],
                faults["index_faults"]) == (0, 0, 0), faults["notes"]


def _members(blob, info):
    return [blob[off:off + ln] for off, ln, *_ in info["members"]]


def _flip(blob, info):
    off, ln = info["members"][3][:2]
    k = off + ln // 2
    return blob[:k] + bytes([blob[k] ^ 0x5A]) + blob[k + 1:]


def _swap(blob, info):
    m = _members(blob, info)
    m[4], m[5] = m[5], m[4]
    return b"".join(m)


def _drop_last(blob, info):
    return b"".join(_members(blob, info)[:-1])


def _isize(blob, info):
    off, ln = info["members"][6][:2]
    k = off + ln - 1                        # ISIZE's last byte
    return blob[:k] + bytes([blob[k] ^ 0x01]) + blob[k + 1:]


@pytest.mark.parametrize("fault", [_flip, _swap, _drop_last, _isize])
def test_reference_finds_each_fault(encoded, fault):
    data, blob, info, _ = encoded
    got = members_reference.check_members(fault(blob, info), data, SHARD,
                                          info)
    assert got["rejected"] >= 1, got
    if fault is _swap:
        # both slots hold the other's bytes; info's offsets disagree
        assert got["differing"] > 0 and got["info_faults"]
    if fault is _drop_last:
        assert got["differing"] == N - (N // SHARD) * SHARD
        assert len(got["members"]) == len(info["members"]) - 1


def test_reference_finds_bytes_around_the_members(encoded):
    data, blob, info, _ = encoded
    for bad in (b"\0" + blob, blob[:100] + b"\0" + blob[100:], blob + b"\0"):
        assert members_reference.check_members(bad, data, SHARD)[
            "rejected"] >= 1


def test_request_record(encoded):
    _, _, info, rec = encoded
    assert rec["op"] == "ShardedDeflater.compress"
    assert {"shard", "shard.upload", "shard.launch", "shard.read",
            "shard.assemble"} <= set(rec["spans"])
    assert "shard.gather" not in rec["spans"]       # one process, no group
    assert {k: rec["counters"][k] for k in (
        "shard.rounds", "shard.members", "shard.ranks", "shard.retries")} \
        == {"shard.rounds": -(-N // ROUND), "shard.members": -(-N // SHARD),
            "shard.ranks": RANKS, "shard.retries": 0}
    assert rec["spans"]["shard"] <= rec["seconds"]
    assert sum(rec["spans"][s] for s in (
        "shard.upload", "shard.launch", "shard.read", "shard.assemble")) \
        <= rec["spans"]["shard"]
    assert len(info["members"]) == rec["counters"]["shard.members"]


@pytest.mark.parametrize("n,rounds,members,ranks", [
    (SHARD + 5, 1, 2, 2),                   # two ranks of four busy
    (ROUND, 1, 4, 4),
    (ROUND + 1, 2, 5, 4),
])
def test_counters_follow_n_and_shards(n, rounds, members, ranks):
    data = corpus.make_payload(n, SEED + n, 0)
    enc = tshard.ShardedDeflater(mesh=tmesh.make_mesh(RANKS, device="cpu"),
                                 level=1, block_size=BL,
                                 blocks_per_device=BPD, mode="members")
    blob, info = enc.compress(data)
    c = trace.last_request()["counters"]
    assert (c["shard.rounds"], c["shard.members"], c["shard.ranks"],
            c["shard.retries"]) == (rounds, members, ranks, 0)
    got = members_reference.check_members(blob, data, SHARD, info)
    assert (got["rejected"], got["differing"], got["info_faults"]) \
        == (0, 0, [])


def test_rounds_are_launched_ahead_of_their_reads(monkeypatch):
    """AHEAD rounds are launched past the one being read, so the cards
    encode while the host reads; the members are the same."""
    from jdeflate_tpu_torch.codec import deflate as De
    order = []
    launch, read = tshard.encode_sharded, De.read_batch

    def launched(*a):
        order.append("launch")
        return launch(*a)

    def reads(*a):
        order.append("read")
        return read(*a)

    monkeypatch.setattr(tshard, "encode_sharded", launched)
    monkeypatch.setattr(De, "read_batch", reads)
    n = 4 * ROUND + 5                       # five rounds
    data = corpus.make_payload(n, SEED + 5, 0)
    enc = tshard.ShardedDeflater(mesh=tmesh.make_mesh(RANKS, device="cpu"),
                                 level=1, block_size=BL,
                                 blocks_per_device=BPD, mode="members")
    blob, info = enc.compress(data)
    assert order.index("read") == tshard.AHEAD + 1
    assert order.count("launch") == 5 and order[-1] == "read"
    got = members_reference.check_members(blob, data, SHARD, info)
    assert (got["rejected"], got["differing"], got["info_faults"]) \
        == (0, 0, [])
