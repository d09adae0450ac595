"""Parity of the port's data-parallel compression
(jdeflate_tpu_torch.parallel) with the JAX package on the CPU: the port's
ShardedDeflater on four virtual CPU ranks against the JAX ShardedDeflater on
four devices of the 8-device CPU mesh (tests/conftest.py). Both modes, a
ragged tail shard, several rounds, empty input, the checksum combine, the
verify/fault-hook retry, and decompress_members. Tolerance: exact equality
of blobs, member info (offsets, lengths, index dicts) and retries."""
import gzip
import hashlib
import struct
import sys
import time
import zlib

import numpy as np
import pytest
import torch

import chip_smoke
from benchmark import corpus as bcorpus
from benchmark import members_reference
from conftest import make_corpus
from jdeflate_tpu.codec import inflate as jinf
from jdeflate_tpu.codec import levels as jlevels
from jdeflate_tpu.parallel import mesh as jmesh
from jdeflate_tpu.parallel import shard as jshard
from jdeflate_tpu_torch import trace
from jdeflate_tpu_torch.codec import inflate as tinf
from jdeflate_tpu_torch.codec import levels as tlevels
from jdeflate_tpu_torch.parallel import mesh as tmesh
from jdeflate_tpu_torch.parallel import shard as tshard
from jdeflate_tpu_torch.utils import errors

# both sides run the same (CPU-capped) probe depths, tests/conftest.py
tlevels._PROBE_CAP.update(jlevels._PROBE_CAP)

# one block size, shard size and level for the file, so the JAX sharded
# encoder compiles once
BL, BPD, LEVEL = 2048, 2, 6
ROUND = 4 * BPD * BL


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small; torch's default thread pool only spins
    against the other test workers' JAX compiles."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def meshes():
    return tmesh.make_mesh(4, device="cpu"), jmesh.make_mesh(4)


def _pair(meshes, mode, verify=False, level=LEVEL, bl=BL, bpd=BPD):
    kw = dict(level=level, block_size=bl, blocks_per_device=bpd, mode=mode,
              verify=verify)
    return (tshard.ShardedDeflater(mesh=meshes[0], **kw),
            jshard.ShardedDeflater(mesh=meshes[1], **kw))


def _same_index(got, want):
    assert got.keys() == want.keys()
    for key in want:
        if key != "win":
            assert got[key] == want[key], key
    assert len(got["win"]) == len(want["win"])
    for a, b in zip(got["win"], want["win"]):
        assert (a is None) == (b is None)
        if b is not None:
            np.testing.assert_array_equal(a, b)


def _same_info(got, want):
    assert got.keys() == want.keys()
    assert (got["mode"], got["n"]) == (want["mode"], want["n"])
    assert len(got.get("members", [])) == len(want.get("members", []))
    for g, w in zip(got.get("members", []), want.get("members", [])):
        assert len(g) == len(w) and g[:3] == w[:3]
        if len(w) > 3:
            _same_index(g[3], w[3])


@pytest.mark.parametrize("mode,kind,n", [
    ("members", "text", 2 * ROUND + 777),      # 3 rounds, ragged tail shard
    ("stream", "binary", 2 * ROUND + 123),
    ("members", "runs", BL + 5),               # one rank of four busy
])
def test_sharded_matches_jax(corpus, meshes, mode, kind, n):
    data = corpus(kind, n)
    t, j = _pair(meshes, mode)
    tb, ti = t.compress(data)
    jb, ji = j.compress(data)
    assert tb == jb
    _same_info(ti, ji)
    assert gzip.decompress(tb) == data
    if mode == "members":
        assert len(ti["members"]) == -(-n // (BPD * BL))
        # the port decodes the JAX blob with its index on the windowed
        # path, and its own blob without one
        tinf.STATS_LOG.clear()
        assert tshard.decompress_members(jb, ji, device="cpu") == data
        assert "win" in [k for k, _, _ in tinf.STATS_LOG]
        assert all(e == 0 for _, _, e in tinf.STATS_LOG)
        assert tshard.decompress_members(tb, device="cpu") == data
        assert jshard.decompress_members(tb, ti) == data


@pytest.mark.parametrize("mode", ["members", "stream"])
def test_empty_input_matches_jax(meshes, mode):
    t, j = _pair(meshes, mode)
    tb, ti = t.compress(b"")
    jb, ji = j.compress(b"")
    assert tb == jb and ti == ji
    assert gzip.decompress(tb) == b""
    assert tshard.decompress_members(tb, ti, device="cpu") == b""


def test_checksum_combine_matches_zlib(corpus, meshes):
    data = corpus("text", ROUND + 99)
    t, j = _pair(meshes, "stream")
    tb, _ = t.compress(data)
    assert tb == j.compress(data)[0]
    crc, isize = struct.unpack("<II", tb[-8:])
    assert (crc, isize) == (zlib.crc32(data), len(data))
    assert tshard.checksums_sharded(
        [torch.zeros(tshard.HALO + 4, dtype=torch.uint8)], [0]) == [0]


def _killer(rank, how):
    killed = []

    def hook(k, seg):
        if k == rank and not killed:
            killed.append(k)
            return how(seg)
        return seg
    return hook


@pytest.mark.parametrize("mode,rank,how", [
    ("members", 1, lambda seg: seg[:4] + bytes(8) + seg[12:]),
    ("stream", 2, lambda seg: seg[:-6] + bytes(6)),
])
def test_fault_retry_matches_jax(corpus, meshes, mode, rank, how):
    """A corrupted shard is detected and encoded again: the same retries,
    blob and index as the JAX package."""
    data = corpus("binary" if mode == "stream" else "text", 2 * ROUND + 50)
    t, j = _pair(meshes, mode, verify=True)
    t.fault_hook = _killer(rank, how)
    j.fault_hook = _killer(rank, how)
    tb, ti = t.compress(data)
    jb, ji = j.compress(data)
    assert t.retries and t.retries == j.retries
    assert tb == jb
    _same_info(ti, ji)
    assert gzip.decompress(tb) == data
    if mode == "members":
        assert tshard.decompress_members(tb, ti, device="cpu") == data


@pytest.mark.parametrize("mode,rank", [("members", 1), ("stream", 2)])
def test_fault_retry_retakes_the_crc_on_the_host(corpus, meshes, monkeypatch,
                                                 mode, rank):
    """A failed rank's crc32 is not trusted: with its shard and its crc32
    both corrupted, the retry takes the crc32 from the source bytes, and the
    blob equals the JAX package's, whose rank fails in its shard only."""
    data = corpus("text", 2 * ROUND + 50)
    t, j = _pair(meshes, mode, verify=True)
    t.fault_hook = _killer(rank, lambda seg: seg[:4] + bytes(8) + seg[12:])
    j.fault_hook = _killer(rank, lambda seg: seg[:4] + bytes(8) + seg[12:])
    real = tshard.checksums_sharded
    wrong = []

    def bad_crc(data_sh, lens):
        crcs = real(data_sh, lens)
        if not wrong:
            wrong.append(crcs[rank])
            crcs[rank] ^= 0xDEADBEEF
        return crcs

    monkeypatch.setattr(tshard, "checksums_sharded", bad_crc)
    tb, ti = t.compress(data)
    jb, ji = j.compress(data)
    assert wrong and t.retries == j.retries == [(rank * BPD * BL, BPD * BL)]
    assert tb == jb
    _same_info(ti, ji)
    assert gzip.decompress(tb) == data


def test_detector_error_of_any_kind_means_retry(corpus, meshes, monkeypatch):
    """The failure detector takes any error of the decode as a failed
    shard, as the JAX package's does, not only the codec's own errors."""
    data = corpus("text", ROUND)
    t, j = _pair(meshes, "members", verify=True)
    t.fault_hook = _killer(1, lambda seg: seg[:4] + bytes(8) + seg[12:])
    j.fault_hook = _killer(1, lambda seg: seg[:4] + bytes(8) + seg[12:])
    raised = []

    def faulty(real):
        def decode(*a, **k):
            try:
                return real(*a, **k)
            except errors.JDeflateError as e:
                raised.append(e)
                raise RuntimeError("decoder fault") from e
        return decode

    # the detector decodes natively where the library builds, else on the
    # host's Python decoder
    monkeypatch.setattr(tshard.native, "inflate", faulty(tshard.native.inflate))
    monkeypatch.setattr(tshard.hi, "inflate_raw", faulty(tshard.hi.inflate_raw))
    tb, ti = t.compress(data)
    jb, ji = j.compress(data)
    assert raised and t.retries == j.retries == [(BPD * BL, BPD * BL)]
    assert tb == jb
    _same_info(ti, ji)


def test_verify_without_fault_is_clean(corpus, meshes):
    data = corpus("text", ROUND)
    t, _ = _pair(meshes, "members", verify=True)
    plain, _ = _pair(meshes, "members")
    assert t.compress(data)[0] == plain.compress(data)[0]
    assert not t.retries


@pytest.mark.parametrize("name", list(chip_smoke.L9_MEMBER_CASES))
def test_level9_member_index_matches_jax(meshes, name):
    """ROADMAP C11: at levels 8-9 the splitter works in 2 KiB chunks, but
    the JAX sharded encoder builds each member's index with the 8 KiB
    default chunk, so it lists only the sub-blocks on 8 KiB seams. The port
    follows the reference: the same blobs and the same index, and each
    member's windowed batch stops short of the member's 8 KiB, the native
    decoder doing the rest, with the JAX package's per-batch record.

    ROADMAP C16: the bytes come from a generator of the case's own (seed
    and sha256 in chip_smoke.L9_MEMBER_CASES), not from the session-scoped
    corpus fixture, whose state depends on the tests that ran before. In
    "match_across_seam" a match crosses a 2 KiB split seam of the second
    member and its batch produces 4,097 bytes, on both packages."""
    seed, sha, produced = chip_smoke.L9_MEMBER_CASES[name]
    rng = np.random.default_rng(seed)
    data = b"".join(make_corpus(rng, k, 2048) for k in ("text", "random") * 4)
    assert hashlib.sha256(data).hexdigest() == sha
    assert chip_smoke.l9_member_data(seed) == data
    t, j = _pair(meshes, "members", level=9, bl=4096, bpd=2)
    tb, ti = t.compress(data)
    jb, ji = j.compress(data)
    assert tb == jb
    _same_info(ti, ji)
    got = [m[3]["block_bytes"] for m in ti["members"]]
    want = [m[3]["block_bytes"] for m in ji["members"]]
    assert got == want == [[0, 4096]] * 2
    records = []
    for log, decode in (
            (tinf.STATS_LOG,
             lambda: tshard.decompress_members(tb, ti, device="cpu")),
            (jinf.STATS_LOG, lambda: jshard.decompress_members(jb, ji))):
        log.clear()
        assert decode() == data
        records.append([(k, int(p), int(e)) for k, p, e in log])
    assert records[0] == records[1]
    assert all(k == "win" and p < 8192 and e for k, p, e in records[0])
    assert tuple(p for _, p, _ in records[0]) == produced


def test_mesh_rules():
    assert tmesh.make_mesh(3, device="cpu") == (torch.device("cpu"),) * 3
    with pytest.raises(errors.IncorrectUseError):
        tmesh.make_mesh(device="cpu")
    with pytest.raises(ValueError):
        tshard.ShardedDeflater(mesh=tmesh.make_mesh(1, device="cpu"),
                               mode="ring")
    if not torch.cuda.is_available():
        # a CUDA mesh never moves to the CPU
        with pytest.raises(errors.IncorrectUseError):
            tmesh.make_mesh(2)
        with pytest.raises(errors.IncorrectUseError):
            tshard.ShardedDeflater()
    else:
        with pytest.raises(errors.IncorrectUseError):
            tmesh.make_mesh(torch.cuda.device_count() + 1)


@pytest.mark.cuda
def test_two_cards_match_four_ranks_on_one(corpus):
    """The blob does not depend on the mesh: ranks on cuda:0 and cuda:1
    give the bytes of four ranks on cuda:0, in both modes."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs 2 CUDA devices")
    data = corpus("text", 3 * ROUND + 17)
    for mode in ("members", "stream"):
        kw = dict(level=LEVEL, block_size=BL, blocks_per_device=BPD,
                  mode=mode)
        two, ti = tshard.ShardedDeflater(mesh=tmesh.make_mesh(2),
                                         **kw).compress(data)
        four, fi = tshard.ShardedDeflater(mesh=["cuda:0"] * 4,
                                          **kw).compress(data)
        assert two == four
        _same_info(ti, fi)
        assert gzip.decompress(two) == data
        if mode == "members":
            assert tshard.decompress_members(two, ti, device="cuda:1") == data


@pytest.mark.cuda
def test_four_cards_match_four_ranks_on_one():
    """The benchmark's gzip6_members deployment at its shapes (level 6,
    64 KiB blocks, 16 a shard) on four cards: the blob and info of a
    ragged payload (10 members in 3 rounds, two ranks empty in the last)
    equal those of four ranks on cuda:0, the members pass the plain
    reference (benchmark/members_reference.py) and decode on cuda:3, and
    each call's record, on the replayed programs of its second call,
    counts one probe kernel launch a batch (encode.match_kernel), the
    stages' device times, and its rounds, members and ranks."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices")
    bl, bpd = 1 << 16, 16
    shard = bl * bpd
    n = 9 * shard + 12345
    data = bcorpus.make_payload(n, 2**31 + 24, 0)
    kw = dict(level=6, block_size=bl, blocks_per_device=bpd, mode="members")
    got = []
    for mesh in (tmesh.make_mesh(4), ["cuda:0"] * 4):
        enc = tshard.ShardedDeflater(mesh=mesh, **kw)
        enc.compress(data)                  # captures the programs
        got.append((*enc.compress(data), trace.last_request()))
    (fb, fi, frec), (ob, oi, orec) = got
    assert fb == ob
    _same_info(fi, oi)
    found = members_reference.check_members(fb, data, shard, fi)
    assert (found["rejected"], found["differing"], found["info_faults"]) \
        == (0, 0, [])
    assert tshard.decompress_members(fb, fi, device="cuda:3") == data
    members = -(-n // shard)
    for rec in (frec, orec):
        c = rec["counters"]
        assert rec["op"] == "ShardedDeflater.compress"
        assert c["encode.match_kernel"] == members
        assert c["encode.match_ns"] > 0 and c["encode.code_ns"] > 0
        assert c["encode.entropy_ns"] > 0 and c["encode.launch_wait_ns"] >= 0
        assert (c["shard.rounds"], c["shard.members"], c["shard.ranks"]) \
            == (-(-n // (4 * shard)), members, 4)


def seam_search(lo: int, hi: int) -> list:
    """The port's per-batch records of the level-9 members case on
    chip_smoke.l9_member_data(seed) for seeds lo..hi-1, at the tests' probe
    depths: how L9_MEMBER_CASES' seeds were found. Returns the seeds where
    a member's windowed batch produces other than 4,096 bytes."""
    t = tshard.ShardedDeflater(mesh=tmesh.make_mesh(4, device="cpu"),
                               level=9, block_size=4096, blocks_per_device=2,
                               mode="members")
    found = []
    for seed in range(lo, hi):
        t0 = time.perf_counter()
        data = chip_smoke.l9_member_data(seed)
        blob, info = t.compress(data)
        tinf.STATS_LOG.clear()
        assert tshard.decompress_members(blob, info, device="cpu") == data
        rec = list(tinf.STATS_LOG)
        print(seed, rec, f"{time.perf_counter() - t0:.2f} s", flush=True)
        if any(p != 4096 for _, p, _ in rec):
            found.append(seed)
    return found


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_parallel.py LO HI
    torch.set_num_threads(1)
    print("seeds whose batch crosses a seam:",
          seam_search(int(sys.argv[1]), int(sys.argv[2])))
