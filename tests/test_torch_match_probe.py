"""The match finder's bucket probe (jdeflate_tpu_torch/ops/lz77.py
match_probe: csrc/lz77probe.cu on a card, match_probe_ref on the CPU).

The kernel's contract is the plain loop's result, reached by a different
walk: each sorted index visits its same-hash predecessors newest first and
stops at the first that fails a condition monotone in the probe number
(the row's start, another hash, a distance past the window, a position
before valid_from) or once its best length reaches the cap 4 * PW, and a
candidate whose byte at the best length differs from the position's is
rejected without a full compare.

- On the CPU: walk_model, a numpy transcript of that walk, equals
  match_probe_ref at levels 1, 6 and 9 (each level's own depth and words)
  on seeded inputs, with rows longer than 32 KiB, and every case shows the
  exits it is built for; together the cases take every exit. The
  candidates the walk visits equal chip_smoke.probe_visits, the count the
  card's diagnostic takes from the kernel's result. A CPU tensor
  takes the plain loop and launches nothing; program.launched reports
  the launches of the last run alone; a CPU encode counts no
  encode.match_kernel.
- On a card (marker cuda): the kernel equals match_probe_ref on the card
  at levels 1, 6 and 9 on mixed, all-zero, random and period-3 bytes, a
  first block behind a short dictionary and a short final block;
  find_matches_batch and encode_batch equal their plain route on the same
  batches; a replay of the match program equals an eager call and counts
  its launch; a 4 MiB level-9 compress_with_index counts one
  encode.match_kernel per batch.

Exact equality everywhere. The tests import no JAX.
"""
import collections

import numpy as np
import pytest
import torch

import chip_smoke
from benchmark import corpus
from jdeflate_tpu_torch import trace
from jdeflate_tpu_torch.codec import deflate as TD
from jdeflate_tpu_torch.codec import levels as tlevels
from jdeflate_tpu_torch.codec import program
from jdeflate_tpu_torch.formats import constants as C
from jdeflate_tpu_torch.ops import lz77
from jdeflate_tpu_torch.stream import zstrm

HALO, PAD = TD.HALO, TD.PAD
SEED = 2**33 + 2121
# (probes, prefix words) of each level at its own depth, whatever cap a
# module that imports the JAX package has set (ROADMAP C4)
DEPTH = {lv: (tlevels._CHAIN[lv], 16 if lv >= 8 else 8) for lv in (1, 6, 9)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def walk_model(ext, skey, valid_from, k: int, pw: int):
    """The kernel's walk in numpy, vectorised over sorted indices: per
    probe number, the indices still walking test their next candidate.
    Returns (plen, pdist) in position order, the count of each exit and
    the candidates visited (those that pass the conditions)."""
    cap = 4 * pw
    B, nh = skey.shape
    plen = np.zeros((B, nh), np.int64)
    pdist = np.zeros((B, nh), np.int64)
    exits = collections.Counter()
    visits = 0
    span = np.arange(cap)
    for b in range(B):
        r = ext[b].astype(np.int64)
        key = skey[b]
        p, h = key & 0x1FFFF, key >> 17
        j = np.arange(nh)
        best = np.zeros(nh, np.int64)
        bdist = np.zeros(nh, np.int64)
        walking = np.ones(nh, bool)
        for kk in range(1, k + 1):
            c = key[np.maximum(j - kk, 0)]
            cp, d = c & 0x1FFFF, p - (c & 0x1FFFF)
            reasons = (("start", j - kk < 0), ("hash", (c >> 17) != h),
                       ("window", (d <= 0) | (d > C.WINDOW_SIZE)),
                       ("valid_from", cp < valid_from[b]))
            for name, fails in reasons:
                hit = walking & fails
                exits[name] += int(hit.sum())
                walking &= ~hit
            idx = np.nonzero(walking)[0]
            if not idx.size:
                break
            visits += idx.size
            idx = idx[r[cp[idx] + best[idx]] == r[p[idx] + best[idx]]]
            neq = (r[p[idx, None] + span] != r[cp[idx, None] + span])
            length = np.where(neq.any(1), neq.argmax(1), cap)
            up = length > best[idx]
            best[idx[up]] = length[up]
            bdist[idx[up]] = d[idx[up]]
            capped = idx[up][length[up] == cap]
            exits["cap"] += capped.size
            walking[capped] = False
        exits["depth"] += int(walking.sum())
        plen[b, p] = best
        pdist[b, p] = bdist
    return plen, pdist, exits, visits


def _mixed(n: int, seed: int) -> np.ndarray:
    return np.frombuffer(corpus.make_payload(n, seed, 0, corpus.MIX),
                         np.uint8)


def _markers(n: int, seed: int) -> np.ndarray:
    """Random bytes with one 4-byte marker every 701 bytes: a bucket whose
    48 newest entries span more than the window."""
    a = np.random.default_rng(seed).integers(0, 256, n, np.uint8)
    for s in range(0, n - 4, 701):
        a[s:s + 4] = (0xA5, 0x5A, 0xC3, 0x3C)
    return a


def _period3(n: int, seed: int) -> np.ndarray:
    return np.resize(np.random.default_rng(seed).integers(0, 256, 3,
                                                          np.uint8), n)


def _random(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, n, np.uint8)


def _zeros(n: int, seed: int) -> np.ndarray:
    return np.zeros(n, np.uint8)


# name: (bytes, positions per row, valid_from of each row, level, exits it
# must show)
CPU_CASES = {
    "mixed_l6": (_mixed, 34_000, (0, 2_000), 6, {"start", "hash",
                                                  "valid_from"}),
    "markers_l6": (_markers, 40_000, (0,), 6, {"hash", "window"}),
    "dictionary_l9": (_mixed, 33_000, (20_000,), 9, {"hash",
                                                     "valid_from"}),
    "zeros_l9": (_zeros, 3_000, (0,), 9, {"start", "cap"}),
    "period3_l6": (_period3, 6_000, (0, 0), 6, {"start", "cap"}),
    "random_l1": (_random, 12_000, (0,), 1, {"hash", "depth"}),
}


def _rows(make, nh: int, nrows: int, seed: int) -> torch.Tensor:
    """(nrows, nh + PAD) u8 rows of fresh bytes, zero pad after."""
    ext = np.zeros((nrows, nh + PAD), np.uint8)
    for b in range(nrows):
        ext[b, :nh] = make(nh, seed + b)
    return torch.from_numpy(ext)


# ---- on the CPU ----------------------------------------------------------

@pytest.mark.parametrize("case", sorted(CPU_CASES))
def test_walk_model_equals_the_plain_loop(case):
    make, nh, vfrom, level, want_exits = CPU_CASES[case]
    k, pw = DEPTH[level]
    ext = _rows(make, nh, len(vfrom), SEED)
    vf = torch.tensor(vfrom, dtype=torch.int64)
    _, skey = lz77.probe_keys(ext.to(torch.int64), nh)
    plen, pdist = lz77.match_probe_ref(ext, skey, vf, k, pw)
    mlen, mdist, exits, visits = walk_model(ext.numpy(), skey.numpy(),
                                            vfrom, k, pw)
    assert np.array_equal(mlen, plen.numpy())
    assert np.array_equal(mdist, pdist.numpy())
    assert chip_smoke.probe_visits(skey, vf, plen, pdist, k, pw) == visits
    assert (plen > 0).any() and int(plen.max()) <= 4 * pw
    assert {e for e, n in exits.items() if n} >= want_exits, dict(exits)
    assert sum(exits.values()) == plen.numel()


def test_every_exit_is_taken():
    names = set().union(*(c[4] for c in CPU_CASES.values()))
    assert names == {"start", "hash", "window", "valid_from", "cap", "depth"}


def test_cpu_tensors_take_the_plain_loop():
    ext = _rows(_mixed, 5_000, 2, SEED)
    vf = torch.tensor([0, 100])
    _, skey = lz77.probe_keys(ext.to(torch.int64), 5_000)
    n0 = lz77.match_probe.launches
    got = lz77.match_probe(ext, skey, vf, 8, 8)
    want = lz77.match_probe_ref(ext, skey, vf, 8, 8)
    assert lz77.match_probe.launches == n0
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_launched_counts_the_last_run(monkeypatch):
    def stub(x):
        stub.launches += 1
        return (x + 1,)
    stub.launches = 0
    monkeypatch.setattr(program, "COUNTED", program.COUNTED + (stub,))
    x = torch.zeros(3)
    program.run(lambda t: stub(stub(t)[0]), (x,))
    assert program.launched(stub) == 2
    program.run(lambda t: (t + 1,), (x,))
    assert program.launched(stub) == 0
    assert program.launched(lz77.match_probe) == 0


def test_cpu_encode_counts_no_match_kernel():
    data = corpus.make_payload(50_000, SEED, 0, corpus.MIX)
    zstrm.compress_with_index(data, level=1, block_size=16384, batch=2,
                              device="cpu")
    assert "encode.match_kernel" not in trace.last_request()["counters"]


# ---- on a card -----------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


BL = 65536
CARD_INPUTS = {
    "mixed": lambda: (_rows(_mixed, HALO + BL, 4, SEED), (0, 0, 0, 0)),
    "zeros": lambda: (_rows(_zeros, HALO + BL, 2, SEED), (0, 0)),
    "random": lambda: (_rows(_random, HALO + BL, 2, SEED), (0, 0)),
    "period3": lambda: (_rows(_period3, HALO + BL, 2, SEED), (0, 0)),
    # a first block behind a 5,000-byte dictionary
    "dictionary": lambda: (_rows(_mixed, HALO + BL, 2, SEED),
                           (HALO - 5_000, HALO)),
    # a short final block: 1,000 bytes, then the zeros of the pad
    "short_final": lambda: (_rows(lambda n, s: np.concatenate(
        [_mixed(HALO + 1_000, s), np.zeros(n - HALO - 1_000, np.uint8)]),
        HALO + BL, 2, SEED), (0, 0)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("level", [1, 6, 9])
@pytest.mark.parametrize("inputs", sorted(CARD_INPUTS))
def test_kernel_equals_the_plain_loop_on_card(inputs, level):
    dev = _card()
    k, pw = DEPTH[level]
    ext, vfrom = CARD_INPUTS[inputs]()
    ext = ext.to(dev)
    vf = torch.tensor(vfrom, dtype=torch.int64, device=dev)
    _, skey = lz77.probe_keys(ext.to(torch.int64), HALO + BL)
    n0 = lz77.match_probe.launches
    got = lz77.match_probe(ext, skey, vf, k, pw)
    assert lz77.match_probe.launches == n0 + 1
    want = lz77.match_probe_ref(ext, skey, vf, k, pw)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


def _calls(level: int, monkeypatch):
    """The encode_batch calls of a 1.5 MiB payload behind a 5,000-byte
    dictionary (a first block with valid_from > 0, a short last batch)."""
    monkeypatch.setitem(tlevels._PROBE_CAP, level, tlevels._CHAIN[level])
    data = corpus.make_payload(3 << 19, SEED + level, 0, corpus.MIX)
    enc = TD.RawDeflater(level=level, block_size=BL, batch=16, device="cuda")
    enc.capture_calls = True
    with program.eager():
        enc.compress(data, dictionary=corpus.make_payload(5_000, SEED, 1))
    return enc.last_calls, enc.call_statics


@pytest.mark.cuda
@pytest.mark.parametrize("level", [1, 6, 9])
def test_match_and_encode_batch_equal_the_plain_route_on_card(level,
                                                              monkeypatch):
    _card()
    calls, statics = _calls(level, monkeypatch)
    assert len(calls) == 2
    with program.eager():
        got = [(TD.encode_batch(*a, *statics, stage="match"),
                TD.encode_batch(*a, *statics)) for a in calls]
        monkeypatch.setattr(lz77, "match_probe", lz77.match_probe_ref)
        want = [(TD.encode_batch(*a, *statics, stage="match"),
                 TD.encode_batch(*a, *statics)) for a in calls]
    for (gm, ge), (wm, we) in zip(got, want):
        assert all(torch.equal(g, w) for g, w in zip(gm, wm))
        assert len(ge) == len(we)
        assert all(torch.equal(g, w) if isinstance(g, torch.Tensor)
                   else g == w for g, w in zip(ge, we))


@pytest.mark.cuda
def test_match_program_replay_equals_an_eager_call_on_card(monkeypatch):
    _card()
    calls, statics = _calls(9, monkeypatch)
    bl, batch, level = statics[:3]
    program.clear()
    for data, *scalars in calls:
        sc = torch.tensor(scalars, dtype=torch.int64, device=data.device)
        with program.eager():
            want = TD._match_handle(data, sc, bl, batch, level)
        n0 = lz77.match_probe.launches
        first = program.run(TD._match_handle, (data, sc), (bl, batch, level))
        assert program.launched(lz77.match_probe) == 1
        again = program.run(TD._match_handle, (data, sc), (bl, batch, level))
        assert program.launched(lz77.match_probe) == 1
        assert lz77.match_probe.launches == n0 + 2     # eager or replay
        for got in (first, again):     # (length, dist); then the stamps
            assert all(torch.equal(g, w) for g, w in zip(got[:2], want[:2]))
    assert program.stats["replays"] > 0


@pytest.mark.cuda
def test_match_kernel_counts_one_per_batch_on_card(monkeypatch):
    _card()
    monkeypatch.setitem(tlevels._PROBE_CAP, 9, tlevels._CHAIN[9])
    data = corpus.make_payload(4 << 20, SEED, 2, corpus.MIX)
    n0 = lz77.match_probe.launches
    zstrm.compress_with_index(data, format="gzip", level=9, block_size=BL,
                              batch=16, device="cuda")
    assert trace.last_request()["counters"]["encode.match_kernel"] == 4
    assert lz77.match_probe.launches == n0 + 4
