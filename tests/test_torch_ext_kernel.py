"""The exact extension's stage 1 (jdeflate_tpu_torch/ops/lz77.py
extend_top: csrc/lz77extend.cu on a card, extend_top_ref on the CPU).

The kernel's contract is the plain loop's result, reached in one pass: a
position with a length > 0 whose distance d is one of topd (distinct, so
at most one of the loop's passes selects it) takes 0 where it lies before
d, else the count of equal bytes ext[k] == ext[k - d] from itself to the
first mismatch, the cap 258 or the row's end; every other position keeps
its length.

- On the CPU: the stage's own inputs, recorded from find_matches_batch at
  levels 1, 6 and 9 (each level's T, prefix words and rescue) for mixed
  corpus bytes, zero bytes, random bytes (topd padded with zero-count
  distances, 0 among them), period-3 bytes, a short final block and a
  first block behind a short dictionary, and synthetic inputs (d = 0
  selected, positions before d, runs to the row's end), reach the exits
  they are built for, read off the plain loop's result; together they
  take every exit the kernel has. A CPU tensor takes the plain loop and
  launches nothing; a CPU encode counts no encode.ext_kernel.
- On a card (marker cuda): the kernel equals extend_top_ref on the card at
  levels 1, 6 and 9 on the same six inputs at the encoder's row shape and
  on the synthetic ones; find_matches_batch and encode_batch equal their
  plain route; a replay of the match program equals an eager call and
  counts its launch; a 4 MiB level-9 compress_with_index counts one
  encode.ext_kernel per batch.

Exact equality everywhere. The tests import no JAX.
"""
import numpy as np
import pytest
import torch

from benchmark import corpus
from jdeflate_tpu_torch import trace
from jdeflate_tpu_torch.codec import deflate as TD
from jdeflate_tpu_torch.codec import levels as tlevels
from jdeflate_tpu_torch.codec import program
from jdeflate_tpu_torch.formats import constants as C
from jdeflate_tpu_torch.ops import lz77
from jdeflate_tpu_torch.stream import zstrm

HALO, PAD = TD.HALO, TD.PAD
SEED = 2**33 + 2525


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def exits(plen, pdist, topd, row: int, got) -> dict:
    """How many selected positions took each exit of the rule, read off
    the plain loop's result `got`: "before" (j < d, so 0), "cap" (258
    equal bytes), "row_end" (the run reached the row's end), "mismatch"
    (the rest)."""
    sel = (plen > 0) & torch.isin(pdist, topd)
    j = torch.arange(plen.shape[1]).expand_as(plen)
    before = sel & (j < pdist)
    cap = sel & ~before & (got == C.MAX_MATCH)
    row_end = sel & ~before & ~cap & (j + got == row)
    mismatch = sel & ~before & ~cap & ~row_end
    return {"before": int(before.sum()), "cap": int(cap.sum()),
            "row_end": int(row_end.sum()), "mismatch": int(mismatch.sum())}


def _mixed(n: int, seed: int, halo: int) -> np.ndarray:
    return np.frombuffer(corpus.make_payload(n, seed, 0, corpus.MIX),
                         np.uint8)


def _period3(n: int, seed: int, halo: int) -> np.ndarray:
    return np.resize(np.random.default_rng(seed).integers(0, 256, 3,
                                                          np.uint8), n)


def _random(n: int, seed: int, halo: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, n, np.uint8)


def _zeros(n: int, seed: int, halo: int) -> np.ndarray:
    return np.zeros(n, np.uint8)


def _short_final(n: int, seed: int, halo: int) -> np.ndarray:
    """The halo, then a block of 1,000 bytes: the rest of the row is the
    zeros of an unfilled block and the pad."""
    return np.concatenate([_mixed(halo + 1_000, seed, halo),
                           np.zeros(n - halo - 1_000, np.uint8)])


# name: (bytes of the halo and block, valid_from kind, exits it must show).
# Every candidate of a real row lies at or after the row's start, so no
# position lies before its distance there: the synthetic rows take that
# exit. Random bytes have almost no matches at the distances selected.
INPUTS = {
    "mixed": (_mixed, "full", {"mismatch"}),
    "zeros": (_zeros, "full", {"cap"}),
    "random": (_random, "full", set()),
    "period3": (_period3, "full", {"cap"}),
    "short_final": (_short_final, "full", {"cap", "mismatch"}),
    # a first block behind a 1,000-byte dictionary (valid_from > 0)
    "dictionary": (_mixed, "dictionary", {"mismatch"}),
}


def stage_inputs(make, vkind: str, level: int, halo: int, bl: int,
                 nrows: int, dev, k: int):
    """(ext, plen, pdist, topd) that find_matches_batch hands extend_top
    for `nrows` rows of `make`'s bytes at `level` (its T, prefix words,
    rescue, rounds), probed k deep, recorded through the plain loop."""
    cfg = tlevels.get_level(level)
    nh = halo + bl
    ext = np.zeros((nrows, nh + PAD), np.uint8)
    for b in range(nrows):
        ext[b, :nh] = make(nh, SEED + 7 * b + level, halo)
    ext = torch.from_numpy(ext).to(dev)
    vfrom = [halo - 1_000 if vkind == "dictionary" else 0] * nrows
    vf = torch.tensor(vfrom, dtype=torch.int64, device=dev)
    blen = torch.full((nrows,), bl, dtype=torch.int64, device=dev)
    rec = []
    real = lz77.extend_top

    def keep(*a):
        rec.append(tuple(x.clone() for x in a))
        return lz77.extend_top_ref(*a)
    lz77.extend_top = keep
    try:
        with program.eager():
            lz77.find_matches_batch(
                ext, blen, vf, halo, bl, PAD, k, ext_top=cfg.ext_top,
                ext_rounds=cfg.ext_rounds, rescue=cfg.rescue,
                probe_words=cfg.probe_words, ext_mdiv=cfg.ext_mdiv)
    finally:
        lz77.extend_top = real
    assert len(rec) == 1
    return rec[0]


def synthetic(seed: int, dev, pad: int = 5):
    """Rows of runs and random bytes with a pad shorter than 258 (so runs
    reach the row's end), lengths and distances drawn at random, and a topd
    that holds 0 and distances larger than some selected positions."""
    rng = np.random.default_rng(seed)
    B, nh = 3, 6_000
    row = nh + pad
    ext = rng.integers(0, 4, (B, row), np.uint8)
    ext[0, 1_000:2_500] = 7                          # long runs at d = 1, 2
    ext[1, -700:] = np.resize(np.array([1, 2, 3], np.uint8), 700)
    ext[2, :] = np.resize(rng.integers(0, 256, 5, np.uint8), row)
    topd = np.array([0, 1, 2, 3, 5, 9, 700, 4_000], np.int64)
    pdist = rng.choice(np.concatenate([topd, [4, 6, 8, 11]]), (B, nh))
    plen = rng.integers(0, 40, (B, nh)) * (rng.random((B, nh)) < 0.8)
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                 for x in (ext, plen, pdist, topd))


# ---- on the CPU ----------------------------------------------------------

CPU_HALO, CPU_BL = 4_096, 12_288


@pytest.mark.parametrize("level", [1, 6, 9])
@pytest.mark.parametrize("inputs", sorted(INPUTS))
def test_stage_inputs_take_their_exits(inputs, level):
    make, vkind, want_exits = INPUTS[inputs]
    ext, plen, pdist, topd = stage_inputs(make, vkind, level, CPU_HALO,
                                          CPU_BL, 2, "cpu", 8)
    assert topd.shape == (tlevels.get_level(level).ext_top,)
    n0 = lz77.extend_top.launches
    got = lz77.extend_top(ext, plen, pdist, topd)
    assert lz77.extend_top.launches == n0
    took = exits(plen, pdist, topd, ext.shape[1], got)
    assert {e for e, n in took.items() if n} >= want_exits, took
    assert took["before"] == 0
    if inputs == "random":
        assert 0 in topd.tolist()         # zero-count bins pad topd


@pytest.mark.parametrize("seed", [0, 1])
def test_synthetic_rows_take_every_exit(seed):
    ext, plen, pdist, topd = synthetic(SEED + seed, "cpu")
    got = lz77.extend_top_ref(ext, plen, pdist, topd)
    took = exits(plen, pdist, topd, ext.shape[1], got)
    assert all(took.values()), took
    d0 = (pdist == 0) & (plen > 0)
    # d = 0 compares each byte with itself: to the cap or the row's end
    assert d0.any() and (got[d0] > 0).all()


def test_cpu_tensors_take_the_plain_loop():
    ext, plen, pdist, topd = synthetic(SEED, "cpu")
    n0 = lz77.extend_top.launches
    got = lz77.extend_top(ext, plen, pdist, topd)
    assert lz77.extend_top.launches == n0
    assert torch.equal(got, lz77.extend_top_ref(ext, plen, pdist, topd))
    assert lz77.extend_top in program.COUNTED


def test_cpu_encode_counts_no_ext_kernel():
    data = corpus.make_payload(50_000, SEED, 0, corpus.MIX)
    n0 = lz77.extend_top.launches
    zstrm.compress_with_index(data, level=6, block_size=16384, batch=2,
                              device="cpu")
    assert "encode.ext_kernel" not in trace.last_request()["counters"]
    assert lz77.extend_top.launches == n0
    assert program.launched(lz77.extend_top) == 0


# ---- on a card -----------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


BL = 65536


@pytest.mark.cuda
@pytest.mark.parametrize("level", [1, 6, 9])
@pytest.mark.parametrize("inputs", sorted(INPUTS))
def test_kernel_equals_the_plain_loop_on_card(inputs, level):
    dev = _card()
    make, vkind, _ = INPUTS[inputs]
    args = stage_inputs(make, vkind, level, HALO, BL, 4 if inputs == "mixed"
                        else 2, dev, tlevels._CHAIN[level])
    n0 = lz77.extend_top.launches
    got = lz77.extend_top(*args)
    assert lz77.extend_top.launches == n0 + 1
    want = lz77.extend_top_ref(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("pad", [0, 5, PAD])
def test_kernel_equals_the_plain_loop_on_synthetic_rows_on_card(pad):
    dev = _card()
    args = synthetic(SEED + pad, dev, pad)
    got = lz77.extend_top(*args)
    want = lz77.extend_top_ref(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


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
        monkeypatch.setattr(lz77, "extend_top", lz77.extend_top_ref)
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
        n0 = lz77.extend_top.launches
        first = program.run(TD._match_handle, (data, sc), (bl, batch, level))
        assert program.launched(lz77.extend_top) == 1
        again = program.run(TD._match_handle, (data, sc), (bl, batch, level))
        assert program.launched(lz77.extend_top) == 1
        assert lz77.extend_top.launches == n0 + 2     # eager or replay
        for got in (first, again):     # (length, dist); then the stamps
            assert all(torch.equal(g, w) for g, w in zip(got[:2], want[:2]))
    assert program.stats["replays"] > 0


@pytest.mark.cuda
def test_ext_kernel_counts_one_per_batch_on_card(monkeypatch):
    _card()
    monkeypatch.setitem(tlevels._PROBE_CAP, 9, tlevels._CHAIN[9])
    data = corpus.make_payload(4 << 20, SEED, 2, corpus.MIX)
    n0 = lz77.extend_top.launches
    zstrm.compress_with_index(data, format="gzip", level=9, block_size=BL,
                              batch=16, device="cuda")
    assert trace.last_request()["counters"]["encode.ext_kernel"] == 4
    assert lz77.extend_top.launches == n0 + 4
