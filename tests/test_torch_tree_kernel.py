"""The two-queue Huffman code lengths of levels 8-9 (jdeflate_tpu_torch/ops/
huffman.py code_lengths: csrc/huffman2q.cu on a card, code_lengths_ref on
the CPU).

The kernel's contract is the plain loop's result for every input, reached
by a different walk: the keys ranked by counting (stable by symbol), the
merge of the m used symbols on one lane (m - 1 steps, the cursors clamped
as the plain gathers clamp, sums saturating at _INF), node depths in one
pass from the root down, the Kraft repair while the excess is positive
within the plain loop's trip count, and each rank's length by
torch.searchsorted's own binary search.

- On the CPU: tree_model, a transcript of that walk in Python, equals
  code_lengths_ref on seeded rows of 286, 30 and 19 symbols at 15 and 7
  bits, on rows of 0, 1 and 2 used symbols, on all-equal frequencies, on
  the Fibonacci caterpillars whose Kraft excess reaches the trip count, on
  weights at and near _INF (saturated sums, cursors clamped past the ends)
  and on the rows of a level-9 encode; every case shows what it is built
  for. A CPU tensor takes the plain loop and launches nothing; a CPU
  level-9 encode builds two trees a batch and counts no
  encode.tree_kernel.
- On a card (marker cuda): the kernel equals code_lengths_ref on the card
  on those rows and on the (512, 286) and (512, 30) rows of a level-9
  batch of benchmark/corpus.py's payload; encode_batch at levels 8 and 9
  equals its plain route; a replay of the coding stages' program equals an
  eager call and counts its two launches; a 4 MiB level-9
  compress_with_index counts two encode.tree_kernel a batch.

Exact equality everywhere. The tests import no JAX.
"""
import itertools

import numpy as np
import pytest
import torch

from benchmark import corpus
from jdeflate_tpu_torch import trace
from jdeflate_tpu_torch.codec import deflate as TD
from jdeflate_tpu_torch.codec import levels as tlevels
from jdeflate_tpu_torch.codec import program
from jdeflate_tpu_torch.formats import constants as C
from jdeflate_tpu_torch.ops import huffman
from jdeflate_tpu_torch.stream import zstrm

INF = huffman._INF
SEED = 2**33 + 2323


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _wrap64(x: int) -> int:
    """x as int64 arithmetic leaves it (two's complement wrap)."""
    x &= (1 << 64) - 1
    return x - (1 << 64) if x >> 63 else x


def _upper_bound(cum: list, v: int) -> int:
    """torch.searchsorted(cum, v, right=True): its binary search, sorted
    row or not."""
    lo, hi = 0, len(cum)
    while lo < hi:
        mid = lo + ((hi - lo) >> 1)
        if not cum[mid] > v:
            lo = mid + 1
        else:
            hi = mid
    return lo


def row_model(f, max_bits: int):
    """The kernel's walk over one row of frequencies. Returns the lengths
    in symbol order and what the row exercised: the Kraft excess before the
    repair, whether a cursor was clamped, a sum saturated, and the running
    sums were out of order."""
    n = len(f)
    key = np.where(f > 0, f, INF).astype(np.int64)
    m = int((f > 0).sum())
    sym = np.arange(n)
    rank = ((key[None, :] < key[:, None])
            | ((key[None, :] == key[:, None])
               & (sym[None, :] < sym[:, None]))).sum(1)
    wleaf = [0] * n + [INF]
    order = [0] * n
    for i in range(n):
        wleaf[rank[i]] = int(key[i])
        order[rank[i]] = i
    seen = {"excess": 0, "clamped": False, "saturated": False,
            "unsorted": False}
    by_rank = [0] * n
    if m >= 2:
        node_w = [INF] * n
        leaf_par, node_par, depth = [0] * (n + 1), [0] * n, [0] * n
        li = ni = 0
        for t in range(m - 1):
            w = []
            for _ in range(2):
                seen["clamped"] |= li > n or ni > n - 1
                lc, nc = min(li, n), min(ni, n - 1)
                if wleaf[lc] <= node_w[nc]:
                    leaf_par[lc] = t
                    li += 1
                    w.append(wleaf[lc])
                else:
                    node_par[nc] = t
                    ni += 1
                    w.append(node_w[nc])
            s = _wrap64(w[0] + w[1])
            seen["saturated"] |= s >= INF
            node_w[t] = min(s, INF)
        root = m - 2
        for i in range(root - 1, -1, -1):
            depth[i] = depth[node_par[i]] + 1
        bl = [0] * (max_bits + 1)
        for r in range(m):
            bl[min(depth[leaf_par[r]] + 1, max_bits)] += 1
        excess = sum(c << (max_bits - b) for b, c in enumerate(bl)) \
            - (1 << max_bits)
        seen["excess"] = excess
        steps = n - max_bits - 1
        while steps > 0 and excess > 0:
            b = max((c for c in range(1, max_bits) if bl[c] > 0), default=0)
            bl[b] -= 1
            bl[b + 1] += 2
            bl[max_bits] -= 1
            steps -= 1
            excess -= 1
        cum = list(itertools.accumulate(bl))
        seen["unsorted"] = cum != sorted(cum)
        for r in range(m):
            by_rank[r] = _upper_bound(cum, m - 1 - r)
    elif m == 1:
        by_rank[:2] = [1] * min(n, 2)
    out = [0] * n
    for r in range(n):
        out[order[r]] = by_rank[r]
    return out, seen


def tree_model(freqs: np.ndarray, max_bits: int):
    """row_model over each row of (G, n) frequencies: (G, n) lengths and
    the rows' `seen` facts."""
    rows = [row_model(f, max_bits) for f in np.asarray(freqs, np.int64)]
    return (np.array([r[0] for r in rows], np.int64).reshape(freqs.shape),
            [r[1] for r in rows])


def _fib(n: int) -> np.ndarray:
    f = [1, 1]
    while len(f) < n:
        f.append(f[-1] + f[-2])
    return np.asarray(f[:n], np.int64)


def _seeded(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    k = int(rng.integers(2, n))
    pow2 = np.zeros(n, np.int64)
    pow2[rng.permutation(n)[:k]] = 2 ** rng.integers(0, 14, k)
    return np.stack([
        rng.integers(0, 100, n),
        rng.integers(0, 4, n),                               # many ties
        (rng.random(n) < 0.1) * rng.integers(1, 10_000, n),  # sparse
        (rng.random(n) < 0.5) * rng.integers(1, 1 << 20, n),
        rng.geometric(0.05, n) - 1,                          # skewed
        pow2,
    ]).astype(np.int64)


def _used(n: int, seed: int) -> np.ndarray:
    """Rows of 0, 1 and 2 used symbols, at the ends and inside."""
    rows = np.zeros((6, n), np.int64)
    rows[1, 0] = 5
    rows[2, n - 1] = 1
    rows[3, n // 2] = 1 << 20
    rows[4, [0, n - 1]] = (3, 7)
    rows[5, [n // 3, n // 2]] = (9, 9)
    return rows


def _equal(n: int, seed: int) -> np.ndarray:
    return np.stack([np.ones(n, np.int64), np.full(n, 12345, np.int64),
                     np.where(np.arange(n) % 3 == 0, 7, 0)])


def _fibonacci(n: int, seed: int) -> np.ndarray:
    """The caterpillar tree n - 1 deep (past 40 terms the rest are 1s,
    keeping the total under _INF as every real block does), and the same
    counts reversed and shuffled (ties broken by symbol elsewhere in the
    order)."""
    f = np.concatenate([_fib(min(n, 40)), np.ones(max(n - 40, 0), np.int64)])
    return np.stack([f, f[::-1],
                     np.random.default_rng(seed).permutation(f)])


def _near_inf(n: int, seed: int) -> np.ndarray:
    """Weights at and near _INF: every symbol at _INF (a key tied with the
    unused ones; leaves win every tie with the saturated nodes, so the leaf
    cursor runs onto the pad), _INF - 1 and _INF + 1, halves whose sums
    saturate, and sums past 2**63 that wrap as int64 does."""
    rng = np.random.default_rng(seed)
    half = INF // 2 + rng.integers(-3, 4, n)
    rows = [np.full(n, INF), np.full(n, INF - 1), np.full(n, INF + 1),
            half, np.where(np.arange(n) % 2 == 0, INF, 1),
            np.where(rng.random(n) < 0.5, INF + rng.integers(-2, 3, n),
                     rng.integers(0, 100, n)),
            np.where(np.arange(n) < 3, 1 << 62, rng.integers(1, 5, n))]
    return np.stack(rows).astype(np.int64)


# name: (rows of n symbols from (n, seed), what the rows must show)
KINDS = {
    "seeded": (_seeded, ()),
    "used_0_1_2": (_used, ()),
    "all_equal": (_equal, ()),
    "fibonacci": (_fibonacci, ("excess_at_bound",)),
    "near_inf": (_near_inf, ("clamped", "saturated")),
}
SHAPES = [(286, 15), (30, 15), (19, 15), (286, 7), (30, 7), (19, 7)]


def _rows(kind: str, n: int, L: int) -> np.ndarray:
    return KINDS[kind][0](n, SEED + 1000 * n + L)


# ---- on the CPU ----------------------------------------------------------

@pytest.mark.parametrize("n,L", SHAPES)
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_tree_model_equals_the_plain_loop(kind, n, L):
    freqs = _rows(kind, n, L)
    want = huffman.code_lengths_ref(torch.from_numpy(freqs), L).numpy()
    got, seen = tree_model(freqs, L)
    np.testing.assert_array_equal(got, want)
    for fact in KINDS[kind][1]:
        if fact == "excess_at_bound":     # the caterpillar, if it fits
            excess = seen[0]["excess"]
            assert excess == n - L - 1 if n <= 40 else excess > 0
        else:
            assert any(s[fact] for s in seen), fact
    if kind == "used_0_1_2":
        assert [int((r > 0).sum()) for r in freqs] == [0, 1, 1, 1, 2, 2]


def test_the_cases_show_every_edge():
    """Taken together, the cases repair an excess, clamp a cursor,
    saturate a sum and search running sums that are out of order (a tree
    of 286 leaves cannot fit in 7 bits)."""
    seen = [s for kind in KINDS for n, L in SHAPES
            for s in tree_model(_rows(kind, n, L), L)[1]]
    assert any(s["excess"] > 0 for s in seen)
    for fact in ("clamped", "saturated", "unsorted"):
        assert any(s[fact] for s in seen), fact


@pytest.fixture(scope="module")
def level9_cpu():
    """A CPU level-9 compress_with_index of 48 KiB in blocks of 16 KiB,
    two a batch (the probe depth capped at 8, as the CPU encoder tests
    cap it): the two-queue calls (freqs, max_bits), the
    wrapper's launches around it and the request's counters."""
    calls = []
    ref = huffman.code_lengths_ref

    def record(freqs, max_bits):
        calls.append((freqs.clone(), max_bits))
        return ref(freqs, max_bits)

    cap = tlevels._PROBE_CAP[9]
    tlevels._PROBE_CAP[9] = 8
    huffman.code_lengths_ref = record
    n0 = huffman.code_lengths.launches
    try:
        data = corpus.make_payload(48 << 10, SEED, 0, corpus.MIX)
        zstrm.compress_with_index(data, level=9, block_size=16384, batch=2,
                                  device="cpu")
    finally:
        huffman.code_lengths_ref = ref
        tlevels._PROBE_CAP[9] = cap
    return (calls, huffman.code_lengths.launches - n0,
            dict(trace.last_request()["counters"]))


def test_tree_model_equals_the_plain_loop_on_level9_rows(level9_cpu):
    calls = level9_cpu[0]
    assert sorted({(f.shape[1], L) for f, L in calls}) == [
        (30, C.MAX_CODE_BITS), (286, C.MAX_CODE_BITS)]
    for freqs, L in calls:
        want = huffman.code_lengths_ref(freqs, L).numpy()
        np.testing.assert_array_equal(tree_model(freqs.numpy(), L)[0], want)


def test_cpu_level9_encode_counts_no_tree_kernel(level9_cpu):
    calls, launches, counters = level9_cpu
    assert len(calls) == 2 * 2            # two batches, two trees each
    assert launches == 0
    assert "encode.tree_kernel" not in counters


def test_cpu_tensors_take_the_plain_loop():
    freqs = torch.from_numpy(_rows("seeded", 286, 15))
    n0 = huffman.code_lengths.launches
    got = huffman.code_lengths(freqs, 15)
    assert huffman.code_lengths.launches == n0
    assert torch.equal(got, huffman.code_lengths_ref(freqs, 15))
    assert huffman.code_lengths in program.COUNTED


# ---- on a card -----------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def level9_rows(dev) -> list:
    """The frequencies that the two-queue kernel gets in one 1 MiB level-9
    batch of benchmark/corpus.py's payload at the level's full probe depth
    (the entropy stage's (512, 286) literal/length and (512, 30) distance
    rows), each with its max_bits."""
    calls = []
    real = TD._block_entropy

    def record(lfreq, dfreq, *args, **kw):
        calls.extend([(lfreq.clone(), C.MAX_CODE_BITS),
                      (dfreq.clone(), C.MAX_CODE_BITS)])
        return real(lfreq, dfreq, *args, **kw)

    cap = tlevels._PROBE_CAP[9]
    tlevels._PROBE_CAP[9] = tlevels._CHAIN[9]
    TD._block_entropy = record
    try:
        data = corpus.make_payload(1 << 20, SEED, 1, corpus.MIX)
        with program.eager():
            TD.RawDeflater(level=9, block_size=1 << 16, batch=16,
                           device=dev).compress(data)
    finally:
        TD._block_entropy = real
        tlevels._PROBE_CAP[9] = cap
    return calls


@pytest.mark.cuda
@pytest.mark.parametrize("n,L", SHAPES)
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_kernel_equals_the_plain_loop_on_card(kind, n, L):
    dev = _card()
    freqs = torch.from_numpy(_rows(kind, n, L)).to(dev)
    n0 = huffman.code_lengths.launches
    got = huffman.code_lengths(freqs, L)
    assert huffman.code_lengths.launches == n0 + 1
    want = huffman.code_lengths_ref(freqs, L)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_kernel_equals_the_plain_loop_on_level9_rows_on_card():
    dev = _card()
    calls = level9_rows(dev)
    assert [tuple(f.shape) for f, _ in calls] == [(512, 286), (512, 30)]
    for freqs, L in calls:
        got = huffman.code_lengths(freqs, L)
        want = huffman.code_lengths_ref(freqs, L)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def _calls(level: int, monkeypatch):
    """The encode_batch calls of a 1.5 MiB payload behind a 5,000-byte
    dictionary (a first block with valid_from > 0, a short last batch)."""
    monkeypatch.setitem(tlevels._PROBE_CAP, level, tlevels._CHAIN[level])
    data = corpus.make_payload(3 << 19, SEED + level, 0, corpus.MIX)
    enc = TD.RawDeflater(level=level, block_size=1 << 16, batch=16,
                         device="cuda")
    enc.capture_calls = True
    with program.eager():
        enc.compress(data, dictionary=corpus.make_payload(5_000, SEED, 1))
    return enc.last_calls, enc.call_statics


@pytest.mark.cuda
@pytest.mark.parametrize("level", [8, 9])
def test_encode_batch_equals_the_plain_route_on_card(level, monkeypatch):
    _card()
    calls, statics = _calls(level, monkeypatch)
    assert len(calls) == 2
    with program.eager():
        n0 = huffman.code_lengths.launches
        got = [TD.encode_batch(*a, *statics) for a in calls]
        assert huffman.code_lengths.launches == n0 + 2 * len(calls)
        monkeypatch.setattr(huffman, "code_lengths",
                            huffman.code_lengths_ref)
        want = [TD.encode_batch(*a, *statics) for a in calls]
    for ge, we in zip(got, want):
        assert len(ge) == len(we)
        assert all(torch.equal(g, w) if isinstance(g, torch.Tensor)
                   else g == w for g, w in zip(ge, we))


@pytest.mark.cuda
def test_code_program_replay_equals_an_eager_call_on_card(monkeypatch):
    _card()
    calls, statics = _calls(9, monkeypatch)
    bl, batch, level = statics[:3]
    program.clear()
    for data, *scalars in calls:
        sc = torch.tensor(scalars, dtype=torch.int64, device=data.device)
        match = program.run(TD._match_handle, (data, sc), (bl, batch, level))
        with program.eager():
            want = TD._code_handle(data, sc, *match, *statics)
        n0 = huffman.code_lengths.launches
        first = program.run(TD._code_handle, (data, sc, *match), statics)
        assert program.launched(huffman.code_lengths) == 2
        again = program.run(TD._code_handle, (data, sc, *match), statics)
        assert program.launched(huffman.code_lengths) == 2
        assert huffman.code_lengths.launches == n0 + 4   # eager or replay
        for got in (first, again):
            assert all(torch.equal(g, w) for g, w in zip(
                TD.unstamped(got), TD.unstamped(want), strict=True))
    assert program.stats["replays"] > 0


@pytest.mark.cuda
def test_tree_kernel_counts_two_per_batch_on_card(monkeypatch):
    _card()
    monkeypatch.setitem(tlevels._PROBE_CAP, 9, tlevels._CHAIN[9])
    data = corpus.make_payload(4 << 20, SEED, 2, corpus.MIX)
    n0 = huffman.code_lengths.launches
    zstrm.compress_with_index(data, format="gzip", level=9,
                              block_size=1 << 16, batch=16, device="cuda")
    assert trace.last_request()["counters"]["encode.tree_kernel"] == 8
    assert huffman.code_lengths.launches == n0 + 8
    zstrm.compress_with_index(data[:1 << 20], format="gzip", level=6,
                              block_size=1 << 16, batch=16, device="cuda")
    assert "encode.tree_kernel" not in trace.last_request()["counters"]
