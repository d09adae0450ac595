"""The coding stages' running max and min (jdeflate_tpu_torch/ops/scan.py
running: csrc/rowscan.cu on a card, running_ref on the CPU).

The kernel's contract is running_ref's values: the inclusive running max
or min along the last dimension of int64 rows, from each row's end where
reversed. It reaches them by another route: the rows as one flat array
(turned round as a whole where reversed) cut into tiles of 2,048, a
segmented scan whose only rule is that element i at offset off in its row
takes element i - d's value when off >= d, chunks of 32 by shuffles, warps
and tiles chained by carries.

- On the CPU: running_ref equals numpy's accumulate (flipped where
  reversed), and kernel_model, a numpy transcript of the kernel's tiles,
  warps, chunks and carries, equals running_ref, for max and min, forward
  and reversed, at every site's shape (the window anchors (16, 68,273) and
  (16, 76,481), the pack's word bounds (381,348,) and (431,748,), the
  walk's next candidate (16, 65,536), the groups (16, 8) and (16, 32), the
  precode runs (128, 316) and (512, 316)), at n = 1, at lengths a tile
  +-1 and rows of 7 and 33 that straddle tiles, on rows all at a site's
  sentinel, rising and falling rows, sparse marks and values near
  +-2^62. The coding stages call running 7 times a batch at levels 1-7
  and 9 at levels 8-9, at those sites. A CPU tensor launches nothing; a
  CPU encode counts no encode.scan_kernel.
- On a card (marker cuda): the kernel equals running_ref on the card on
  every case above; code_batch at each stage exit and encode_batch equal
  their plain route at levels 1, 6 and 9; the card route calls no
  torch.cummax or torch.cummin; a replay of the coding program equals an
  eager call and counts its launches; a 4 MiB level-9 compress_with_index
  counts 9 encode.scan_kernel a batch.

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
from jdeflate_tpu_torch.ops import scan
from jdeflate_tpu_torch.stream import zstrm

SEED = 2**33 + 2727
TILE = scan.TILE
I64 = np.iinfo(np.int64)
# the scans of one coding batch: the match walk's next candidate, the
# groups and their ends, two per tree set in the precode runs, the pack's
# word bounds, the window anchors
SCANS_PER_BATCH = {1: 7, 6: 7, 9: 9}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def kernel_model(x: np.ndarray, op: str, reverse: bool) -> np.ndarray:
    """csrc/rowscan.cu's arithmetic in numpy: the rows as one flat array in
    logical order (turned round where reversed), tiles of 2,048 as
    (tile, warp, k, lane), the segment rule off >= distance at every step,
    the aggregate kernel where a row crosses a tile's start."""
    f = np.maximum if op == "max" else np.minimum
    ident = I64.min if op == "max" else I64.max
    n, N = x.shape[-1], x.size
    src = x.reshape(-1)[::-1] if reverse else x.reshape(-1)
    tiles = -(-N // TILE)
    P = tiles * TILE
    v = np.full(P, ident, np.int64)
    v[:N] = src
    off = (np.arange(P, dtype=np.int64) % n).reshape(tiles, 8, 8, 32)
    v = v.reshape(tiles, 8, 8, 32)
    lane = np.arange(32)
    for d in (1, 2, 4, 8, 16):                    # shuffles within chunks
        b = np.concatenate([np.full(v.shape[:-1] + (d,), ident, np.int64),
                            v[..., :-d]], -1)
        v = np.where((lane >= d) & (off >= d), f(v, b), v)
    for k in range(1, 8):                         # chunks through lane 31
        v[:, :, k] = np.where(off[:, :, k] >= lane + 1,
                              f(v[:, :, k], v[:, :, k - 1, 31:32]),
                              v[:, :, k])
    t0 = np.arange(tiles, dtype=np.int64) * TILE
    wagg = v[:, :, 7, 31]
    offw = (t0[:, None] + np.arange(8) * 256 + 255) % n
    for d in (1, 2, 4):                           # the warps' last values
        b = np.concatenate([np.full((tiles, d), ident, np.int64),
                            wagg[:, :-d]], 1)
        wagg = np.where((np.arange(8) >= d) & (offw >= d * 256),
                        f(wagg, b), wagg)
    tc = np.full(tiles, ident, np.int64)
    if tiles > 1 and TILE % n:                    # the aggregate kernel
        tend = np.minimum(t0 + TILE, N) - 1
        lo = np.maximum(t0, tend - tend % n)
        agg = [f.reduce(src[lo[t]:tend[t] + 1]) for t in range(tiles)]
        for t in range(tiles):
            off0 = t0[t] % n
            if off0:
                tc[t] = f.reduce(agg[(t0[t] - off0) // TILE:t],
                                 initial=ident)
    rel = np.arange(8)[:, None] * 32 + lane + 1   # (k, lane)
    warp = np.arange(8)[:, None, None]
    wc = np.concatenate([np.full((tiles, 1), ident, np.int64),
                         wagg[:, :-1]], 1)[:, :, None, None]
    v = np.where((warp > 0) & (off >= rel), f(v, wc), v)
    v = np.where(off >= warp * 256 + rel, f(v, tc[:, None, None, None]), v)
    out = v.reshape(-1)[:N]
    return (out[::-1] if reverse else out).reshape(x.shape)


def numpy_scan(x: np.ndarray, op: str, reverse: bool) -> np.ndarray:
    f = np.maximum if op == "max" else np.minimum
    if reverse:
        return f.accumulate(x[..., ::-1], -1)[..., ::-1]
    return f.accumulate(x, -1)


# every site's shape, then the edges: n = 1, a tile +-1, rows of 7 and 33
# that straddle tiles (2,048 % n != 0) and rows of 8 that do not
SITES = [(16, 68_273), (16, 76_481), (381_348,), (431_748,), (16, 65_536),
         (16, 8), (16, 32), (128, 316), (512, 316)]
EDGES = [(1,), (9, 1), (TILE - 1,), (TILE,), (TILE + 1,), (3, TILE - 1),
         (3, TILE + 1), (300, 7), (100, 33), (600, 8)]
# the sentinels the sites fill their rows with: -1 (the anchors, the pack,
# the precode runs' starts), 1 << 20 and 1 << 30 (BIG, BIGA), bl (the
# walk), nch (the groups)
SENTINELS = (-1, 1 << 20, 1 << 30, 65_536, 8)


def make(shape, kind: str, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = shape[-1]
    idx = np.broadcast_to(np.arange(n, dtype=np.int64), shape)
    if kind == "marks":       # a site's pattern: an index where marked
        return np.where(rng.random(shape) < 0.3, idx,
                        rng.choice(SENTINELS)).astype(np.int64)
    if kind == "sparse":
        return np.where(rng.random(shape) < 0.001, idx, -1).astype(np.int64)
    if kind == "sentinel":
        return np.full(shape, rng.choice(SENTINELS), np.int64)
    if kind == "rising":
        return (idx * 3 + rng.integers(0, 3, shape)).astype(np.int64)
    if kind == "falling":
        return (n * 3 - idx * 3 - rng.integers(0, 3, shape)).astype(np.int64)
    if kind == "extreme":     # near +-2^62, and the int64 ends
        x = rng.integers(-(1 << 62) - 9, (1 << 62) + 9, shape, np.int64)
        x.reshape(-1)[::97] = I64.min
        x.reshape(-1)[50::89] = I64.max
        return x
    raise ValueError(kind)


KINDS = ("marks", "sparse", "sentinel", "rising", "falling", "extreme")
CASES = [(s, k) for s in SITES for k in ("marks", "extreme")] + \
    [(s, k) for s in EDGES for k in KINDS] + \
    [(SITES[0], k) for k in ("sparse", "sentinel", "rising", "falling")]
DIRS = [(op, rev) for op in ("max", "min") for rev in (False, True)]


def _id(case):
    shape, kind = case
    return "x".join(map(str, shape)) + "-" + kind


# ---- on the CPU ----------------------------------------------------------

@pytest.mark.parametrize("case", CASES, ids=_id)
def test_plain_route_and_kernel_model_equal_numpy(case):
    shape, kind = case
    x = make(shape, kind, SEED + len(shape) * 7 + shape[-1])
    t = torch.from_numpy(x)
    for op, rev in DIRS:
        want = numpy_scan(x, op, rev)
        got = scan.running_ref(t, op, rev)
        assert np.array_equal(got.numpy(), want), (op, rev)
        assert np.array_equal(kernel_model(x, op, rev), want), (op, rev)


def test_cpu_tensors_launch_nothing():
    x = torch.from_numpy(make((16, 5_000), "marks", SEED))
    n0 = scan.running.launches
    for op, rev in DIRS:
        assert torch.equal(scan.running(x, op, rev),
                           scan.running_ref(x, op, rev))
    assert scan.running.launches == n0
    assert scan.running in program.COUNTED
    with pytest.raises(ValueError):
        scan.running(x, "sum")


def _record_sites(monkeypatch):
    """Every call of scan.running from here on, (shape, op, reverse)."""
    rec = []
    real = scan.running

    def keep(x, op, reverse=False):
        rec.append((tuple(x.shape), op, reverse))
        return real(x, op, reverse)
    monkeypatch.setattr(scan, "running", keep)
    return rec


@pytest.mark.parametrize("level", [1, 6, 9])
def test_coding_stages_scan_at_their_sites(level, monkeypatch):
    bl, batch = 16_384, 2
    monkeypatch.setitem(tlevels._PROBE_CAP, level, 8)     # the CPU's time
    cfg = tlevels.get_level(level)
    nch = TD._nch(bl, cfg.chunk)
    data = corpus.make_payload(40_000, SEED + level, 0, corpus.MIX)
    enc = TD.RawDeflater(level=level, block_size=bl, batch=batch,
                         device="cpu")
    enc.capture_calls = True
    enc.compress(data)
    rec = _record_sites(monkeypatch)
    TD.encode_batch(*enc.last_calls[0], *enc.call_statics)
    assert len(rec) == SCANS_PER_BATCH[level]
    assert rec[0] == ((batch, bl), "min", True)            # walk_inputs
    assert rec[1:3] == [((batch, nch), "max", False),     # groups
                        ((batch, nch), "min", True)]
    for shape, op, rev in rec[3:-2]:                       # precode runs
        assert shape == (batch * nch, 316)
    assert [r[1:] for r in rec[3:-2]] == [("max", False), ("min", True)] * (
        (len(rec) - 5) // 2)
    assert len(rec[-2][0]) == 1 and rec[-2][1:] == ("max", False)  # pack
    assert rec[-1][0][0] == batch and rec[-1][1:] == ("max", False)


def test_cpu_encode_counts_no_scan_kernel():
    data = corpus.make_payload(50_000, SEED, 0, corpus.MIX)
    n0 = scan.running.launches
    zstrm.compress_with_index(data, level=6, block_size=16384, batch=2,
                              device="cpu")
    assert "encode.scan_kernel" not in trace.last_request()["counters"]
    assert scan.running.launches == n0
    assert program.launched(scan.running) == 0


# ---- on a card -----------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


BL = 65536


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=_id)
def test_kernel_equals_the_plain_route_on_card(case):
    dev = _card()
    shape, kind = case
    x = torch.from_numpy(make(shape, kind, SEED + len(shape) * 7
                              + shape[-1])).to(dev)
    for op, rev in DIRS:
        n0 = scan.running.launches
        got = scan.running(x, op, rev)
        assert scan.running.launches == n0 + 1
        want = scan.running_ref(x, op, rev)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (op, rev)


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


STAGES = ("walk", "freqs", "split", "entropy", "codes", "items", "stored",
          "pack", "offsets", "")


def _equal(got, want) -> bool:
    if isinstance(got, torch.Tensor):
        return torch.equal(got, want)
    if isinstance(got, (tuple, list)):
        return len(got) == len(want) and all(map(_equal, got, want))
    return got == want


@pytest.mark.cuda
@pytest.mark.parametrize("level", [1, 6, 9])
def test_code_batch_stages_equal_the_plain_route_on_card(level, monkeypatch):
    _card()
    calls, statics = _calls(level, monkeypatch)
    assert len(calls) == 2
    with program.eager():
        got = [[TD.encode_batch(*a, *statics, stage=s) for s in STAGES]
               for a in calls]
        monkeypatch.setattr(scan, "running", scan.running_ref)
        want = [[TD.encode_batch(*a, *statics, stage=s) for s in STAGES]
                for a in calls]
    for g, w in zip(got, want):
        for s, gs, ws in zip(STAGES, g, w):
            assert _equal(gs, ws), s or "encode_batch"


@pytest.mark.cuda
@pytest.mark.parametrize("level", [6, 9])
def test_card_route_calls_no_torch_scan(level, monkeypatch):
    _card()
    calls, statics = _calls(level, monkeypatch)

    def refuse(*a, **k):
        raise AssertionError("torch.cummax or torch.cummin on the card")
    monkeypatch.setattr(torch, "cummax", refuse)
    monkeypatch.setattr(torch, "cummin", refuse)
    with program.eager():
        for a in calls:
            TD.encode_batch(*a, *statics)


@pytest.mark.cuda
def test_code_program_replay_equals_an_eager_call_on_card(monkeypatch):
    _card()
    calls, statics = _calls(9, monkeypatch)
    bl, batch, level = statics[:3]
    program.clear()
    for data, *scalars in calls:
        sc = torch.tensor(scalars, dtype=torch.int64, device=data.device)
        with program.eager():
            match = TD._match_handle(data, sc, bl, batch, level)
            want = TD._code_handle(data, sc, *match, *statics)
        n0 = scan.running.launches
        first = program.run(TD._code_handle, (data, sc, *match), statics)
        assert program.launched(scan.running) == SCANS_PER_BATCH[9]
        again = program.run(TD._code_handle, (data, sc, *match), statics)
        assert program.launched(scan.running) == SCANS_PER_BATCH[9]
        assert scan.running.launches == n0 + 2 * SCANS_PER_BATCH[9]
        for got in (first, again):
            assert all(torch.equal(g, w) for g, w in zip(
                TD.unstamped(got), TD.unstamped(want), strict=True))
    assert program.stats["replays"] > 0


@pytest.mark.cuda
def test_scan_kernel_counts_per_batch_on_card(monkeypatch):
    _card()
    monkeypatch.setitem(tlevels._PROBE_CAP, 9, tlevels._CHAIN[9])
    data = corpus.make_payload(4 << 20, SEED, 2, corpus.MIX)
    n0 = scan.running.launches
    zstrm.compress_with_index(data, format="gzip", level=9, block_size=BL,
                              batch=16, device="cuda")
    want = 4 * SCANS_PER_BATCH[9]
    assert trace.last_request()["counters"]["encode.scan_kernel"] == want
    assert scan.running.launches == n0 + want
