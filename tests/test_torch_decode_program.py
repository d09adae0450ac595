"""The port's decode programs (jdeflate_tpu_torch/codec/inflate.py run
through codec/program.py) on the CPU, and the bounded program cache.

- The guard: tests/test_torch_program.py's NoHostRead(uploads=True) runs
  around every decode program of a whole decompress from the program's
  second call on (the first, eager call makes the resident tables):
  windowed with engines 2 and 5, anchored with the plain assembly and with
  the v1 match expansion, and dense. The five kernel wrappers (B1, B2,
  B4, B5, B6) run with the guard suspended: on the card each is one
  launch, and what a capture records is not their plain version.
- Exact parity with the JAX functions on the same numpy inputs:
  decode_batch_windows_stacked at a row other than 0 whose word window
  clamps at the end of the stream, behind a preset dictionary (hist > 0);
  decode_batch_anchored with the plain assembly and, against the JAX
  Pallas kernel in interpret mode, the v1 expansion; decode_batch (dense)
  and its roll_window. Out, produced, err and the next window.
- lz_resolve's fixed trip against the JAX while_loop, on a chain that
  needs every round and one that needs a single round, with positions
  outside the mask still moving when the loop stops.
- adler32 against zlib on runs of 0xFF at and past 8,421,505 bytes, where
  a plain int32 sum of the bytes overflows.
- The cache's eviction order, pool retirement and accounting, with stub
  programs and pools of stated sizes.
- On a card (marker cuda): crc32 over 2 to 64 MiB in 1 MiB steps, one
  kernel launch each and no program cached, keeps the rise of
  torch.cuda.memory_reserved under 2 GiB; a dead graph's
  private pool stays reserved until torch.cuda.empty_cache(); each decode
  branch captured equals eager, also with a budget so small that the
  programs evict each other.

Corpora from tests/conftest.py::make_corpus with seeded generators; every
case shares one batch size. Tolerance: exact equality everywhere.
"""
import collections
import types
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from torch.utils._python_dispatch import _disable_current_modes

from chip_smoke import symbol_anchors
from conftest import make_corpus
from test_torch_program import NoHostRead
from jdeflate_tpu.codec import inflate as jinf
from jdeflate_tpu.ops import decode as jdk
from jdeflate_tpu_torch.codec import inflate as tinf
from jdeflate_tpu_torch.codec import program
from jdeflate_tpu_torch.ops import checksum as cs
from jdeflate_tpu_torch.ops import decode as tdk
from jdeflate_tpu_torch.ops import expand as tex
from jdeflate_tpu_torch.ops import expand2 as tex2
from jdeflate_tpu_torch.ops import expand5 as tex5
from jdeflate_tpu_torch.ops import walk as twalk

HALO = tinf.HALO
# small batches, so each stream spans several halo-chained batches
BATCH = dict(max_batch_bits=1 << 18, max_batch_blocks=8,
             max_batch_out=1 << 16)
KERNELS = ((twalk, "walk_checked"), (tex2, "expand_tokens"),
           (tex5, "seed_plane"), (tex5, "resolve"), (tex, "expand_matches"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's default thread pool only spins against the other test
    workers' JAX compiles."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mixed(seed: int, n: int) -> bytes:
    rng = np.random.default_rng(seed)
    q = n // 4
    return b"".join(make_corpus(rng, k, m) for k, m in (
        ("text", q), ("binary", q), ("runs", q), ("random", q // 4),
        ("text", n - 3 * q - q // 4)))


def _zlib_raw(data: bytes, level: int = 6, zdict: bytes = b"") -> bytes:
    co = (zlib.compressobj(level, zlib.DEFLATED, -15, zdict=zdict) if zdict
          else zlib.compressobj(level, zlib.DEFLATED, -15))
    return co.compress(data) + co.flush()


def _anchors_index(raw: bytes) -> dict:
    index = tinf.RawInflater(device="cpu").build_index(raw)
    return {**{k: v for k, v in index.items() if k != "win"},
            "anchors": symbol_anchors(raw, index, "cpu")}


def _suspended(fn):
    """fn run with every dispatch mode off: a kernel wrapper, one launch
    on the card."""
    def call(*a, **k):
        with _disable_current_modes():
            return fn(*a, **k)
    return call


def _halo_before(dictionary: bytes, data: bytes, o0: int) -> np.ndarray:
    h = (dictionary + data[:o0])[-HALO:]
    out = np.zeros(HALO, np.uint8)
    out[HALO - len(h):] = np.frombuffer(h, np.uint8)
    return out


def _plan(raw: bytes, index: dict, dictionary: bytes = b""):
    """The port's plan of one decompress, its device inputs on the CPU,
    and each planned item's output offset."""
    td = tinf.RawInflater(device="cpu", **BATCH)
    W_pad = tinf._bucket((len(raw) >> 2) + 18, 1 << 13)
    work, _ = td._plan(raw, index, dictionary, W_pad)
    up = td._upload(raw, work, dictionary, W_pad)
    offs, pos = [], 0
    for kind, item in work:
        offs.append(pos)
        pos += len(item) if kind == "stored" else (item[5] if kind == "win"
                                                   else item[12])
    return work, up, offs, W_pad


# ---- the guard, around every decode program of a decompress -------------

GUARD_CASES = ["win_engine2", "win_engine5", "anchored_plain",
               "anchored_kernel", "dense"]


@pytest.mark.parametrize("case", GUARD_CASES)
def test_decode_programs_make_no_host_read(case, monkeypatch):
    """Each decode program, from its second call on, reads nothing back,
    uploads nothing and makes no shape depend on the data; the second call
    gives the first call's result, and the decode gives the data."""
    data = _mixed(3, 1 << 18)
    raw = _zlib_raw(data)
    if case.startswith("win"):
        index = tinf.RawInflater(device="cpu").build_index(raw)
        if case == "win_engine5":
            monkeypatch.setenv("JDT_EXPAND", "5")
        want = tinf._windows_program
    elif case.startswith("anchored"):
        index = _anchors_index(raw)
        want = tinf._anchored_program
    else:
        index = {k: v for k, v in tinf.RawInflater(device="cpu").build_index(
            raw).items() if k != "win"}
        want = tinf._dense_program
    for owner, name in KERNELS:
        monkeypatch.setattr(owner, name, _suspended(getattr(owner, name)))
    calls = collections.Counter()

    def guarded(fn, inputs, statics=()):
        if fn is tinf._anchored_program and case == "anchored_kernel":
            statics = (*statics[:-1], True)     # the card's routing
        first = fn(*inputs, *statics)
        with NoHostRead(uploads=True):
            again = fn(*inputs, *statics)
        for a, b in zip(first, again):
            assert torch.equal(a, b)
        calls[fn] += 1
        return again

    monkeypatch.setattr(program, "run", guarded)
    td = tinf.RawInflater(device="cpu", **BATCH)
    assert td.decompress(raw, index=index) == data
    kinds = {k for k, _, _ in td.last_stats} - {"stored"}
    assert kinds == {case.split("_")[0]}
    assert list(calls) == [want] and calls[want] >= 2


# ---- exact parity with the JAX functions ---------------------------------

def test_windows_stacked_matches_jax():
    """decode_batch_windows_stacked at the last windowed row (row 3, after
    two stored blocks) behind a preset dictionary. Its window of wwords
    words would run past the stream, so the host clamped its word_lo; here
    the row's word_lo is moved back to its unclamped start, and the window
    clamps at the end of the stream on the device, as the reference's
    dynamic slice does."""
    rng = np.random.default_rng(5)
    zdict = make_corpus(rng, "text", 20000)
    data = zdict[3000:13000] + _mixed(7, 750 << 10)
    raw = _zlib_raw(data, 6, zdict)
    index = tinf.RawInflater(device="cpu").build_index(raw, zdict)
    work, up, offs, W_pad = _plan(raw, index, zdict)
    rows = [(k, item) for k, (kind, item) in enumerate(work)
            if kind == "win"]
    assert len(rows) >= 2
    row = len(rows) - 1
    k, (meta, npe, nb, oc, ww, total, b0) = rows[row]
    assert meta[1] > 0                        # hist: dictionary + output
    assert (b0 >> 5) > W_pad - ww             # the host clamped word_lo
    metas = up["metas"].clone()
    metas[row, 0] = b0 >> 5                   # the device clamps it now
    halo = _halo_before(zdict, data, offs[k])
    t_out, t_p, t_e, t_w = tinf.decode_batch_windows_stacked(
        up["words"], metas, torch.tensor(row), torch.from_numpy(halo), npe,
        nb, oc, ww)
    j_out, j_p, j_e, j_w = jinf.decode_batch_windows_stacked(
        jnp.asarray(up["words"].numpy().view(np.uint32)),
        jnp.asarray(metas.numpy()), jnp.int32(row), jnp.asarray(halo), npe,
        nb, oc, ww)
    assert int(t_p) == int(j_p) == total and int(t_e) == int(j_e) == 0
    np.testing.assert_array_equal(t_out.numpy(), np.asarray(j_out))
    np.testing.assert_array_equal(t_w.numpy(), np.asarray(j_w))
    assert t_out[:total].numpy().tobytes() == data[offs[k]:offs[k] + total]


def _legacy_batch(kind: str, index: dict, raw: bytes, data: bytes):
    """The second batch of `kind` of a decompress: its work item, device
    inputs, numpy halo and the stream's u32 words."""
    work, up, offs, _ = _plan(raw, index)
    picks = [k for k, (kk, _) in enumerate(work) if kk == kind]
    assert len(picks) >= 2
    k = picks[1]
    words_u32 = up["words"].numpy().view(np.uint32)
    return (work[k][1], up["items"][k], _halo_before(b"", data, offs[k]),
            words_u32, up["words"], offs[k])


@pytest.mark.parametrize("use_kernel", [False, True])
def test_anchored_program_matches_jax(use_kernel):
    """The anchored program on its int32 word window against the JAX
    decode_batch_anchored (use_pallas: its v1 Pallas kernel in interpret
    mode), on a batch behind a full 32 KiB of history."""
    data = _mixed(9, 1 << 18)
    raw = _zlib_raw(data)
    item, dev, halo, words_u32, words_full, o0 = _legacy_batch(
        "anchored", _anchors_index(raw), raw, data)
    (tb, st, en, ll, dl, lanes, nb, oc, _, first, word_lo, ww, total,
     _) = item
    word_lo_t, tb_t, st_t, en_t, ll_t, dl_t, first_t = dev
    wds = tinf._slice_words(words_full, word_lo_t, ww)
    t_out, t_pe, t_w = tinf._anchored_program(
        wds, tb_t, st_t, en_t, ll_t, dl_t, torch.from_numpy(halo), first_t,
        lanes, nb, oc, use_kernel)
    jw = jnp.asarray(words_u32[word_lo:word_lo + ww])
    args = (jw, jnp.asarray(tb), jnp.asarray(st), jnp.asarray(en),
            jnp.asarray(ll), jnp.asarray(dl), jnp.asarray(halo), lanes, nb,
            oc, use_kernel, jnp.asarray(first))
    with pltpu.force_tpu_interpret_mode():
        j_out, j_p, j_e, j_w = jinf.decode_batch_anchored(*args)
        j_out, j_w = np.asarray(j_out), np.asarray(j_w)
    assert t_pe.tolist() == [int(j_p), int(j_e)] == [total, 0]
    np.testing.assert_array_equal(t_out.numpy(), j_out)
    np.testing.assert_array_equal(t_w.numpy(), j_w)
    assert t_out[:total].numpy().tobytes() == data[o0:o0 + total]


def test_dense_program_matches_jax():
    """The dense program (bit_lo a 0-d tensor) against the JAX
    decode_batch and roll_window on a batch behind 32 KiB of history: out,
    produced, err and the next window. The dense decode's segmented orbits
    may err (ROADMAP C8); the err must be the reference's."""
    data = _mixed(11, 1 << 18)
    raw = _zlib_raw(data)
    index = {k: v for k, v in tinf.RawInflater(device="cpu").build_index(
        raw).items() if k != "win"}
    item, dev, halo, words_u32, words_full, o0 = _legacy_batch(
        "dense", index, raw, data)
    (bit_local, starts, syms, ends, ll, dl, nbits, nb, nseg, oc, word_lo,
     ww, total, _) = item
    word_lo_t, bit_lo_t, starts_t, syms_t, ends_t, ll_t, dl_t = dev
    assert bit_lo_t.dim() == 0 and int(bit_lo_t) == bit_local
    wds = tinf._slice_words(words_full, word_lo_t, ww)
    t_out, t_pe, t_w = tinf._dense_program(
        wds, bit_lo_t, starts_t, syms_t, ends_t, ll_t, dl_t,
        torch.from_numpy(halo), nbits, nb, nseg, oc)
    jw = jnp.asarray(words_u32[word_lo:word_lo + ww])
    j_out, j_p, j_e = jinf.decode_batch(
        jw, jnp.int32(bit_local), jnp.asarray(starts), jnp.asarray(syms),
        jnp.asarray(ends), jnp.asarray(ll), jnp.asarray(dl),
        jnp.asarray(halo), nbits, nb, nseg, oc)
    j_w = jinf.roll_window(jnp.asarray(halo), j_out, j_p, oc)
    assert t_pe.tolist() == [int(j_p), int(j_e)]
    np.testing.assert_array_equal(t_out.numpy(), np.asarray(j_out))
    np.testing.assert_array_equal(t_w.numpy(), np.asarray(j_w))
    if int(j_e) == 0:
        assert t_out[:total].numpy().tobytes() == data[o0:o0 + total]


# ---- lz_resolve: fixed trip against the while_loop -----------------------

def _chain(n: int, hops: int, masked: int):
    """Position 0 a literal, position i a copy of position max(i - hops,
    0): with hops 1 each depends on the one before, so pointer doubling
    resolves the first 2^r positions in r rounds; with hops n every
    position reads position 0 and one round resolves all. The first
    `masked` positions must resolve; the rest may still be moving when the
    while_loop stops."""
    src = np.maximum(np.arange(n) - hops, 0).astype(np.int32)
    val = np.zeros(n, np.int32)
    val[0] = 0xA5
    resolved = np.zeros(n, bool)
    resolved[0] = True
    return val, src, resolved, np.arange(n) < masked


@pytest.mark.parametrize("hops,masked,rounds", [
    (1, 1 << 10, 10), (1 << 11, 1 << 10, 10), (1, 16, 11)],
    ids=["every_round", "one_round", "stops_early"])
def test_lz_resolve_fixed_trip_matches_while_loop(hops, masked, rounds):
    """every_round: the mask needs all 10 rounds; one_round: the loop
    stops after one; stops_early: the mask resolves in 4 of 11 rounds
    while the unmasked chain is still moving, and must stop there."""
    n = 1 << 11
    val, src, resolved, mask = _chain(n, hops, masked)
    jv, jr = jax.jit(jdk.lz_resolve, static_argnums=(4,))(
        *(jnp.asarray(x) for x in (val, src, resolved, mask)), rounds)
    tv, tr = tdk.lz_resolve(*(torch.from_numpy(x) for x in (
        val.astype(np.int64), src.astype(np.int64), resolved, mask)),
        rounds)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert bool(tr[:masked].all())
    assert int(tr.sum()) == {1: min(n, 1 << (10 if masked > 16 else 4)),
                             n: n}[hops]


# ---- adler32 in int32 ----------------------------------------------------

@pytest.mark.parametrize("n", [8421504, 8421505, 9 << 20])
def test_adler32_equals_zlib_on_ff_runs(n):
    """8,421,505 bytes of 0xFF is where a plain int32 sum of the bytes
    passes 2^31; the program folds mod 65521 and stays exact, also past
    it and across its 1 MiB padding buckets."""
    data = b"\xff" * n
    assert cs.adler32(data, device="cpu") == zlib.adler32(data)
    assert cs.adler32(data, 0x12345678, device="cpu") == zlib.adler32(
        data, 0x12345678)


# ---- the cache: eviction order and pool accounting -----------------------

def test_cache_evicts_least_recently_used(monkeypatch):
    """Budget 1,000 bytes; a program holds its inputs, a pool what its
    captures grew it by. On device d0, a, b and c (100 bytes each) grow
    pool P1 by 200, 100 and 0: 600 bytes. Touching a makes b the oldest. d
    grows P1 to 550, past half the budget: P1 is retired, nothing is
    dropped (950). e opens P2 and grows it by 300 (1,350): b, c, a and d
    go, oldest first, and with d the last of P1's programs the 550 bytes
    of P1 go too (400). d1's program, 5,000 bytes alone, is never
    touched."""
    monkeypatch.setattr(program, "_programs", collections.OrderedDict())
    monkeypatch.setattr(program, "_pools", {})
    monkeypatch.setattr(program, "BUDGET", 1000)
    P1, P2, P3 = (types.SimpleNamespace(nbytes=0) for _ in range(3))

    def add(name, dev, nbytes, pool, rise):
        pool.nbytes += rise
        program._programs[name] = types.SimpleNamespace(
            dev=dev, nbytes=nbytes, pool=pool)
        program._pools.setdefault(dev, pool)
        return program._admit(dev, name)

    assert add("x", "d1", 5000, P3, 0) == []   # alone on its device
    assert add("a", "d0", 100, P1, 200) == []
    assert add("b", "d0", 100, P1, 100) == []
    assert add("c", "d0", 100, P1, 0) == []
    assert program.device_bytes("d0") == 600
    program._programs.move_to_end("a")
    assert add("d", "d0", 100, P1, 250) == []
    assert "d0" not in program._pools          # P1 retired
    assert program.device_bytes("d0") == 950
    assert add("e", "d0", 100, P2, 300) == ["b", "c", "a", "d"]
    assert program._pools["d0"] is P2
    assert list(program._programs) == ["x", "e"]
    assert program.device_bytes("d0") == 400
    assert program.device_bytes("d1") == 5000


# ---- on the card ---------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_crc32_sweep_keeps_the_reserve_bounded():
    """crc32 of every size from 2 to 64 MiB in 1 MiB steps (63 padding
    buckets of the plain program): the rise of memory_reserved stays
    under 2 GiB, every value is zlib's, and each call is one launch of
    the crc32 kernel, which caches no program."""
    _need_card()
    program.clear()
    torch.cuda.synchronize()
    data = np.random.default_rng(2).integers(0, 256, 64 << 20, np.uint8)
    dev = torch.from_numpy(data).cuda()
    base = torch.cuda.memory_reserved()
    before = cs.crc32_kernel.launches
    rise = 0
    for mb in range(2, 65):
        n = mb << 20
        assert cs.crc32(dev[:n - 1]) == zlib.crc32(data[:n - 1])
        rise = max(rise, torch.cuda.memory_reserved() - base)
    assert rise < 2 << 30, rise
    assert cs.crc32_kernel.launches == before + 63
    assert not any(k[1] is cs._crc32_program for k in program._programs)


@pytest.mark.cuda
def test_eviction_on_card_keeps_results(monkeypatch):
    """With a 16 MiB budget the engine-2 decode's programs evict each
    other on every batch; the bytes and last_stats stay eager's, and the
    cache ends within the budget plus its newest program."""
    _need_card()
    data = _mixed(17, 1 << 19)
    raw = _zlib_raw(data)
    index = tinf.RawInflater(device="cpu").build_index(raw)
    td = tinf.RawInflater(device="cuda", **BATCH)
    with program.eager():
        want = td.decompress(raw, index=index)
        want_stats = list(td.last_stats)
    program.clear()
    monkeypatch.setattr(program, "BUDGET", 16 << 20)
    n0 = program.stats["evictions"]
    for _ in range(2):
        assert td.decompress(raw, index=index) == want == data
        assert td.last_stats == want_stats
    assert program.stats["evictions"] > n0
    newest = next(reversed(program._programs.values()))
    dev = newest.dev
    assert program.device_bytes(dev) <= (16 << 20) + newest.nbytes + \
        newest.pool.nbytes
    program.clear()


@pytest.mark.cuda
def test_dead_graph_pool_needs_empty_cache():
    """What program.py's eviction relies on: a dead graph's private pool
    stays reserved until torch.cuda.empty_cache() returns it."""
    _need_card()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    x = torch.zeros(1 << 20, device="cuda")
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        y = x + 1
        for _ in range(4):
            y = y * 2 + torch.ones(64 << 20, device="cuda")[:1 << 20]
    held = torch.cuda.memory_reserved()
    del g, y
    torch.cuda.synchronize()
    assert torch.cuda.memory_reserved() == held
    torch.cuda.empty_cache()
    assert torch.cuda.memory_reserved() < held - (200 << 20)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["win_engine2", "win_engine5", "anchored",
                                  "dense"])
def test_captured_decode_equals_eager_on_card(case, monkeypatch):
    """Each branch on the card, captured (a first run that captures, then
    replays) against program.eager(): equal bytes and last_stats."""
    _need_card()
    data = _mixed(13, 1 << 19)
    raw = _zlib_raw(data)
    index = tinf.RawInflater(device="cpu").build_index(raw)
    if case == "anchored":
        index = _anchors_index(raw)
    elif case == "dense":
        index = {k: v for k, v in index.items() if k != "win"}
    if case == "win_engine5":
        monkeypatch.setenv("JDT_EXPAND", "5")
    td = tinf.RawInflater(device="cuda", **BATCH)
    with program.eager():
        want = td.decompress(raw, index=index)
        want_stats = list(td.last_stats)
    for _ in range(2):
        assert td.decompress(raw, index=index) == want == data
        assert td.last_stats == want_stats
