"""The port's captured encode and checksum programs on the CPU
(jdeflate_tpu_torch/codec/program.py): what a CUDA graph needs of the
functions it captures, held here where no card is.

- A dispatch-mode guard fails on every host read and every op whose output
  shape depends on the data (aten._local_scalar_dense, nonzero,
  masked_select, unique*, is_nonzero, bincount). The functions the program
  layer captures, encode_batch's two stages behind deflate._match_handle
  and deflate._code_handle with their per-batch scalars as 0-d tensors and the crc32/adler32 programs, run
  under it at levels 1, 6 and 9.
- The port's encode_batch with tensor scalars equals the JAX encode_batch
  (same numpy inputs, made from a seed) on a short last batch, a first
  batch behind a preset dictionary shorter than 32 KiB, a final block
  outside the batch, a level-9 block whose Fibonacci distance counts make
  the Kraft repair of the two-queue tree run, and a block whose residual
  extension rounds reach the ext_rounds cap. Every case shares one block
  size and batch, so the JAX encoder compiles once per level.
- The Kraft repair's fixed trip count: a caterpillar tree reaches the bound
  stated in ops/huffman.py, against the JAX while loop.
- crc32 and adler32 equal zlib at every padding bucket's edges and with
  init chained.

Tolerance: exact equality everywhere.
"""
import heapq
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from chip_smoke import canonical

from jdeflate_tpu.codec import deflate as JD
from jdeflate_tpu.codec import levels as jlevels
from jdeflate_tpu.ops import huffman as jhf
from jdeflate_tpu_torch.codec import deflate as TD
from jdeflate_tpu_torch.codec import levels as tlevels
from jdeflate_tpu_torch.codec import program
from jdeflate_tpu_torch.formats import constants as C
from jdeflate_tpu_torch.ops import checksum as cs
from jdeflate_tpu_torch.ops import huffman as thf
from jdeflate_tpu_torch.ops import lz77

# both sides run the same (CPU-capped) probe depths, tests/conftest.py
tlevels._PROBE_CAP.update(jlevels._PROBE_CAP)

BL, BATCH = 1 << 16, 2          # every encode case: one JAX compile a level
HALO, PAD = TD.HALO, TD.PAD


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's default thread pool only spins against the other test
    workers' JAX compiles."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class NoHostRead(TorchDispatchMode):
    """Fails on an op that reads a value back to the host or whose output
    shape depends on the data (a boolean index included): neither can run
    inside a captured program. With uploads=True it also fails on a tensor
    made from host data (aten.lift_fresh: torch.tensor, torch.as_tensor, a
    Python scalar assigned into a tensor), which a capture cannot copy to
    the card; the program layer's first, eager call makes the resident
    tables, so that guard holds from the second call on."""

    FORBIDDEN = {"_local_scalar_dense", "item", "is_nonzero", "nonzero",
                 "masked_select", "bincount"}

    def __init__(self, uploads: bool = False):
        super().__init__()
        self.forbidden = self.FORBIDDEN | ({"lift_fresh"} if uploads
                                           else set())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        # a boolean index is a nonzero inside aten.index
        masked = name.startswith("index") and any(
            isinstance(i, torch.Tensor) and i.dtype == torch.bool
            for a in args if isinstance(a, (list, tuple)) for i in a)
        if name in self.forbidden or "unique" in name or masked:
            raise AssertionError(f"host read, upload or data-dependent "
                                 f"shape: {func}")
        return func(*args, **(kwargs or {}))


def test_guard_catches_host_reads():
    t = torch.arange(8)
    for read in (lambda: bool(t.any()), lambda: int(t.sum()),
                 lambda: t.nonzero(), lambda: t[t > 3],
                 lambda: torch.unique(t), lambda: torch.bincount(t)):
        with pytest.raises(AssertionError, match="host read"):
            with NoHostRead():
                read()
    for upload in (lambda: t.__setitem__(0, 0), lambda: torch.tensor(5),
                   lambda: torch.as_tensor(np.arange(3))):
        with NoHostRead():
            upload()
        with pytest.raises(AssertionError, match="upload"):
            with NoHostRead(uploads=True):
                upload()


# ---- inputs ----

DIST_BASE = [1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193,
             257, 385, 513, 769, 1025, 1537, 2049, 3073, 4097]


def kraft_corpus(seed: int, bl: int = BL) -> bytes:
    """Two blocks of 5-byte units: a byte (the unit's index mod 256), then
    a 4-byte word, either new or the word of a unit j back that has not
    recurred since. No word recurs at units equal mod 256, so every window
    that holds a word byte and a separator is new, and each recurrence is
    a 4-byte match at exactly 5j bytes. Block 0 makes words recur at random
    distances; block 1 gives distance code 6 + i exactly Fibonacci F_(i+1)
    matches for i < 18, the rest new words, in random order: a caterpillar
    distance tree of 18 leaves, 17 deep, which the two-queue code must
    repair to 15 bits."""
    rng = np.random.default_rng(seed)
    codes = range(6, 24)
    fib = [1, 1]
    while len(fib) < len(codes):
        fib.append(fib[-1] + fib[-2])
    nu = bl // 5
    warm = [int(c) if c < codes[-1] + 1 else None
            for c in rng.integers(codes[0], codes[-1] + 6, 2 * nu)]
    plan = [c for c, f in zip(codes, fib) for _ in range(f)]
    plan += [None] * (nu - len(plan))
    rng.shuffle(plan)
    words, latest, residues = [], {}, {}

    def fresh():
        w = rng.integers(0, 256, 4, dtype=np.uint8).tobytes()
        latest[w] = len(words)
        residues[w] = {len(words) % 256}
        words.append(w)

    for blk in (warm, plan):
        start, spare = len(words), blk.count(None)
        for code in blk:
            if len(words) - start >= nu:
                break
            if code is None:
                if spare > 0:
                    fresh()
                continue
            lo, hi = DIST_BASE[code], DIST_BASE[code + 1]
            while True:
                u = len(words)
                js = [j for j in range(-(-lo // 5), (hi - 1) // 5 + 1)
                      if j <= u and latest[words[u - j]] == u - j
                      and u % 256 not in residues[words[u - j]]]
                if js:
                    break
                fresh()
                spare -= 1
            w = words[u - int(rng.choice(js))]
            latest[w] = u
            residues[w].add(u % 256)
            words.append(w)
        while len(words) - start < nu:
            fresh()
    out = bytearray()
    for k, w in enumerate(words):
        if k == nu:
            out += bytes(bl - len(out))
        out += bytes([k % 256]) + w
    return bytes(out)


def ext_corpus(seed: int, n: int) -> bytes:
    """150-byte copies from random distances (100 to 4,000 bytes back)
    between 20 random bytes: more distances than the top-T extension stage
    takes, each match longer than the probe prefix plus every residual
    extension round at levels 1 to 6."""
    rng = np.random.default_rng(seed)
    out = bytearray(rng.integers(0, 256, 4096, dtype=np.uint8).tobytes())
    while len(out) < n:
        d = int(rng.integers(100, 4000))
        for _ in range(150):
            out.append(out[-d])
        out += rng.integers(0, 256, 20, dtype=np.uint8).tobytes()
    return bytes(out[:n])


def text_corpus(seed: int, n: int) -> bytes:
    rng = np.random.default_rng(seed)
    words = [b"entropy ", b"window ", b"match ", b"block ", b"stream\n",
             b"huffman ", b"literal ", b"distance "]
    return b"".join(words[i] for i in rng.integers(0, 8, n // 4))[:n]


def batch_input(data: bytes, b0: int, dictionary: bytes = b"",
                final: bool = True):
    """RawDeflater's batch b0 of `data` (in blocks of BL, batches of
    BATCH): the halo-prefixed buffer and (start_block, total_len,
    dict_len, final_block)."""
    n = len(data)
    s, seg = b0 * BL, BL * BATCH
    seg_n = min(n - s, seg)
    buf = np.zeros(HALO + seg + PAD, np.uint8)
    hist = (dictionary + data[:s])[-HALO:]
    h = len(hist)
    if h:
        buf[HALO - h:HALO] = np.frombuffer(hist, np.uint8)
    buf[HALO:HALO + seg_n] = np.frombuffer(data[s:s + seg_n], np.uint8)
    nblocks = -(-n // BL)
    return buf, (0, seg_n, h, (nblocks - 1 if final else -1) - b0)


def statics(level: int) -> tuple:
    return (BL, BATCH, level,
            TD.words_bound(BL, BATCH, tlevels.get_level(level).chunk),
            False)


def port_encode(buf, sc, level: int):
    """The port's encode_batch with its scalars as 0-d tensors, under the
    host-read guard."""
    scal = torch.tensor(sc, dtype=torch.int64)
    with NoHostRead():
        return TD.encode_batch(torch.from_numpy(buf), *scal.unbind(),
                               *statics(level))


@pytest.fixture(scope="module")
def jax_encode():
    """The JAX encode_batch with traced scalars: one compile per level."""
    def run(buf, sc, level):
        bl, batch, lv, nw, fixed = statics(level)
        return JD.encode_batch(jnp.asarray(buf), *map(jnp.int32, sc),
                               bl=bl, batch=batch, level=lv, num_words=nw,
                               fixed_codes=fixed)
    return run


def _assert_same(got, want, what: str):
    assert len(got) == len(want) == 9
    for k, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(
            g.numpy().astype(np.int64), np.asarray(w).astype(np.int64),
            err_msg=f"{what}: encode_batch output {k}")


def _huffman_depth(freqs) -> int:
    """The deepest leaf of an unlimited Huffman tree over the nonzero
    counts (plain Python)."""
    heap = [(int(f), i, [i]) for i, f in enumerate(freqs) if f > 0]
    if len(heap) < 2:
        return len(heap)
    heapq.heapify(heap)
    depth = dict.fromkeys((i for _, i, _ in heap), 0)
    k = len(freqs)
    while len(heap) > 1:
        a, b = heapq.heappop(heap), heapq.heappop(heap)
        for s in a[2] + b[2]:
            depth[s] += 1
        heapq.heappush(heap, (a[0] + b[0], k, a[2] + b[2]))
        k += 1
    return max(depth.values())


# ---- no host read in what the program layer captures ----

@pytest.mark.parametrize("level", [1, 6, 9])
def test_encode_program_makes_no_host_read(level):
    """deflate._match_handle and deflate._code_handle, the functions the
    two captured programs of a batch run, read as a capture reads them:
    after the first, eager call each uploads nothing, reads nothing back
    and makes no data-dependent shape, and the pair gives that call's
    result, batch_handle of encode_batch."""
    data = text_corpus(level, BL + 3000)
    buf, sc = batch_input(data, 0)
    t, scal = torch.from_numpy(buf), torch.tensor(sc, dtype=torch.int64)
    bl, batch, lv, nw, fixed = statics(level)
    match = TD._match_handle(t, scal, bl, batch, lv)
    first = TD._code_handle(t, scal, *match, bl, batch, lv, nw, fixed)
    with NoHostRead(uploads=True):
        match_again = TD._match_handle(t, scal, bl, batch, lv)
        again = TD._code_handle(t, scal, *match_again, bl, batch, lv, nw,
                                fixed)
    assert all(torch.equal(a, b) for a, b in zip(match, match_again))
    want = TD.batch_handle(TD.encode_batch(t, *sc, *statics(level)))
    for a, b, w in zip(first, again, want, strict=True):
        assert torch.equal(a, w) and torch.equal(b, w)


@pytest.mark.parametrize("n", [1, 255, 256, 4097, 70000])
def test_checksum_programs_make_no_host_read(n):
    """The crc32 and adler32 programs, after their first call, upload and
    read back nothing; the one readback is the caller's int() of the
    32-bit result."""
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
    for fn, chunk, front, init, ref in (
            (cs._crc32_program, cs._CRC_CHUNK, True, 77, zlib.crc32),
            (cs._adler32_program, cs._ADLER_CHUNK, False, 99, zlib.adler32)):
        buf = cs._padded(data.tobytes(), n, cs._pad_bucket(n, chunk), front,
                         "cpu")
        sc = torch.tensor([init, n], dtype=torch.int64)
        fn(buf, sc)                     # the first, eager call
        with NoHostRead(uploads=True):
            (out,) = fn(buf, sc)
        assert out.dim() == 0
        assert int(out) == ref(data.tobytes(), init)


# ---- parity with the JAX encode_batch, tensor scalars ----

def test_short_last_batch_matches_jax(jax_encode):
    data = text_corpus(1, 2 * BL * BATCH + 5000)
    buf, sc = batch_input(data, 2 * BATCH)
    assert sc[1] == 5000 and sc[3] == 0
    _assert_same(port_encode(buf, sc, 6), jax_encode(buf, sc, 6),
                 "short last batch")


def test_short_dictionary_first_batch_matches_jax(jax_encode):
    """A preset dictionary of 1,000 bytes: dict_len 1000 of the 32 KiB
    halo, so matches may reach only that far back; no final block."""
    data = text_corpus(2, BL * BATCH)
    dictionary = text_corpus(3, 1000)
    buf, sc = batch_input(data, 0, dictionary, final=False)
    assert sc[2] == 1000 and sc[3] == -1
    _assert_same(port_encode(buf, sc, 1), jax_encode(buf, sc, 1),
                 "short dictionary")


def test_final_block_outside_the_batch_matches_jax(jax_encode):
    """final_block past the batch's last block: no block gets BFINAL."""
    data = text_corpus(4, BL * BATCH)
    buf, (s0, n, h, _) = batch_input(data, 0)
    sc = (s0, n, h, BATCH + 3)
    got = port_encode(buf, sc, 6)
    _assert_same(got, jax_encode(buf, sc, 6), "final block outside")
    want_final = jax_encode(buf, (s0, n, h, BATCH - 1), 6)
    assert not np.array_equal(got[0].numpy(), np.asarray(want_final[0]))


def test_kraft_repair_block_matches_jax(jax_encode):
    """Level 9 on kraft_corpus: block 1 is one split group whose distance
    counts build a two-queue tree 17 deep, so the Kraft repair runs (its
    excess is 2); the result equals the JAX encoder's."""
    data = kraft_corpus(1)
    buf, sc = batch_input(data, 0)
    scal = [torch.tensor(v) for v in sc]
    _, dfreq = TD.encode_batch(torch.from_numpy(buf), *scal, *statics(9),
                               stage="freqs")
    start = TD.encode_batch(torch.from_numpy(buf), *scal, *statics(9),
                            stage="split")
    assert start[1].tolist() == [True] + [False] * (start.shape[1] - 1)
    assert _huffman_depth(dfreq[1].sum(0).tolist()) > C.MAX_CODE_BITS
    _assert_same(port_encode(buf, sc, 9), jax_encode(buf, sc, 9),
                 "Kraft repair block")


def test_extension_cap_block_matches_jax(jax_encode):
    """Level 6 on ext_corpus: after ext_rounds residual rounds some matches
    are still extending (one more round would lengthen them), so the
    masked loop runs to the cap the JAX while loop stops at."""
    data = ext_corpus(3, BL * BATCH)
    buf, sc = batch_input(data, 0)
    cfg = tlevels.get_level(6)
    t = torch.from_numpy(buf)
    starts = torch.arange(BATCH) * BL
    ext = t[starts[:, None] + torch.arange(HALO + BL + PAD)[None, :]]
    blen = torch.clamp(sc[1] - starts, 0, BL)
    vfrom = HALO - torch.clamp(starts + sc[2], max=HALO)
    kw = dict(ext_top=cfg.ext_top, rescue=cfg.rescue,
              probe_words=cfg.probe_words, ext_mdiv=cfg.ext_mdiv)
    capped = lz77.find_matches_batch(ext, blen, vfrom, HALO, BL, PAD,
                                     cfg.probes, ext_rounds=cfg.ext_rounds,
                                     **kw)[0]
    more = lz77.find_matches_batch(ext, blen, vfrom, HALO, BL, PAD,
                                   cfg.probes, ext_rounds=cfg.ext_rounds + 1,
                                   **kw)[0]
    assert not torch.equal(capped, more), "the cap does not bind"
    _assert_same(port_encode(buf, sc, 6), jax_encode(buf, sc, 6),
                 "extension cap")


# ---- the Kraft repair's bound ----

def test_kraft_repair_reaches_its_bound():
    """Fibonacci counts over all 30 distance symbols make the caterpillar
    tree 29 deep, whose Kraft excess is the bound n - max_bits - 1 = 14
    that the fixed trip count covers; lengths equal the JAX loop's."""
    n, L = 30, C.MAX_CODE_BITS
    fib = [1, 1]
    while len(fib) < n:
        fib.append(fib[-1] + fib[-2])
    f = np.asarray(fib, np.int64)
    assert _huffman_depth(f) == n - 1
    # the caterpillar's depths: 1, 2, ..., n - 2, n - 1, n - 1
    depths = list(range(n - 1, 0, -1)) + [n - 1]
    excess = sum(1 << (L - min(d, L)) for d in depths) - (1 << L)
    assert excess == n - L - 1
    got = thf.code_lengths(torch.from_numpy(f[None]), L)[0].numpy()
    want = np.asarray(jhf.code_lengths(jnp.asarray(f, jnp.int32), L))
    np.testing.assert_array_equal(got, want)
    assert got.max() == L
    assert sum(2.0 ** -int(x) for x in got) == 1.0


# ---- checksums at the bucket edges ----

def _bucket_sizes(chunk: int, top: int = 2 << 20) -> list:
    b, out = chunk, []
    while b <= top:
        out += [b - 1, b, b + 1]
        b = b * 2 if b < (1 << 20) else b + (1 << 20)
    return out


@pytest.mark.parametrize("name", ["crc32", "adler32"])
def test_checksums_equal_zlib_at_bucket_edges(name):
    chunk = cs._CRC_CHUNK if name == "crc32" else cs._ADLER_CHUNK
    ours, ref = getattr(cs, name), getattr(zlib, name)
    rng = np.random.default_rng(11)
    data = rng.integers(0, 256, (2 << 20) + 1, dtype=np.uint8).tobytes()
    for n in _bucket_sizes(chunk):
        assert ours(data[:n], device="cpu") == ref(data[:n]), n
        t = torch.frombuffer(bytearray(data[:n]), dtype=torch.uint8)
        assert ours(t) == ref(data[:n]), n
    # init chained over pieces that straddle bucket edges
    run_ours, run_ref, pos = (0 if name == "crc32" else 1), None, 0
    for n in (255, 257, 4096, 70001, 1 << 20, 3):
        piece = data[pos:pos + n]
        run_ours = ours(piece, run_ours, device="cpu")
        run_ref = ref(piece) if run_ref is None else ref(piece, run_ref)
        assert run_ours == run_ref, n
        pos += n
    assert ours(b"", 12345, device="cpu") == 12345


def test_pad_bucket_matches_jax():
    from jdeflate_tpu.ops import checksum as jcs
    for chunk in (cs._CRC_CHUNK, cs._ADLER_CHUNK):
        for n in [0, 1] + _bucket_sizes(chunk, 8 << 20):
            assert cs._pad_bucket(n, chunk) == jcs._pad_bucket(n, chunk)


# ---- the program layer on the CPU ----

def test_run_calls_the_function_on_the_cpu():
    """On the CPU, and under eager(), run() is the function itself: no
    program is kept."""
    calls = []

    def fn(x, k):
        calls.append(k)
        return (x + k,)
    x = torch.arange(4)
    assert torch.equal(program.run(fn, (x,), (3,))[0], x + 3)
    with program.eager():
        assert program.is_eager()
        assert torch.equal(program.run(fn, (x,), (1,))[0], x + 1)
    assert not program.is_eager()
    assert calls == [3, 1] and not program._programs


def test_launch_batch_is_the_eager_handle_on_the_cpu():
    """On the CPU launch_batch runs the two stages directly and stamps no
    clock: the stamps at the end of its meta are zeros, as batch_handle's
    of encode_batch in one call."""
    data = text_corpus(5, BL + 100)
    buf, sc = batch_input(data, 0)
    got = TD.launch_batch(torch.from_numpy(buf), *sc, *statics(6))
    want = TD.batch_handle(TD.encode_batch(torch.from_numpy(buf), *sc,
                                           *statics(6)))
    assert not got[1][-TD.STAMPS:].any()
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)


@pytest.mark.parametrize("level", [1, 6, 9])
def test_two_stage_encode_matches_one_call_and_jax(level, jax_encode):
    """code_batch on match_batch's (length, dist), the two programs of a
    batch, equals encode_batch in one call and the JAX encode_batch, on
    a short last batch behind a full history."""
    data = text_corpus(20 + level, BL * BATCH + BL + 777)
    buf, sc = batch_input(data, BATCH)
    scal = [torch.tensor(v, dtype=torch.int64) for v in sc]
    t = torch.from_numpy(buf)
    with NoHostRead():
        length, dist = TD.match_batch(t, *scal, BL, BATCH, level)
        two = TD.code_batch(t, *scal, length, dist, *statics(level))
    one = port_encode(buf, sc, level)
    for g, w in zip(two, one, strict=True):
        assert torch.equal(g, w)
    _assert_same(two, jax_encode(buf, sc, level), f"two-stage level {level}")


@pytest.mark.cuda
def test_programs_replay_the_eager_results_on_card():
    """On a card: the captured encode and checksum programs give the eager
    path's results, replays count their match-walk launches, and a
    result stays intact after the next replay of its shape."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    program.clear()
    d1, d2 = text_corpus(6, 2 * BL * BATCH), ext_corpus(7, 2 * BL * BATCH)
    for level in (1, 6, 9):
        enc = TD.RawDeflater(level=level, block_size=BL, batch=BATCH,
                             device="cuda")
        with program.eager():
            want = [enc.compress(d) for d in (d1, d2)]
        lz77.match_walk.launches = 0
        got = [enc.compress(d) for d in (d1, d2)]     # capture, replays
        assert lz77.match_walk.launches == 4
        assert canonical(got) == canonical(want)
        first = enc.launch(d1)
        enc.launch(d2)                                # overwrites buffers
        assert canonical(enc.finish(first)) == canonical(want[0])
    for n in (1, 300, 1 << 20, (1 << 20) + 7):
        data = np.random.default_rng(n).integers(0, 256, n, np.uint8)
        assert cs.crc32(data.tobytes()) == zlib.crc32(data.tobytes())
        assert cs.adler32(data.tobytes()) == zlib.adler32(data.tobytes())
    assert program.stats["captures"] > 0 and program.stats["replays"] > 0


@pytest.mark.cuda
def test_programs_capture_on_every_card():
    """A program of one signature captured on cuda:0, then on every other
    card, in turns: each capture runs on its own device's side stream
    (program.capture_stream), and each card's replays give its eager
    results."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs 2 CUDA devices")

    def twice(x):
        return (x * 2 + 1,)

    for _ in range(2):
        for k in range(torch.cuda.device_count()):
            dev = torch.device("cuda", k)
            x = torch.arange(1000, dtype=torch.int64, device=dev) * (k + 1)
            (got,) = program.run(twice, (x,))
            assert got.device == dev and torch.equal(got, x * 2 + 1)
            assert program.capture_stream(dev).device == dev

