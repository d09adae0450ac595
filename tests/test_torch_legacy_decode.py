"""Parity of the port's legacy decode (the "anchored" and "dense" branches of
jdeflate_tpu_torch.codec.inflate, ops/decode.py and the v1 match expansion
ops/expand.py) with the JAX package on the CPU.

The JAX match expansion runs its real Pallas kernel under
pltpu.force_tpu_interpret_mode(); the port runs its plain version (what the
wrapper takes for a CPU tensor). Decode tables, the wavefront decode, the
orbits and the anchored walk are compared stage by stage on real zlib
streams; RawInflater.decompress on an index with symbol anchors, on an index
with no anchors at all, and on corrupted streams must give the same bytes
and the same last_stats (kinds, produced and err) as the JAX RawInflater.
Symbol anchors (every 64th symbol's bit offset) come from the port's
wavefront decode and orbits (chip_smoke.symbol_anchors, which the chip
smoke test runs on the card): nothing in either package writes them.
Tolerance: exact equality. The kernel's own check against its plain version
needs a card (marker `cuda`)."""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from chip_smoke import symbol_anchors
from jdeflate_tpu.codec import inflate as jinf
from jdeflate_tpu.ops import decode as jdk
from jdeflate_tpu_torch.codec import inflate as tinf
from jdeflate_tpu_torch.ops import decode as tdk
from jdeflate_tpu_torch.ops import expand as tex
from jdeflate_tpu_torch.stream import host_inflate as thi

BATCH = dict(max_batch_bits=1 << 18, max_batch_blocks=8,
             max_batch_out=1 << 16)
HALO = 32768


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tensors here are small; torch's default thread pool only spins
    against the other test workers' JAX compiles."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _zlib_raw(data, level):
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    return co.compress(data) + co.flush()


def _mixed(corpus, n):
    q = n // 4
    return (corpus("text", q) + corpus("binary", q) + corpus("runs", q)
            + corpus("random", q // 8) + corpus("text", q - q // 8))


def _stream_tables(raw):
    """Header records, (nb, 288)/(nb, 32) code lengths and int64 words of a
    whole stream."""
    _, recs, end_bit = thi.inflate_raw(raw)
    nb = len(recs)
    ll = np.zeros((nb, 288), np.int32)
    dl = np.zeros((nb, 32), np.int32)
    for k, r in enumerate(recs):
        if r.btype:
            ll[k, :len(r.litlen_lengths)] = r.litlen_lengths
            dl[k, :len(r.dist_lengths)] = r.dist_lengths
    w = np.zeros(len(raw) // 4 + 4, np.uint32)
    w.view(np.uint8)[:len(raw)] = np.frombuffer(raw, np.uint8)
    return recs, end_bit, ll, dl, w


def _anchors_index(raw):
    index = tinf.RawInflater(device="cpu").build_index(raw)
    anchors = symbol_anchors(raw, index, "cpu")
    return {**{k: v for k, v in index.items() if k != "win"},
            "anchors": anchors}


def _both_decode(raw, index):
    jd = jinf.RawInflater(**BATCH)
    td = tinf.RawInflater(device="cpu", **BATCH)
    jo = jd.decompress(raw, index=index)
    to = td.decompress(raw, index=index)
    assert to == jo
    tstats = [(k, int(p), int(e)) for k, p, e in td.last_stats]
    assert tstats == [(k, int(p), int(e)) for k, p, e in jd.last_stats]
    return to, tstats


# ---- decode stages against the reference ----------------------------------

def test_tables_and_bit_fields_match_jax(corpus):
    data = _mixed(corpus, 1 << 16)
    raw = _zlib_raw(data, 6)
    recs, _, ll, dl, w = _stream_tables(raw)
    for lens, attrs, jattrs in ((ll, tdk.litlen_attrs(), jdk.litlen_attrs()),
                                (dl, tdk.dist_attrs(), jdk.dist_attrs())):
        for a, b in zip(attrs, jattrs):
            np.testing.assert_array_equal(a, b)
        got = tdk.build_tables_batch(torch.from_numpy(lens), *attrs)
        want = jdk.build_tables_batch(jnp.asarray(lens), *jattrs)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(want).astype(np.int64))
    rng = np.random.default_rng(2)
    p = rng.integers(0, len(raw) * 8 + 64, 4000)
    n = rng.integers(0, 16, 4000)
    tw = torch.from_numpy(w.astype(np.int64))
    np.testing.assert_array_equal(
        tdk.extract_bits(tw, torch.from_numpy(p), torch.from_numpy(n)).numpy(),
        np.asarray(jdk.extract_bits(jnp.asarray(w), jnp.asarray(p, jnp.int32),
                                    jnp.asarray(n, jnp.int32))))
    x = rng.integers(0, 1 << 15, 4000)
    np.testing.assert_array_equal(
        tdk.rev15(torch.from_numpy(x)).numpy(),
        np.asarray(jdk.rev15(jnp.asarray(x, jnp.uint32))))


@pytest.mark.parametrize("level", [1, 6, 9])
def test_wavefront_and_orbits_match_jax(corpus, level):
    """wavefront_decode, orbits, segmented_orbits and anchored_walk on every
    Huffman block of a stream, against the reference's functions."""
    data = _mixed(corpus, 1 << 16)
    raw = _zlib_raw(data, level)
    recs, end_bit, ll, dl, w = _stream_tables(raw)
    huff = [k for k, r in enumerate(recs) if r.btype]
    nb = len(recs)
    nbits = 1 << (len(raw) * 8 - 1).bit_length()
    bits = np.asarray([r.bit_offset for r in recs], np.int32)
    bid = np.clip(np.searchsorted(bits, np.arange(nbits), side="right") - 1,
                  0, nb - 1).astype(np.int32)
    tw = torch.from_numpy(w.astype(np.int64))
    tl = tdk.build_tables_batch(torch.from_numpy(ll), *tdk.litlen_attrs())
    td_ = tdk.build_tables_batch(torch.from_numpy(dl), *tdk.dist_attrs())
    jl = jdk.build_tables_batch(jnp.asarray(ll), *jdk.litlen_attrs())
    jd_ = jdk.build_tables_batch(jnp.asarray(dl), *jdk.dist_attrs())
    got = tdk.wavefront_decode(tw, 0, nbits, torch.from_numpy(bid), tl, td_)
    want = jax.jit(jdk.wavefront_decode, static_argnums=(2,))(
        jnp.asarray(w), jnp.int32(0), nbits, jnp.asarray(bid), jl, jd_)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))
    f, eobf = got[0], got[5]

    syms = np.asarray([recs[k].sym_bit_offset for k in huff], np.int32)
    ends = np.asarray([recs[k + 1].bit_offset if k + 1 < nb else end_bit
                       for k in huff], np.int32)
    np.testing.assert_array_equal(
        tdk.orbits(f, torch.from_numpy(syms), 3000).numpy(),
        np.asarray(jdk.orbits(jnp.asarray(want[0]), jnp.asarray(syms), 3000)))
    nseg = 1 << int(max(ends - syms) // 64 + 2).bit_length()
    for fix in (1, 3):
        gs, ge = tdk.segmented_orbits(f, eobf, torch.from_numpy(syms),
                                      torch.from_numpy(ends), nbits, nseg, 64,
                                      fix)
        ws, we = jax.jit(jdk.segmented_orbits, static_argnums=(4, 5, 6, 7))(
            jnp.asarray(want[0]), jnp.asarray(want[5]), jnp.asarray(syms),
            jnp.asarray(ends), nbits, nseg, 64, fix)
        np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
        assert int(ge) == int(we)

    # anchored walks from every 64th symbol, plus a lane that starts off
    # the lattice and one whose end anchor is off it (an overshoot: err)
    P = tdk.orbits(f, torch.from_numpy(syms), 1 << 15).numpy()
    starts, stops, tb = [], [], []
    for row, k in zip(P, huff):
        a = [int(x) for x in row[::64] if x < nbits]
        starts += a
        stops += a[1:] + [1 << 30]
        tb += [k * tdk.TABLE_SIZE] * len(a)
    starts[3] += 1
    stops[0] -= 1           # lane 0 lands past its end anchor
    lanes = (np.asarray(starts, np.int32), np.asarray(stops, np.int32),
             np.asarray(tb, np.int32))
    go = tdk.anchored_walk(tw, tl, td_, torch.from_numpy(lanes[2]),
                           torch.from_numpy(lanes[0]),
                           torch.from_numpy(lanes[1]))
    wo = jax.jit(jdk.anchored_walk)(jnp.asarray(w), jl, jd_,
                                    jnp.asarray(lanes[2]),
                                    jnp.asarray(lanes[0]),
                                    jnp.asarray(lanes[1]))
    for g, x in zip(go, wo):
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))
    assert int(go[3]) > 0


# ---- the v1 match expansion against the Pallas kernel ----------------------

_jassemble = jax.jit(jinf._assemble_pallas,
                     static_argnames=("out_cap", "nblocks"))


def _random_slots(seed, n_tok, nblocks):
    """Token slots (len, lit, dist) of random literals and matches with
    empty slots between them, lanes of 64 slots, and each block's first
    slot."""
    rng = np.random.default_rng(seed)
    S = -(-n_tok * 2 // 64) * 64
    o_len = np.zeros(S, np.int32)
    o_lit = np.zeros(S, np.int32)
    o_dist = np.zeros(S, np.int32)
    total = 0
    slots = np.sort(rng.choice(S, n_tok, replace=False))
    for s in slots:
        if total < 4 or rng.random() < 0.4:
            o_len[s], o_lit[s] = 1, rng.integers(256)
            total += 1
        else:
            # short matches and a few 258-byte ones: a block outputs at
            # most 64 KiB, as the reference kernel requires
            o_len[s] = 258 if rng.random() < 0.05 else rng.integers(3, 30)
            o_dist[s] = rng.integers(1, min(total + HALO, 32768) + 1)
            total += int(o_len[s])
    lanes = S // 64
    cuts = np.sort(rng.choice(np.arange(1, lanes), nblocks - 1,
                              replace=False)) if nblocks > 1 else []
    first = np.asarray([0] + [c * 64 for c in cuts] + [S], np.int32)
    return o_len, o_lit, o_dist, first, total


@pytest.mark.parametrize("nblocks,short", [(1, False), (4, False),
                                           (4, True)])
def test_assemble_kernel_matches_pallas(nblocks, short):
    """The port's _assemble_kernel (plain expansion on the CPU) against the
    reference's _assemble_pallas running its Pallas kernel in interpret
    mode: 2,000 random tokens behind a random halo, one block or four, and
    an out_cap too small for the output (err)."""
    o_len, o_lit, o_dist, first, total = _random_slots(nblocks, 2000,
                                                       nblocks)
    halo = np.random.default_rng(9).integers(0, 256, HALO, dtype=np.uint8)
    cap = 1 << (total - 1).bit_length()
    if short:
        cap //= 2
    with pltpu.force_tpu_interpret_mode():
        jo, jp, je = _jassemble(jnp.asarray(o_len), jnp.asarray(o_lit),
                                jnp.asarray(o_dist), jnp.asarray(halo),
                                out_cap=cap, first_slots=jnp.asarray(first),
                                nblocks=nblocks)
        jo = np.asarray(jo)
    to, tp, te = tinf._assemble_kernel(
        torch.from_numpy(o_len), torch.from_numpy(o_lit),
        torch.from_numpy(o_dist), torch.from_numpy(halo), cap,
        torch.from_numpy(first), nblocks)
    assert int(tp) == int(jp) == total
    assert int(te) == int(je)
    assert (int(te) > 0) == short
    np.testing.assert_array_equal(to.numpy(), jo)
    # and the slot referee of the other branches agrees
    ro, rp, _ = tdk.assemble_output(
        torch.from_numpy(o_len), torch.from_numpy(o_lit),
        torch.from_numpy(o_dist), torch.from_numpy(halo), cap)
    n = min(total, cap)
    np.testing.assert_array_equal(ro.numpy()[:n], jo[:n])


def test_expand_matches_ref_guards_bounds():
    """Matches outside the block ranges stay unexpanded; a match whose
    source leaves the buffer copies nothing."""
    buf = torch.zeros(64, dtype=torch.uint8)
    buf[:4] = torch.tensor([1, 2, 3, 4], dtype=torch.uint8)
    m_off = torch.tensor([4, 10, 60, 40], dtype=torch.int32)
    m_d = torch.tensor([4, 2, 70, 3], dtype=torch.int32)
    m_len = torch.tensor([6, 5, 3, 4], dtype=torch.int32)
    ranges = torch.tensor([[0, 3, 0, 0], [3, 3, 0, 0]], dtype=torch.int32)
    out = tex.expand_matches(buf, m_off, m_d, m_len, ranges).tolist()
    assert out[:15] == [1, 2, 3, 4, 1, 2, 3, 4, 1, 2, 1, 2, 1, 2, 1]
    assert out[15:] == [0] * 49


def test_decode_batch_anchored_kernel_path_matches_pallas(corpus):
    """The reference's decode_batch_anchored(use_pallas=True) in interpret
    mode against the port's kernel path (its plain expansion on the CPU), on
    the first batch of an anchors index."""
    data = _mixed(corpus, 1 << 15)
    raw = _zlib_raw(data, 6)
    index = _anchors_index(raw)
    td = tinf.RawInflater(device="cpu", **BATCH)
    W_pad = tinf._bucket((len(raw) >> 2) + 18, 1 << 13)
    work, _ = td._plan(raw, index, b"", W_pad)
    kind, item = next(w for w in work if w[0] != "stored")
    assert kind == "anchored"
    (tb, st, en, ll, dl, lanes, nb, oc, _, first, word_lo, ww, total,
     _) = item
    rawpad = np.zeros(W_pad * 4, np.uint8)
    rawpad[:len(raw)] = np.frombuffer(raw, np.uint8)
    words = rawpad.view(np.uint32)[word_lo:word_lo + ww]
    halo = np.zeros(HALO, np.uint8)
    with pltpu.force_tpu_interpret_mode():
        jo, jp, je, jw = jinf.decode_batch_anchored(
            jnp.asarray(words), jnp.asarray(tb), jnp.asarray(st),
            jnp.asarray(en), jnp.asarray(ll), jnp.asarray(dl),
            jnp.asarray(halo), lanes, nb, oc, True, jnp.asarray(first))
        jo, jw = np.asarray(jo), np.asarray(jw)
    t = torch.from_numpy
    args = (t(words.astype(np.int64)), t(tb), t(st), t(en), t(ll), t(dl),
            t(halo))
    to, tp, te, tw = tinf.decode_batch_anchored(*args, lanes, nb, oc, True,
                                                t(first))
    assert int(tp) == int(jp) == total
    assert int(te) == int(je) == 0
    np.testing.assert_array_equal(to.numpy(), jo)
    np.testing.assert_array_equal(tw.numpy(), jw)
    # the expansion's inputs, as a harness takes them beside the program
    buf, mats, produced = tinf.anchored_expand1_inputs(*args, nb, oc,
                                                       t(first))
    assert int(produced) == total
    assert not torch.equal(buf[HALO:HALO + oc], to)
    assert torch.equal(tex.expand_matches_ref(buf, *mats)[HALO:HALO + oc], to)


# ---- RawInflater on the anchored and dense branches ------------------------

@pytest.mark.parametrize("level", [1, 6, 9])
def test_anchors_index_decodes_equal(corpus, level):
    data = _mixed(corpus, 1 << 17)
    raw = _zlib_raw(data, level)
    out, stats = _both_decode(raw, _anchors_index(raw))
    assert out == data
    kinds = {k for k, _, _ in stats}
    assert "anchored" in kinds and kinds <= {"anchored", "stored"}
    assert all(e == 0 for _, _, e in stats)


def test_foreign_stream_no_anchor_index_decodes_equal(corpus):
    """The input of tests/test_inflate.py::test_foreign_stream_device_indexed:
    an index with block offsets only takes the dense branch."""
    data = corpus("binary", 30000)
    z = zlib.compress(data, 6)[2:-4]
    _, recs, _ = thi.inflate_raw(z)
    idx = {"block_bits": [r.bit_offset for r in recs],
           "block_bytes": [r.out_offset for r in recs], "n": len(data)}
    out, stats = _both_decode(z, idx)
    assert out == data
    assert [k for k, _, _ in stats] == ["dense"] * len(stats)


@pytest.mark.parametrize("level", [1, 6])
def test_dense_index_decodes_equal(corpus, level):
    data = _mixed(corpus, 1 << 17)
    raw = _zlib_raw(data, level)
    index = tinf.RawInflater(device="cpu").build_index(raw)
    out, stats = _both_decode(
        raw, {k: v for k, v in index.items() if k != "win"})
    assert out == data
    assert "dense" in {k for k, _, _ in stats}


@pytest.mark.parametrize("branch", ["anchored", "dense"])
def test_corrupted_stream_same_native_redecode(corpus, branch):
    """A flipped bit in a Huffman block's payload, or an anchor moved off
    the symbol lattice, makes the same batch err on both sides; both
    re-decode natively from it."""
    data = _mixed(corpus, 1 << 17)
    raw = _zlib_raw(data, 6)
    index = (_anchors_index(raw) if branch == "anchored" else
             {k: v for k, v in tinf.RawInflater(device="cpu").build_index(
                 raw).items() if k != "win"})
    _, recs, _ = thi.inflate_raw(raw)
    k = max((i for i, r in enumerate(recs) if r.btype),
            key=lambda i: (recs[i + 1].bit_offset if i + 1 < len(recs)
                           else len(raw) * 8) - recs[i].bit_offset)
    if branch == "anchored":
        anchors = [None if a is None else np.array(a)
                   for a in index["anchors"]]
        anchors[k][len(anchors[k]) // 2] += 1
        out, stats = _both_decode(raw, {**index, "anchors": anchors})
        assert out == data
    else:
        bad = bytearray(raw)
        mid = (recs[k].sym_bit_offset + (recs[k + 1].bit_offset if k + 1 <
                                         len(recs) else len(raw) * 8)) // 16
        bad[mid] ^= 0x10
        jd = jinf.RawInflater(**BATCH)
        td = tinf.RawInflater(device="cpu", **BATCH)
        try:
            jo = jd.decompress(bytes(bad), index=index)
        except Exception as e:          # the native decoder may refuse it
            with pytest.raises(Exception) as te:
                td.decompress(bytes(bad), index=index)
            assert type(te.value).__name__ == type(e).__name__
            assert str(te.value) == str(e)
            stats = None
        else:
            assert td.decompress(bytes(bad), index=index) == jo
            stats = [(k2, int(p), int(e)) for k2, p, e in td.last_stats]
            assert stats == [(k2, int(p), int(e))
                             for k2, p, e in jd.last_stats]
    if stats is not None:
        assert any(e > 0 for _, _, e in stats)


@pytest.mark.cuda
def test_expand1_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    o_len, o_lit, o_dist, first, total = _random_slots(4, 2000, 4)
    halo = np.random.default_rng(9).integers(0, 256, HALO, dtype=np.uint8)
    cap = 1 << (total - 1).bit_length()
    args = [torch.from_numpy(x).cuda() for x in (o_len, o_lit, o_dist, halo)]
    ko, kp, ke = tinf._assemble_kernel(*args, cap,
                                       torch.from_numpy(first).cuda(), 4)
    torch.cuda.synchronize()
    ro, rp, re_ = tinf._assemble_kernel(*(a.cpu() for a in args), cap,
                                        torch.from_numpy(first), 4)
    assert int(kp) == int(rp) and int(ke) == int(re_) == 0
    assert torch.equal(ko.cpu(), ro)
