"""Parity of the port's window walk (jdeflate_tpu_torch.ops.walk) with the
JAX package's ops/walk.py on the CPU: entry tables, the plain walk on real
zlib streams, fixed-Huffman blocks and invalid trees, and the literal-run
annotation. Tolerance: exact equality (a lossless codec). The CUDA kernel's
own check against the plain version needs a card (marker `cuda`)."""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jdeflate_tpu.ops import walk as jwalk
from jdeflate_tpu_torch.ops import walk as twalk
from jdeflate_tpu_torch.stream import host_inflate as thi

_jwalk_ref = jax.jit(jwalk.walk_ref)
_jtables = jax.jit(jwalk.build_entry_tables)


def _bucket(n, base):
    b = base
    while b < n:
        b *= 2
    return b


def _lengths(recs):
    """(E, 288), (E, 32) code lengths of the Huffman blocks, E bucketed."""
    huff = [r for r in recs if r.btype != 0]
    E = _bucket(len(huff), 8)
    ll = np.zeros((E, 288), np.int32)
    dl = np.zeros((E, 32), np.int32)
    for e, r in enumerate(huff):
        ll[e, :len(r.litlen_lengths)] = r.litlen_lengths
        dl[e, :len(r.dist_lengths)] = r.dist_lengths
    return huff, ll, dl


def stream_lanes(raw, recs):
    """Every Huffman block's windows as walk lanes, laid out as in
    tests/test_walk.py but concatenated: each block's lanes padded to whole
    128-lane rows (one tree per row), the total to a bucket of rows.
    Returns (seg0, seg1, seg2 u32, start_rel i32, row_tree i32, ll, dl)."""
    huff, ll, dl = _lengths(recs)
    pad = raw + b"\x00" * 16
    words = np.frombuffer(pad[: (len(pad) // 4) * 4], np.uint8).view("<u4")
    seg, starts, row_tree = [], [], []
    for e, rec in enumerate(huff):
        anchors = np.asarray(rec.win_anchors, np.int64)
        w0 = (rec.sym_bit_offset & ~31) >> 5
        L = len(anchors)
        Lp = -(-L // 128) * 128
        j = np.arange(Lp)
        wj = np.minimum(w0 + j, len(words) - 3)
        seg.append(np.stack([words[wj], words[wj + 1], words[wj + 2]]))
        st = np.full(Lp, -1, np.int32)
        st[:L] = np.where(anchors >= 0, anchors - (w0 + np.arange(L)) * 32,
                          -1)
        starts.append(st)
        row_tree += [e] * (Lp // 128)
    seg = np.concatenate(seg, 1)
    start_rel = np.concatenate(starts)
    Ltot = _bucket(seg.shape[1], 4096)
    extra = Ltot - seg.shape[1]
    seg = np.pad(seg, ((0, 0), (0, extra)))
    start_rel = np.pad(start_rel, (0, extra), constant_values=-1)
    row_tree = np.asarray(row_tree + [0] * (extra // 128), np.int32)
    return seg[0], seg[1], seg[2], start_rel, row_tree, ll, dl


def both_walks(seg0, seg1, seg2, start_rel, row_tree, ll, dl):
    """Run the JAX and the port's walk_ref on the same lanes; return both
    results as numpy (tok lane-major as u32)."""
    jt = _jtables(jnp.asarray(ll), jnp.asarray(dl))
    tt = twalk.build_entry_tables(torch.from_numpy(ll), torch.from_numpy(dl))
    for a, b in zip(jt, tt):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    jrows = [jnp.asarray(np.asarray(t)[row_tree]) for t in jt]
    trows = [t[torch.from_numpy(row_tree).long()] for t in tt]
    jres = _jwalk_ref(jnp.asarray(seg0), jnp.asarray(seg1), jnp.asarray(seg2),
                      jnp.asarray(start_rel), *jrows)
    tres = twalk.walk_ref(
        torch.from_numpy(seg0.view(np.int32)),
        torch.from_numpy(seg1.view(np.int32)),
        torch.from_numpy(seg2.view(np.int32)),
        torch.from_numpy(start_rel), *trows)
    jtok, jol, jcnt, jerr, jpos, jeob = (np.asarray(x) for x in jres)
    want = (jtok.T, jol, jcnt, jerr, jpos, jeob)
    got = tuple(x.numpy() for x in tres)
    got = (got[0].view(np.uint32),) + got[1:]
    return want, got


def assert_walks_equal(want, got):
    names = ("tok", "outlen", "cnt", "err", "pos", "eob")
    for name, w, g in zip(names, want, got):
        assert w.shape == g.shape, name
        np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=name)


def _zlib_raw(data, level, strategy=zlib.Z_DEFAULT_STRATEGY):
    co = zlib.compressobj(level, zlib.DEFLATED, -15, 8, strategy)
    return co.compress(data) + co.flush()


@pytest.mark.parametrize("kind", ["text", "runs", "random", "binary"])
@pytest.mark.parametrize("level", [1, 6, 9])
def test_walk_ref_matches_jax(corpus, kind, level):
    data = corpus(kind, 1 << 16)
    if kind == "random":
        # zlib stores pure noise; a text prefix keeps it in a Huffman block
        # whose literals take long codes
        data = corpus("text", 4096) + data
    raw = _zlib_raw(data, level)
    out, recs, _ = thi.inflate_raw(raw)
    assert out == data
    assert any(r.btype != 0 for r in recs)
    want, got = both_walks(*stream_lanes(raw, recs))
    assert_walks_equal(want, got)
    # a clean stream decodes without a lane error and reaches its EOB
    assert not got[3].any() and got[5].any()


def test_walk_ref_fixed_huffman_block():
    data = b"hello hello hello world " * 200 + bytes(range(256)) * 4
    raw = _zlib_raw(data, 6, zlib.Z_FIXED)
    out, recs, _ = thi.inflate_raw(raw)
    assert out == data and all(r.btype == 1 for r in recs)
    want, got = both_walks(*stream_lanes(raw, recs))
    assert_walks_equal(want, got)
    assert not got[3].any()


def _tree_case(case):
    ll = np.zeros((8, 288), np.int32)
    dl = np.zeros((8, 32), np.int32)
    if case == "oversubscribed":
        ll[0, :6] = 1           # six 1-bit codes: Kraft sum 3
        ll[0, 256] = 2
        ll[0, 257:262] = 3
        dl[0, :4] = 1
    elif case == "incomplete":
        ll[0, 0] = 1            # Kraft sum 3/4: code '11' is invalid
        ll[0, 256] = 2
        dl[0, 0] = 1
    else:                       # fixed tree: symbols 286/287 and dist 30/31
        ll[0] = np.r_[[8] * 144, [9] * 112, [7] * 24, [8] * 8]
        dl[0] = 5
    return ll, dl


@pytest.mark.parametrize("case", ["oversubscribed", "incomplete", "fixed"])
def test_walk_ref_invalid_and_edge_trees(case):
    """Random words through degenerate trees: errors, exit positions and
    tokens must come out exactly as in the reference. (An oversubscribed
    tree decodes without error there: its first limit clamps to 2^15. The
    header parse rejects such trees before they reach the walk.)"""
    rng = np.random.default_rng(7)
    ll, dl = _tree_case(case)
    L = 4096
    seg = rng.integers(0, 1 << 32, (3, L), dtype=np.uint64).astype(np.uint32)
    start_rel = rng.integers(-4, 32, L).astype(np.int32)
    row_tree = np.zeros(L // 128, np.int32)
    want, got = both_walks(seg[0], seg[1], seg[2], start_rel, row_tree, ll,
                           dl)
    assert_walks_equal(want, got)
    if case == "incomplete":
        assert got[3].any()


def test_annotate_lit_runs_matches_jax():
    rng = np.random.default_rng(3)
    L, S = 512, twalk.S_SLOTS
    kind = rng.integers(0, 3, (L, S)).astype(np.uint32)
    # a lane ends at its first empty slot, as the walk emits it
    ended = np.cumsum(kind == 0, axis=1) > 0
    kind = np.where(ended, 0, kind)
    body = rng.integers(0, 1 << 24, (L, S)).astype(np.uint32) & 0xFFFFFF
    body = np.where(kind == 1, body & 0xFF, body)
    tok = np.where(kind == 0, 0, (kind << 30) | body).astype(np.uint32)
    want = np.asarray(jwalk.annotate_lit_runs(jnp.asarray(tok)))
    got = twalk.annotate_lit_runs(torch.from_numpy(tok.view(np.int32)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.cuda
def test_walk_kernel_matches_plain_on_card(corpus):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from jdeflate_tpu_torch.codec import inflate as I
    data = corpus("text", 1 << 18)
    raw = _zlib_raw(data, 6)
    dec = I.RawInflater(device="cuda")
    dec.capture_calls = True
    assert dec.decompress(raw, index=dec.build_index(raw)) == data
    words, metas, row, _, npe, nb, _, ww = dec.last_calls[0]
    args = I._walk_inputs(words, metas[row], npe, nb, ww)
    got = twalk.walk_checked(*args)
    want = twalk.walk_checked_ref(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.to(w.dtype), w)
    tok, outlen, cnt, err, pos, eob = twalk.walk_windows_ref(*args[:8])
    assert torch.equal(got[0], tok)
    assert torch.equal(got[1], twalk.pack_meta(outlen, cnt, err, pos, eob))
