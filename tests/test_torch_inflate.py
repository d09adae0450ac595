"""Parity of the port's windowed decode path (codec.inflate, ops.expand2,
ops.decode of jdeflate_tpu_torch) with the JAX package on the CPU: the plain
token expansion against _assemble_output, and RawInflater.build_index and
decompress on zlib streams, on streams with the JAX encoder's index, on a
stream whose index has a tampered anchor, on the segment clamp of ROADMAP
C5, and with the v5 engine switched on. Tolerance: exact equality of bytes,
indexes, batch kinds, produced counts and err flags."""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jdeflate_tpu.codec import inflate as jinf
from jdeflate_tpu.ops import walk as jwalk
from jdeflate_tpu.stream import zstrm as jz
from jdeflate_tpu_torch.codec import inflate as tinf
from jdeflate_tpu_torch.ops import expand2 as tex
from jdeflate_tpu_torch.ops import walk as twalk
from jdeflate_tpu_torch.utils import errors as terrors

# small batches, so a 256 KiB stream spans several halo-chained batches
BATCH = dict(max_batch_bits=1 << 18, max_batch_blocks=8,
             max_batch_out=1 << 16)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tensors here are small; torch's default thread pool only spins
    against the other test workers' JAX compiles."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mixed(corpus, n=1 << 18):
    q = n // 4
    return (corpus("text", q) + corpus("binary", q) + corpus("runs", q)
            + corpus("random", q // 4) + corpus("text", q - q // 4))


def _zlib_raw(data, level, zdict=None):
    co = (zlib.compressobj(level, zlib.DEFLATED, -15, zdict=zdict) if zdict
          else zlib.compressobj(level, zlib.DEFLATED, -15))
    return co.compress(data) + co.flush()


def _assert_index_equal(a, b):
    for key in ("block_bits", "block_bytes", "n", "end_bit"):
        assert list(np.atleast_1d(a[key])) == list(np.atleast_1d(b[key])), key
    assert len(a["win"]) == len(b["win"])
    for wa, wb in zip(a["win"], b["win"]):
        assert (wa is None) == (wb is None)
        if wa is not None:
            np.testing.assert_array_equal(np.asarray(wa), np.asarray(wb))


def _both_decode(raw, index, dictionary=b""):
    jd = jinf.RawInflater(**BATCH)
    td = tinf.RawInflater(device="cpu", **BATCH)
    jo = jd.decompress(raw, index=index, dictionary=dictionary)
    to = td.decompress(raw, index=index, dictionary=dictionary)
    assert to == jo
    assert [(k, int(p), int(e)) for k, p, e in td.last_stats] == \
        [(k, int(p), int(e)) for k, p, e in jd.last_stats]
    return to, td.last_stats


def _batch_tokens(raw, dictionary=b""):
    """Lane-major walk tokens, outlen and halo of the first windowed batch of
    the port's decode of `raw`."""
    td = tinf.RawInflater(device="cpu", **BATCH)
    td.capture_calls = True
    index = td.build_index(raw, dictionary)
    td.decompress(raw, index=index, dictionary=dictionary)
    words, metas, row, halo, npe, nb, oc, ww = td.last_calls[0]
    args = tinf._walk_inputs(words, metas[row], npe, nb, ww)
    tok, _, outlen = twalk.walk_checked(*args)[:3]
    return tok, outlen, halo, oc


def _jax_slots(tok_u32):
    kind = tok_u32 >> 30
    o_len = np.where(kind == 1, 1, np.where(kind == 2, tok_u32 & 0x1FF, 0))
    o_dist = np.where(kind == 2, ((tok_u32 >> 9) & 0x7FFF) + 1, 0)
    o_lit = np.where(kind == 1, tok_u32 & 0xFF, 0)
    return [jnp.asarray(x.reshape(-1).astype(np.int32))
            for x in (o_len, o_lit, o_dist)]


@pytest.mark.parametrize("cap", ["fits", "short"])
def test_expand_tokens_ref_matches_assemble_output(corpus, cap):
    """The plain expansion equals the reference's _assemble_output on real
    walk tokens behind a dictionary halo, also when out_cap is too small."""
    zdict = corpus("text", 8000)
    data = zdict[1000:5000] + _mixed(corpus, 1 << 16)
    raw = _zlib_raw(data, 6, zdict)
    tok, outlen, halo, oc = _batch_tokens(raw, zdict)
    if cap == "short":
        oc = int(outlen.sum()) // 2
    tok_u = tok.numpy().view(np.uint32)
    jout, jprod, jerr = jinf._assemble_output(
        *_jax_slots(tok_u), jnp.asarray(halo.numpy()), oc)
    ann = twalk.annotate_lit_runs(tok)
    np.testing.assert_array_equal(
        ann.numpy().view(np.uint32),
        np.asarray(jwalk.annotate_lit_runs(jnp.asarray(tok_u))))
    for t in (tok, ann):
        out, prod, err = tex.expand_tokens_ref(t, outlen, halo, oc)
        assert int(prod) == int(jprod) and int(err) == int(jerr)
        np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    assert (int(jerr) > 0) == (cap == "short")
    # the wrapper takes the plain version for a CPU tensor
    out, prod, err = tex.expand_tokens(ann, outlen, halo, oc)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))


@pytest.mark.parametrize("level", [1, 6, 9])
def test_zlib_stream_index_and_decode_match_jax(corpus, level):
    data = _mixed(corpus)
    raw = _zlib_raw(data, level)
    tidx = tinf.RawInflater(device="cpu").build_index(raw)
    jidx = jinf.RawInflater().build_index(raw)
    _assert_index_equal(tidx, jidx)
    out, stats = _both_decode(raw, jidx)
    assert out == data
    assert sum(k == "win" for k, _, _ in stats) >= 2


@pytest.mark.parametrize("level", [1, 6])
def test_jax_encoder_index_decodes_equal(corpus, level):
    """A stream and index from the JAX encoder (compress_with_index)."""
    data = _mixed(corpus, 1 << 17)
    raw, index, hl = jz.compress_with_index(data, format="raw", level=level)
    assert hl == 0
    out, stats = _both_decode(raw, index)
    assert out == data
    assert all(e == 0 for _, _, e in stats)
    assert any(k == "win" for k, _, _ in stats)


def test_tampered_anchor_same_fallback(corpus):
    """A wrong window anchor makes the same batch err on both sides; both
    re-decode natively from it and still return the right bytes."""
    data = _mixed(corpus)
    raw = _zlib_raw(data, 6)
    index = tinf.RawInflater(device="cpu").build_index(raw)
    k = max(range(len(index["win"])),
            key=lambda i: -1 if index["win"][i] is None
            else len(index["win"][i]))
    win = [None if w is None else np.array(w) for w in index["win"]]
    valid = np.nonzero(win[k] >= 0)[0]
    win[k][valid[len(valid) // 2]] += 1
    out, stats = _both_decode(raw, {**index, "win": win})
    assert out == data
    assert any(k2 == "win" and e > 0 for k2, _, e in stats)


def test_segment_clamp_matches_reference():
    """ROADMAP C5 (repaired): the last pseudo-entry's word segment clamps
    into the batch's bucketed window on both sides, so that batch reads
    shifted words, fails its exit-chain check and falls back to the native
    decoder on both sides. Bytes and last_stats are equal."""
    rng = np.random.default_rng(1)
    words = [b"the ", b"quick ", b"brown ", b"fox ", b"jumps \n"]
    data = (b"".join(words[i] for i in rng.integers(0, 5, 60000))[:200000]
            + rng.integers(0, 256, 50000, dtype=np.uint8).tobytes()
            + bytes(30000))
    raw = _zlib_raw(data, 9)
    index = tinf.RawInflater(device="cpu").build_index(raw)
    jd, td = jinf.RawInflater(), tinf.RawInflater(device="cpu")
    assert jd.decompress(raw, index=index) == data
    assert td.decompress(raw, index=index) == data
    (jk, _, je), = jd.last_stats
    assert jk == "win" and int(je) > 0
    assert [(k, int(p), int(e)) for k, p, e in td.last_stats] == \
        [(k, int(p), int(e)) for k, p, e in jd.last_stats]


def test_dictionary_stream_matches_jax(corpus):
    zdict = corpus("binary", 20000)
    data = zdict[5000:15000] + corpus("text", 30000)
    raw = _zlib_raw(data, 6, zdict)
    index = tinf.RawInflater(device="cpu").build_index(raw, zdict)
    out, stats = _both_decode(raw, index, zdict)
    assert out == data and all(e == 0 for _, _, e in stats)


def test_index_without_window_anchors_is_refused(corpus):
    """An index without window anchors is not refused (the name is kept
    from when the port refused it): every batch takes the dense branch, as
    in the reference, with equal bytes and last_stats."""
    data = corpus("text", 20000)
    raw = _zlib_raw(data, 6)
    index = tinf.RawInflater(device="cpu").build_index(raw)
    index = {k: v for k, v in index.items() if k != "win"}
    out, stats = _both_decode(raw, index)
    assert out == data
    assert [k for k, _, _ in stats] == ["dense"] * len(stats)


def test_engine_switch_v5(corpus, monkeypatch):
    """JDT_EXPAND=5 sends the windowed batches through the v5 engine: the
    bytes are exact and the batch kinds are engine 2's (the reference on the
    CPU never takes engine 5, so err parity is held in
    tests/test_torch_expand5.py)."""
    data = _mixed(corpus)
    raw = _zlib_raw(data, 6)
    index = tinf.RawInflater(device="cpu").build_index(raw)
    td = tinf.RawInflater(device="cpu", **BATCH)
    assert td.decompress(raw, index=index) == data
    kinds2 = [k for k, _, _ in td.last_stats]
    monkeypatch.setenv("JDT_EXPAND", "5")
    assert td.decompress(raw, index=index) == data
    assert [k for k, _, _ in td.last_stats] == kinds2
    assert all(e == 0 for _, _, e in td.last_stats)
    jd = jinf.RawInflater(**BATCH)
    assert jd.decompress(raw, index=index) == data
    assert [k for k, _, _ in jd.last_stats] == kinds2


def test_cuda_requested_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(terrors.IncorrectUseError):
        tinf.RawInflater()


@pytest.mark.cuda
def test_expand_kernel_matches_plain_on_card(corpus):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    zdict = corpus("text", 8000)
    data = zdict[1000:5000] + _mixed(corpus, 1 << 16)
    raw = _zlib_raw(data, 6, zdict)
    tok, outlen, halo, oc = _batch_tokens(raw, zdict)
    ann = twalk.annotate_lit_runs(tok).cuda()
    out, prod, err = tex.expand_tokens(ann, outlen.cuda(), halo.cuda(), oc)
    rout, rprod, rerr = tex.expand_tokens_ref(ann, outlen.cuda(),
                                              halo.cuda(), oc)
    torch.cuda.synchronize()
    n = int(rprod)
    assert int(prod) == n and int(err) == 0 and int(rerr) == 0
    assert torch.equal(out[:n], rout[:n])
