"""Parity of the port's framed compression (jdeflate_tpu_torch.stream.zstrm
compress / compress_with_index) with the JAX package on the CPU: raw, zlib
(with and without a preset dictionary) and gzip bytes, the index and header
length, and the FEXTRA self-indexed gzip member, which the port then
decodes on its windowed path. Tolerance: exact equality."""
import zlib

import numpy as np
import pytest
import torch

import jdeflate_tpu as jd
import jdeflate_tpu_torch as jdt
from jdeflate_tpu.codec import levels as jlevels
from jdeflate_tpu_torch.codec import inflate as tinf
from jdeflate_tpu_torch.codec import levels as tlevels

# both sides run the same (CPU-capped) probe depths, tests/conftest.py
tlevels._PROBE_CAP.update(jlevels._PROBE_CAP)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small; torch's default thread pool only spins
    against the other test workers' JAX compiles."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SHAPE = dict(block_size=4096, batch=2)


def _data(corpus):
    return corpus("text", 7000) + corpus("binary", 5000) + corpus("runs", 900)


@pytest.mark.parametrize("fmt", ["raw", "zlib", "zlib_dict", "gzip"])
def test_compress_matches_jax(corpus, fmt):
    data = _data(corpus)
    kw = dict(SHAPE)
    if fmt == "zlib_dict":
        kw["dictionary"] = corpus("text", 3000)
        fmt = "zlib"
    want = jd.compress(data, format=fmt, **kw)
    got = jdt.compress(data, format=fmt, device="cpu", **kw)
    assert got == want
    if fmt == "gzip":
        assert zlib.decompress(got, 31) == data
    elif fmt == "zlib" and "dictionary" not in kw:
        assert zlib.decompress(got) == data
    assert jdt.decompress(got, format=fmt, dictionary=kw.get("dictionary"),
                          device="cpu") == data


@pytest.mark.parametrize("fmt", ["raw", "zlib", "gzip"])
def test_compress_with_index_matches_jax(corpus, fmt):
    data = _data(corpus)
    wout, widx, whl = jd.compress_with_index(data, format=fmt, **SHAPE)
    gout, gidx, ghl = jdt.compress_with_index(data, format=fmt,
                                              device="cpu", **SHAPE)
    assert gout == wout and ghl == whl
    for key in ("block_bits", "block_bytes", "sync_points", "n"):
        assert gidx[key] == widx[key], key
    for a, b in zip(gidx["win"], widx["win"]):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    tinf.STATS_LOG.clear()
    assert jdt.decompress(gout, format=fmt, index=gidx, header_len=ghl,
                          device="cpu") == data
    assert "win" in [k for k, _, _ in tinf.STATS_LOG]


def test_embedded_index_matches_jax_and_decodes(corpus):
    data = _data(corpus)
    want = jd.compress(data, format="gzip", embed_index=True, **SHAPE)
    got = jdt.compress(data, format="gzip", embed_index=True, device="cpu",
                       **SHAPE)
    assert got == want
    assert zlib.decompress(got, 31) == data
    tinf.STATS_LOG.clear()
    assert jdt.decompress(got, device="cpu") == data
    kinds = [k for k, _, _ in tinf.STATS_LOG]
    assert "win" in kinds and all(e == 0 for _, _, e in tinf.STATS_LOG)


def test_compress_errors_match_jax(corpus):
    data = corpus("text", 100)
    for kw in (dict(format="lz4"), dict(format="gzip", dictionary=b"abc")):
        with pytest.raises(jd.errors.JDeflateError) as je:
            jd.compress(data, **kw)
        with pytest.raises(jdt.errors.JDeflateError) as te:
            jdt.compress(data, device="cpu", **kw)
        assert type(te.value).__name__ == type(je.value).__name__
