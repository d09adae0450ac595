"""Parity of the port's encoder (jdeflate_tpu_torch.codec.deflate) with the
JAX package on the CPU, whole streams: RawDeflater streams and indexes
(window anchors included) byte-equal at levels 0, 1, 6 and 9, with fixed
codes, a preset dictionary, final=False, sync seams between batches, and
empty and tiny inputs; every stream also inflates through zlib and through
both packages' decoders. Tolerance: exact equality."""
import zlib

import numpy as np
import pytest
import torch

from jdeflate_tpu.codec import deflate as JD
from jdeflate_tpu.codec import levels as jlevels
from jdeflate_tpu.codec.inflate import RawInflater as JInflater
from jdeflate_tpu_torch.codec import deflate as TD
from jdeflate_tpu_torch.codec import levels as tlevels
from jdeflate_tpu_torch.codec.inflate import RawInflater as TInflater

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

BL, BATCH = 4096, 2          # one compiled JAX shape per level


def _zlib_raw_inflate(raw, dictionary=b""):
    d = zlib.decompressobj(-15, zdict=dictionary) if dictionary else \
        zlib.decompressobj(-15)
    return d.decompress(raw) + d.flush()


def _assert_index_equal(got, want):
    assert got.keys() == want.keys()
    for key in ("block_bits", "block_bytes", "sync_points", "n"):
        assert got[key] == want[key], key
    assert len(got["win"]) == len(want["win"])
    for a, b in zip(got["win"], want["win"]):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)


# ---- whole streams ----

_JENC = {}


def _jax_encoder(level, fixed_codes=False):
    """One JAX encoder per (level, fixed_codes) at the shared shape; the
    compiled program is cached by the JAX package itself."""
    key = (level, fixed_codes)
    if key not in _JENC:
        _JENC[key] = JD.RawDeflater(level=level, block_size=BL, batch=BATCH,
                                    fixed_codes=fixed_codes)
    return _JENC[key]


def _pair(level, fixed_codes=False):
    return (_jax_encoder(level, fixed_codes),
            TD.RawDeflater(level=level, block_size=BL, batch=BATCH,
                           fixed_codes=fixed_codes, device="cpu"))


def _mixed(corpus, n):
    k = n // 4
    return (corpus("text", k) + corpus("binary", k) + corpus("runs", k)
            + corpus("random", n - 3 * k))


@pytest.mark.parametrize("level", [0, 1, 6, 9])
def test_stream_and_index_match_jax(corpus, level):
    """Five blocks over three batches: two sync seams."""
    data = _mixed(corpus, 5 * BL - 700)
    jenc, tenc = _pair(level)
    jraw, jidx = jenc.compress(data)
    traw, tidx = tenc.compress(data)
    assert traw == jraw
    _assert_index_equal(tidx, jidx)
    assert len(tidx["sync_points"]) == 2
    assert _zlib_raw_inflate(traw) == data


@pytest.mark.parametrize("case", ["fixed_codes", "dictionary", "not_final"])
def test_stream_options_match_jax(corpus, case):
    data = _mixed(corpus, 3 * BL + 11)
    kw = {}
    dictionary = b""
    if case == "dictionary":
        dictionary = corpus("text", 6000)
        data = dictionary[1000:4000] + data
        kw["dictionary"] = dictionary
    if case == "not_final":
        kw["final"] = False
    jenc, tenc = _pair(6, fixed_codes=case == "fixed_codes")
    jraw, jidx = jenc.compress(data, **kw)
    traw, tidx = tenc.compress(data, **kw)
    assert traw == jraw
    _assert_index_equal(tidx, jidx)
    if case == "not_final":
        # a sync-flush tail: decodable, with no BFINAL block
        d = zlib.decompressobj(-15)
        assert d.decompress(traw) == data and not d.eof
        assert tidx["sync_points"][-1] == len(traw)
    else:
        assert _zlib_raw_inflate(traw, dictionary) == data


def test_empty_and_tiny_inputs_match_jax(corpus):
    jenc, tenc = _pair(6)
    for n in (0, 1, 2, 3, 4, 300, BL, BL + 1):
        data = corpus("text", n)
        for final in (True, False):
            jraw, jidx = jenc.compress(data, final=final)
            traw, tidx = tenc.compress(data, final=final)
            assert traw == jraw, (n, final)
            _assert_index_equal(tidx, jidx)
        assert _zlib_raw_inflate(traw) == data if final else True


@pytest.mark.parametrize("level", [6, 9])
def test_port_stream_decodes_in_both_packages(corpus, level):
    """The port's stream and index decode on the windowed path of the JAX
    RawInflater and of the port's own (device="cpu")."""
    data = _mixed(corpus, 5 * BL - 700)
    _, tenc = _pair(level)
    raw, idx = tenc.compress(data)
    jdec = JInflater()
    assert jdec.decompress(raw, index=idx) == data
    assert all(k in ("win", "stored") and e == 0
               for k, _, e in jdec.last_stats)
    tdec = TInflater(device="cpu")
    assert tdec.decompress(raw, index=idx) == data
    assert "win" in [k for k, _, _ in tdec.last_stats]
    assert all(e == 0 for _, _, e in tdec.last_stats)
