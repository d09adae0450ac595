"""Parity of the port's framed decompression (jdeflate_tpu_torch.stream.zstrm)
and checksums (ops.checksum) with the JAX package and zlib on the CPU:
gzip (single member with an index, multi-member, FEXTRA self-indexed), zlib
with a preset dictionary, raw; the same error class for bad input; and an
import of the port that pulls in neither jax nor jdeflate_tpu."""
import os
import subprocess
import sys
import zlib

import numpy as np
import pytest

import jdeflate_tpu as jd
from jdeflate_tpu.ops import checksum as jcs
import jdeflate_tpu_torch as jdt
from jdeflate_tpu_torch.codec import inflate as tinf
from jdeflate_tpu_torch.formats import headers as H
from jdeflate_tpu_torch.ops import checksum as tcs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _gzip(data, level=6):
    co = zlib.compressobj(level, zlib.DEFLATED, 31)
    return co.compress(data) + co.flush()


def test_gzip_with_index_decodes_and_verifies(corpus):
    data = corpus("text", 100000) + corpus("binary", 60000)
    gz = _gzip(data)
    hl = H.parse_gzip_header(gz)
    index = tinf.RawInflater(device="cpu").build_index(gz[hl:-8])
    out = jdt.decompress(gz, index=index, header_len=hl, device="cpu")
    assert out == data == jd.decompress(gz, index=index, header_len=hl)


def test_gzip_multimember_matches_jax(corpus):
    a, b, c = corpus("text", 40000), corpus("runs", 30000), corpus("binary",
                                                                   20000)
    blob = _gzip(a, 1) + _gzip(b, 6) + _gzip(c, 9)
    assert jdt.decompress(blob, device="cpu") == a + b + c \
        == jd.decompress(blob)


def test_gzip_fextra_self_indexed_from_jax(corpus):
    """compress(embed_index=True) members carry their index in FEXTRA; the
    port decodes them on the windowed path, also as a multi-member blob."""
    # equal sizes keep the JAX encoder at one compiled shape
    a, b = corpus("text", 50000), corpus("binary", 50000)
    ea = jd.compress(a, format="gzip", embed_index=True)
    eb = jd.compress(b, format="gzip", embed_index=True)
    tinf.STATS_LOG.clear()
    assert jdt.decompress(ea + eb, device="cpu") == a + b
    kinds = [k for k, _, _ in tinf.STATS_LOG]
    assert "win" in kinds and all(e == 0 for _, _, e in tinf.STATS_LOG)


@pytest.mark.parametrize("fmt", ["zlib_fdict", "raw"])
def test_zlib_dictionary_and_raw(corpus, fmt):
    zdict = corpus("text", 10000)
    data = zdict[2000:7000] + corpus("binary", 40000)
    if fmt == "raw":
        co = zlib.compressobj(6, zlib.DEFLATED, -15)
        blob = co.compress(data) + co.flush()
        index = tinf.RawInflater(device="cpu").build_index(blob)
        got = jdt.decompress(blob, format="raw", index=index, device="cpu")
        assert got == data == jd.decompress(blob, format="raw", index=index)
        return
    co = zlib.compressobj(6, zlib.DEFLATED, 15, zdict=zdict)
    blob = co.compress(data) + co.flush()
    assert jdt.decompress(blob, dictionary=zdict, device="cpu") == data \
        == jd.decompress(blob, dictionary=zdict)
    # the same stream with its body indexed takes the windowed path
    index = tinf.RawInflater(device="cpu").build_index(blob[6:-4], zdict)
    assert jdt.decompress(blob, dictionary=zdict, index=index,
                          device="cpu") == data


@pytest.mark.parametrize("n", [0, 1, 255, 256, 257, 4099, 65536, 300001])
def test_checksums_match_jax_and_zlib(n):
    rng = np.random.default_rng(n)
    buf = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    for init in (0, 0x12345678):
        want = zlib.crc32(buf, init)
        assert tcs.crc32(buf, init, device="cpu") == want \
            == jcs.crc32(buf, init)
    for init in (1, 0x00ABCDEF):
        want = zlib.adler32(buf, init)
        assert tcs.adler32(buf, init, device="cpu") == want \
            == jcs.adler32(buf, init)


def test_checksum_combines_match_jax():
    rng = np.random.default_rng(11)
    for la, lb in ((0, 10), (10, 0), (1000, 70000), (65521, 3)):
        a = rng.integers(0, 256, la, dtype=np.uint8).tobytes()
        b = rng.integers(0, 256, lb, dtype=np.uint8).tobytes()
        c1, c2 = zlib.crc32(a), zlib.crc32(b)
        assert tcs.crc32_combine(c1, c2, lb) == zlib.crc32(a + b) \
            == jcs.crc32_combine(c1, c2, lb)
        a1, a2 = zlib.adler32(a), zlib.adler32(b)
        assert tcs.adler32_combine(a1, a2, lb) == zlib.adler32(a + b) \
            == jcs.adler32_combine(a1, a2, lb)


def _error_cases(corpus):
    data = corpus("text", 20000)
    gz = bytearray(_gzip(data))
    gz[-8] ^= 0xFF                                  # CRC32 trailer
    zdict = corpus("binary", 4000)
    co = zlib.compressobj(6, zlib.DEFLATED, 15, zdict=zdict)
    zd = co.compress(data) + co.flush()
    zl = bytearray(zlib.compress(data))
    zl[-1] ^= 0x01                                  # adler32 trailer
    return {
        "bad_gzip_magic": (b"\x1f\x8c" + bytes(gz[2:]), {"format": "gzip"}),
        "bad_zlib_header": (b"\x78\x02" + bytes(zl[2:]), {"format": "zlib"}),
        "bad_gzip_trailer": (bytes(gz), {}),
        "bad_zlib_trailer": (bytes(zl), {}),
        "missing_dictionary": (zd, {}),
        "bad_dictionary": (zd, {"dictionary": zdict[::-1]}),
        "unknown_format": (bytes(zl), {"format": "lz4"}),
        "empty": (b"", {}),
    }


@pytest.mark.parametrize("case", [
    "bad_gzip_magic", "bad_zlib_header", "bad_gzip_trailer",
    "bad_zlib_trailer", "missing_dictionary", "bad_dictionary",
    "unknown_format", "empty"])
def test_same_error_class_as_jax(corpus, case):
    blob, kw = _error_cases(corpus)[case]
    with pytest.raises(jd.errors.JDeflateError) as je:
        jd.decompress(blob, **kw)
    with pytest.raises(jdt.errors.JDeflateError) as te:
        jdt.decompress(blob, device="cpu", **kw)
    assert type(te.value).__name__ == type(je.value).__name__


def test_constants_match_jax():
    from jdeflate_tpu.formats import constants as jc
    from jdeflate_tpu_torch.formats import constants as tc
    names = [n for n in dir(jc) if n.isupper()]
    assert names == [n for n in dir(tc) if n.isupper()]
    for n in names:
        np.testing.assert_array_equal(getattr(tc, n), getattr(jc, n),
                                      err_msg=n)


@pytest.mark.parametrize("level", [1, 6])
def test_index_framing_matches_jax(corpus, level):
    """pack_index / FEXTRA header emit and parse / unpack_index give the
    same bytes and fields as the JAX package on a real zlib index."""
    from jdeflate_tpu.formats import headers as JH
    data = corpus("text", 60000) + corpus("random", 20000)
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    raw = co.compress(data) + co.flush()
    index = {**tinf.RawInflater(device="cpu").build_index(raw),
             "clen": len(raw)}
    packed = H.pack_index(index)
    assert packed == JH.pack_index(index)
    hdr = H.emit_gzip_header_with_extra(packed)
    assert hdr == JH.emit_gzip_header_with_extra(packed)
    assert H.parse_gzip_header(hdr) == JH.parse_gzip_header(hdr) == len(hdr)
    extra = H.parse_gzip_extra(hdr)
    assert extra == JH.parse_gzip_extra(hdr) == packed
    got, want = H.unpack_index(extra), JH.unpack_index(extra)
    assert got.keys() == want.keys()
    for key in ("n", "clen", "block_bits", "block_bytes", "sync_points"):
        assert got[key] == want[key], key
    for a, b in zip(got["win_deltas"], want["win_deltas"]):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    # the unpacked deltas decode on the windowed path to the same bytes
    tinf.STATS_LOG.clear()
    assert tinf.RawInflater(device="cpu").decompress(raw, index=got) == data
    assert "win" in [k for k, _, _ in tinf.STATS_LOG]


def test_import_pulls_in_no_jax():
    code = ("import sys, jdeflate_tpu_torch, jdeflate_tpu_torch.codec.inflate,"
            " jdeflate_tpu_torch.parallel.shard;"
            "from jdeflate_tpu_torch import ZStream, get_version;"
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'jdeflate_tpu' "
            "or m.startswith('jdeflate_tpu.')];"
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
