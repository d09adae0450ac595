"""zlib streams written by zlib itself, indexed by the port's
RawInflater.build_index and decoded through zstrm.decompress with that
index, on the CPU, across zlib's settings: levels 1, 6 and 9 at the
defaults; level 6 with each other strategy (Z_FILTERED, Z_HUFFMAN_ONLY,
Z_RLE, Z_FIXED); memLevel 1 and 9 (zlib ends a block every 2^(memLevel+6)
symbols, less one); a 512-byte window (wbits 9); a preset dictionary
(FDICT).

Each case holds the port to the payload and to the JAX package: the index
equals the JAX build_index's, the bytes and every batch's (kind, produced,
err) equal the JAX RawInflater's on the same bytes and index (at level 6,
level 9, Z_FILTERED, memLevel 9 and with the dictionary the one windowed
batch errs by ROADMAP C5 in both packages, and the native decoder takes
over); and to its own tracing: the build_index request counts its entries, and the decode's
record holds the adler32 span, the bytes adler32 read (the payload, and
the dictionary whose id the header names) and the card's bytes by
card_bytes' rule. A flipped Adler-32 trailer and a wrong preset dictionary
raise.

Payloads: tests/conftest.py::make_corpus text with random stretches, from
seeded generators (ROADMAP C16). Tolerance: exact equality.
"""
import functools
import zlib

import numpy as np
import pytest
import torch

from conftest import make_corpus
from jdeflate_tpu.codec import inflate as jinf
from jdeflate_tpu_torch import trace
from jdeflate_tpu_torch.codec import inflate as tinf
from jdeflate_tpu_torch.stream import zstrm
from jdeflate_tpu_torch.utils import errors

# name: compressobj's (level, wbits, memLevel, strategy) and whether the
# stream has a preset dictionary
CASES = {
    "level1": (1, 15, 8, zlib.Z_DEFAULT_STRATEGY, False),
    "level6": (6, 15, 8, zlib.Z_DEFAULT_STRATEGY, False),
    "level9": (9, 15, 8, zlib.Z_DEFAULT_STRATEGY, False),
    "filtered": (6, 15, 8, zlib.Z_FILTERED, False),
    "huffman_only": (6, 15, 8, zlib.Z_HUFFMAN_ONLY, False),
    "rle": (6, 15, 8, zlib.Z_RLE, False),
    "fixed": (6, 15, 8, zlib.Z_FIXED, False),
    "memlevel1": (6, 15, 1, zlib.Z_DEFAULT_STRATEGY, False),
    "memlevel9": (6, 15, 9, zlib.Z_DEFAULT_STRATEGY, False),
    "wbits9": (6, 9, 8, zlib.Z_DEFAULT_STRATEGY, False),
    "zdict": (6, 15, 8, zlib.Z_DEFAULT_STRATEGY, True),
}
# (kind, KiB) parts of each payload: 176 KiB of text with random stretches
PARTS = (("text", 40), ("random", 12), ("text", 56), ("random", 20),
         ("text", 48))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's default thread pool only spins against the other test
    workers' JAX compiles."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.cache
def _stream(name: str) -> tuple:
    """(payload, zlib stream, preset dictionary or b"") of one case."""
    level, wbits, mem, strategy, fdict = CASES[name]
    rng = np.random.default_rng(2600 + list(CASES).index(name))
    data = b"".join(make_corpus(rng, kind, n << 10) for kind, n in PARTS)
    zdict = b""
    kw = {}
    if fdict:
        zdict = make_corpus(rng, "text", 16 << 10)
        data = zdict[4096:12288] + data
        kw["zdict"] = zdict
    co = zlib.compressobj(level, zlib.DEFLATED, wbits, mem, strategy, **kw)
    return data, co.compress(data) + co.flush(), zdict


def _stats(stats) -> list:
    return [(k, int(p), int(e)) for k, p, e in stats]


def _same_index(a: dict, b: dict) -> bool:
    if set(a) != set(b) or len(a["win"]) != len(b["win"]):
        return False
    if any(a[k] != b[k] for k in a if k != "win"):
        return False
    return all((x is None and y is None) or (
        x is not None and y is not None and np.array_equal(x, y))
        for x, y in zip(a["win"], b["win"]))


@pytest.mark.parametrize("name", list(CASES))
def test_foreign_zlib_stream_decodes_as_jax(name):
    data, stream, zdict = _stream(name)
    hl = 6 if zdict else 2
    body = stream[hl:-4]
    index = tinf.RawInflater(device="cpu").build_index(body, zdict)
    rec = trace.last_request()
    assert rec["op"] == "RawInflater.build_index"
    assert "decode.index" in rec["spans"]
    assert rec["counters"]["decode.index_entries"] \
        == len(index["block_bits"]) > 1
    assert _same_index(index, jinf.RawInflater().build_index(body, zdict))

    tinf.STATS_LOG.clear()
    out = zstrm.decompress(stream, format="zlib", index=index,
                           dictionary=zdict or None, device="cpu")
    rec = trace.last_request()
    stats = _stats(tinf.STATS_LOG)
    assert out == data
    assert rec["op"] == "zstrm.decompress"
    assert "adler32" in rec["spans"]
    assert rec["counters"]["adler32.bytes"] == len(data) + len(zdict)
    card, stored = tinf.card_bytes(stats)
    assert rec["counters"]["decode.card_bytes"] == card
    # the counts are of the plan; the stats stop at the first batch that errs
    kinds = [k for k, _, _ in stats]
    assert rec["counters"]["decode.win_batches"] >= kinds.count("win") >= 1
    assert rec["counters"]["decode.stored_items"] >= kinds.count("stored")
    if not any(e for _, _, e in stats):
        assert rec["counters"]["decode.win_batches"] == kinds.count("win")
        assert card + stored == len(data)
    jd = jinf.RawInflater()
    assert jd.decompress(stream[hl:], index=index, dictionary=zdict) == data
    assert stats == _stats(jd.last_stats)


def test_flipped_adler32_trailer_raises():
    data, stream, _ = _stream("level6")
    index = tinf.RawInflater(device="cpu").build_index(stream[2:-4])
    bad = stream[:-1] + bytes([stream[-1] ^ 0x01])
    with pytest.raises(errors.ChecksumError):
        zstrm.decompress(bad, format="zlib", index=index, device="cpu")
    assert zstrm.decompress(stream, format="zlib", index=index,
                            device="cpu") == data


def test_wrong_preset_dictionary_raises():
    data, stream, zdict = _stream("zdict")
    index = tinf.RawInflater(device="cpu").build_index(stream[6:-4], zdict)
    with pytest.raises(errors.BadDictError):
        zstrm.decompress(stream, format="zlib", index=index,
                         dictionary=zdict[::-1], device="cpu")
    with pytest.raises(errors.MissingDictError):
        zstrm.decompress(stream, format="zlib", index=index, device="cpu")
