"""Parity of the port's decoder (jdeflate_tpu_torch/codec/inflate.py
RawInflater: the batch plan and the windowed decode it drives) with the JAX
package on the CPU, at the batch limits the decoder runs outside the
tests: RawInflater()'s defaults, which zstrm.decompress takes for every
decode; chip_smoke.py's BATCH; and one block per batch.

- Each stream is decoded by both packages with one index and one set of
  limits: the port's own members at levels 1, 6 and 9 with the encoder's
  index, and a Python zlib level-6 stream with build_index's. The
  level-9 member holds more index entries than a default batch takes
  (64); in the other streams stored blocks part two runs of Huffman
  blocks. So wherever the limits allow, at least two windowed batches
  run, each after the first behind the window its predecessors left, and
  none errs.
- The full-size case of ROADMAP C5: 4 MiB of bench.py's 8 MiB corpus as
  a zlib level-6 stream at chip_smoke.py's BATCH, whose third windowed
  batch clamps its word segment and errs in both packages, so the native
  decoder takes over from there.

Corpora from tests/conftest.py::make_corpus with seeded generators and
from bench.py::make_corpus. Tolerance: exact equality of bytes and of
every batch's (kind, produced, err).
"""
import functools
import zlib

import numpy as np
import pytest
import torch

import bench as jbench
from conftest import make_corpus
from jdeflate_tpu.codec import inflate as jinf
from jdeflate_tpu.codec import levels as jlevels
from jdeflate_tpu_torch.codec import inflate as tinf
from jdeflate_tpu_torch.codec import levels as tlevels
from jdeflate_tpu_torch.codec.deflate import RawDeflater

# the encoder runs the CPU tests' probe depths (tests/conftest.py, C4)
tlevels._PROBE_CAP.update(jlevels._PROBE_CAP)

LIMITS = {
    "defaults": {},
    "smoke": dict(max_batch_bits=1 << 25, max_batch_blocks=256,
                  max_batch_out=1 << 23),
    "one_block": dict(max_batch_blocks=1),
}
# (level, encode batch, corpus kinds striped in turn, stripe bytes, parts).
# A stripe of one kind (8 KiB, one split chunk, at levels 1 and 6; 4 KiB,
# two chunks, at level 9) gets an index entry of its own: 8 or 16 to a
# 64 KiB block. A part is that many bytes of stripes or, as None, a 64 KiB
# block of random bytes, which the encoder stores. Each member is one
# encode batch, so no sync seam splits it.
MEMBERS = {
    "deflate1": (1, 4, ("text", "binary"), 8 << 10,
                 (64 << 10, None, 16 << 10)),
    "deflate6": (6, 4, ("text", "binary"), 8 << 10,
                 (64 << 10, None, 16 << 10)),
    "deflate9": (9, 5, ("text", "random"), 4 << 10, (264 << 10,)),
}
# (kind, KiB) parts. zlib ends a Huffman block every 16383 symbols and
# stores two blocks of the 40 KiB of random bytes, so the index is
# Huffman, stored x2, Huffman x2, and the Huffman blocks are alike in size
ZLIB6 = (("text", 24), ("random", 8), ("text", 24), ("random", 40),
         ("text", 24), ("random", 8), ("text", 24), ("random", 8),
         ("text", 24))
STREAMS = (*MEMBERS, "zlib6")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's default thread pool only spins against the other test
    workers' JAX compiles."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _zlib_raw(data: bytes) -> bytes:
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    return co.compress(data) + co.flush()


@functools.cache
def _stream(name: str) -> tuple:
    """(data, raw stream, index) of one stream, built once."""
    rng = np.random.default_rng(2200 + STREAMS.index(name))
    if name == "zlib6":
        data = b"".join(make_corpus(rng, k, n << 10) for k, n in ZLIB6)
        raw = _zlib_raw(data)
        return data, raw, tinf.RawInflater(device="cpu").build_index(raw)
    level, batch, kinds, stripe, parts = MEMBERS[name]
    data = b"".join(
        make_corpus(rng, "random", 64 << 10) if n is None else
        b"".join(make_corpus(rng, kinds[i % len(kinds)], stripe)
                 for i in range(n // stripe))
        for n in parts)
    enc = RawDeflater(level=level, batch=batch, device="cpu")
    return (data, *enc.compress(data))


def _stats(dec) -> list:
    return [(k, int(p), int(e)) for k, p, e in dec.last_stats]


@pytest.mark.parametrize("stream,limits", [
    pytest.param(s, lim, id=f"{s}-{lim}") for s in STREAMS for lim in LIMITS])
def test_batch_plan_matches_jax(stream, limits):
    data, raw, index = _stream(stream)
    if stream == "deflate9":
        assert len(index["block_bits"]) > 64
    jd = jinf.RawInflater(**LIMITS[limits])
    td = tinf.RawInflater(device="cpu", **LIMITS[limits])
    jout = jd.decompress(raw, index=index)
    tout = td.decompress(raw, index=index)
    assert tout == jout == data
    stats = _stats(td)
    assert stats == _stats(jd)
    # every windowed batch's bytes are the ones kept: none errs
    win = [e for k, _, e in stats if k == "win"]
    assert win and not any(win)
    # chip_smoke.py's limits hold the whole level-9 member in one batch
    if (stream, limits) != ("deflate9", "smoke"):
        assert len(win) >= 2


def test_foreign_row_at_full_size_errs_where_jax_does():
    """4 MiB of the 8 MiB corpus as a zlib level-6 stream at chip_smoke.py's
    limits: the third windowed batch's last pseudo-entry clamps its word
    segment (ROADMAP C5), so it errs and the native decoder takes over, in
    both packages."""
    data = jbench.make_corpus(8 << 20)[:4 << 20]
    raw = _zlib_raw(data)
    td = tinf.RawInflater(device="cpu", **LIMITS["smoke"])
    tout = td.decompress(raw, index=td.build_index(raw))
    jd = jinf.RawInflater(**LIMITS["smoke"])
    jd.decompress(raw, index=jd.build_index(raw))
    assert tout == data
    stats = _stats(td)
    assert stats == _stats(jd)
    win = [e for k, _, e in stats if k == "win"]
    assert len(win) == 3 and win[2] > 0 and not any(win[:2])
    card, _ = tinf.card_bytes(stats)
    assert 0 < card < len(data)
