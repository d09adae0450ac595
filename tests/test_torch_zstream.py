"""Parity of the port's incremental ZStream (jdeflate_tpu_torch.stream.zstrm)
with the JAX package's on the CPU: every case drives both streams with the
same calls, on the same bytes, in the same test, and compares what each call
returns (bytes, counters, checksums) or the class of the error it raises.
The cases are those of tests/test_zstrm.py's streaming tests; the native
partial inflator and the pure-Python one are held to the JAX package's on a
stream cut at many byte offsets. Tolerance: exact equality."""
import functools
import gzip
import zlib

import pytest
import torch

import jdeflate_tpu as jd
from jdeflate_tpu.codec import levels as jlevels
from jdeflate_tpu.stream import native as jnative
from jdeflate_tpu.stream import zstrm as jz
import jdeflate_tpu_torch as jdt
from jdeflate_tpu_torch.codec import levels as tlevels
from jdeflate_tpu_torch.stream import native as tnative
from jdeflate_tpu_torch.stream import zstrm as tz

# both sides run the same (CPU-capped) probe depths, tests/conftest.py
tlevels._PROBE_CAP.update(jlevels._PROBE_CAP)

# one segment shape for the file, so the JAX encoder compiles once
KW = dict(block_size=4096, batch=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small; torch's default thread pool only spins
    against the other test workers' JAX compiles."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PORT = functools.partial(jdt.ZStream, device="cpu")
JAX = jd.ZStream


def _outcome(fn, *args):
    """What one call gives: ("ok", result) or ("err", error class name)."""
    try:
        return ("ok", fn(*args))
    except Exception as e:          # the two packages' error classes
        return ("err", type(e).__name__)


def _drive(script, **kw):
    """Run script(make_stream) on a port stream and a JAX stream made with
    the same arguments; each returns the list of what its calls gave."""
    got = script(lambda: PORT(**kw))
    want = script(lambda: JAX(**kw))
    assert got == want
    return got


def _gz(data, level=6):
    co = zlib.compressobj(level, zlib.DEFLATED, 31)
    return co.compress(data) + co.flush()


def _state(z):
    return (z.total_in, z.total_out, z.used_input, z.unused_data, z.crc32,
            z.adler32)


# ---- deflate side ----

@pytest.mark.parametrize("fmt", ["gzip", "zlib", "raw"])
def test_streaming_writes(corpus, fmt):
    data = corpus("text", 40000)

    def script(make):
        z = make()
        res = []
        for i in range(0, len(data), 7000):
            z.write(data[i:i + 7000])
            res.append(z.read())
        res.append(z.flush(final=True))
        res.append(_state(z))
        return res

    res = _drive(script, mode="deflate", format=fmt, **KW)
    blob = b"".join(res[:-1])
    assert zlib.decompress(blob, {"gzip": 31, "zlib": 15, "raw": -15}[fmt]) \
        == data


def test_sync_flush_segments_and_segment_dictionary(corpus):
    """A sync-flush seam mid-segment; each later segment takes the last 32
    KiB of the previous segment only (here a short one) as its
    dictionary."""
    data = corpus("text", 30000)

    def script(make):
        z = make()
        z.write(data[:10000])
        res = [z.flush(final=False)]
        z.write(data[10000:10300])
        res.append(z.flush(final=False))
        z.write(data[10300:])
        res += [z.flush(final=True), _state(z)]
        return res

    res = _drive(script, mode="deflate", format="zlib", **KW)
    assert zlib.decompress(b"".join(res[:-1])) == data


def test_preset_dictionary_both_ways(corpus):
    zdict = corpus("text", 12000)
    data = zdict[3000:9000] + corpus("binary", 20000)

    def enc(make):
        z = make()
        z.write(data)
        return [z.flush(final=True), _state(z)]

    blob = _drive(enc, mode="deflate", format="zlib", dictionary=zdict,
                  **KW)[0]
    assert zlib.decompressobj(15, zdict=zdict).decompress(blob) == data

    def dec(make):
        z = make()
        return [_outcome(z.feed, blob), _outcome(z.finish), _state(z)]

    assert _drive(dec, mode="inflate", format="auto",
                  dictionary=zdict)[1] == ("ok", data)
    assert _drive(dec, mode="inflate", format="zlib")[0] == (
        "err", "MissingDictError")
    assert _drive(dec, mode="inflate", format="auto",
                  dictionary=zdict[1:])[0] == ("err", "BadDictError")


def test_misuse_and_poisoning():
    def script(make):
        z = make()
        res = [_outcome(z.flush, True), _outcome(z.write, b"more"),
               _outcome(z.write, b"again"), _outcome(z.feed, b"x")]
        z.reset()
        res += [_outcome(z.write, b"hello"), _outcome(z.flush, True)]
        return res

    res = _drive(script, mode="deflate", format="gzip", **KW)
    assert [r[1] for r in res[1:4]] == [
        "IncorrectUseError", "StreamPoisonedError", "StreamPoisonedError"]
    assert gzip.decompress(res[5][1]) == b"hello"

    def gzip_dict(make):
        z = make()
        return [_outcome(z.write, b"x"), _outcome(z.write, b"y")]

    assert _drive(gzip_dict, mode="deflate", format="gzip",
                  dictionary=b"abc") == [("err", "IncorrectUseError"),
                                         ("err", "StreamPoisonedError")]
    for kw in (dict(mode="both"), dict(mode="deflate", format="auto"),
               dict(mode="inflate", checksum="always")):
        with pytest.raises(jdt.errors.IncorrectUseError):
            PORT(**kw)
        with pytest.raises(jd.errors.IncorrectUseError):
            JAX(**kw)


@pytest.mark.parametrize("fmt", ["gzip", "zlib", "raw"])
def test_empty_stream(fmt):
    def enc(make):
        z = make()
        return [z.flush(final=True), z.flush(final=True), _state(z)]

    blob = _drive(enc, mode="deflate", format=fmt, **KW)[0]

    def dec(make):
        z = make()
        z.feed(blob)
        return [z.finish(), _state(z)]

    assert _drive(dec, mode="inflate", format=fmt)[0] == b""


@pytest.mark.parametrize("mode", ["force", "suppress"])
def test_checksum_modes_on_deflate(corpus, mode):
    data = corpus("text", 20000)

    def script(make):
        z = make()
        z.write(data)
        return [z.flush(final=True), _state(z)]

    res = _drive(script, mode="deflate", format="raw", checksum=mode, **KW)
    assert zlib.decompress(res[0], -15) == data
    crc, adler = res[1][-2:]
    assert (crc, adler) == ((zlib.crc32(data), zlib.adler32(data))
                            if mode == "force" else (0, 1))


def test_reset_reuse(corpus):
    a, b = corpus("text", 20000), corpus("binary", 15000)

    def script(make):
        z = make()
        z.write(a)
        res = [z.flush(final=True)]
        z.reset()
        z.write(b)
        res += [z.flush(final=True), _state(z)]
        return res

    res = _drive(script, mode="deflate", format="gzip", **KW)
    assert gzip.decompress(res[0]) == a and gzip.decompress(res[1]) == b


def test_io_callbacks(corpus):
    data = corpus("text", 30000)

    def enc(make):
        sink = []
        pulled = iter([data[i:i + 7000] for i in range(0, len(data), 7000)]
                      + [b""])
        z = make(source_fn=lambda n: next(pulled), target_fn=sink.append)
        return [z.run(), sink, _state(z)]

    got = enc(lambda **kw: PORT(mode="deflate", format="gzip", **KW, **kw))
    assert got == enc(lambda **kw: JAX(mode="deflate", format="gzip", **KW,
                                       **kw))
    blob = b"".join(got[1]) + got[0]
    assert gzip.decompress(blob) == data

    def dec(make):
        sink = []
        parts = iter([blob[i:i + 900] for i in range(0, len(blob), 900)]
                     + [b""])
        z = make(source_fn=lambda n: next(parts), target_fn=sink.append)
        return [z.run(), sink, _state(z)]

    got = dec(lambda **kw: PORT(mode="inflate", **kw))
    assert got == dec(lambda **kw: JAX(mode="inflate", **kw))
    assert b"".join(got[1]) + got[0] == data
    with pytest.raises(jdt.errors.IncorrectUseError):
        PORT(mode="inflate").run()


# ---- inflate side ----

def _output(res):
    """The bytes a _chunked script read, its finish() result included."""
    return b"".join(r for r in res[1:-2:2] if r) + (
        res[-2][1] if res[-2][0] == "ok" else b"")


def _chunked(blob, step):
    def script(make):
        z = make()
        res = []
        for i in range(0, len(blob), step):
            res.append(_outcome(z.feed, blob[i:i + step]))
            res.append(z.read() if res[-1][0] == "ok" else None)
        res.append(_outcome(z.finish))
        res.append(_state(z))
        return res
    return script


def test_feed_finish_and_misuse(corpus):
    data = corpus("text", 20000)
    blob = tz.compress(data, format="gzip", device="cpu", **KW)
    res = _drive(_chunked(blob, 1000), mode="inflate", format="auto")
    assert _output(res) == data

    def misuse(make):
        z = make()
        return [_outcome(z.write, b"x"), _outcome(z.flush),
                _outcome(z.feed, b"x")]

    assert _drive(misuse, mode="inflate") == [
        ("err", "IncorrectUseError")] + [("err", "StreamPoisonedError")] * 2


def test_bad_data_poisons():
    res = _drive(_chunked(b"\x1f\x8b\x08\x00garbagegarbage", 100),
                 mode="inflate", format="auto")
    assert any(r and r[0] == "err" for r in res[:-1])

    def after(make):
        z = make()
        return [_outcome(z.feed, b"\x1f\x8b\x08\x00garbagegarbage"),
                _outcome(z.finish), _outcome(z.feed, b"more")]

    assert _drive(after, mode="inflate")[-1] == ("err",
                                                  "StreamPoisonedError")


def test_incremental_members_then_trailing(corpus):
    parts = [corpus("text", 15000), corpus("runs", 9000),
             corpus("text", 5000)]
    blob = b"".join(tz.compress(p, format="gzip", device="cpu", **KW)
                    for p in parts) + b"TRAILING"
    for step in (700, 4096):
        res = _drive(_chunked(blob, step), mode="inflate", format="gzip")
        state = res[-1]
        assert state[2] == len(blob) - 8 and state[3] == b"TRAILING"
        assert _output(res) == b"".join(parts)


@pytest.mark.parametrize("fmt", ["gzip", "zlib"])
def test_trailing_data_and_used_input(corpus, fmt):
    data = corpus("binary", 6000)
    blob = tz.compress(data, format=fmt, device="cpu", **KW)
    for extra in (b"", b"X", b"XYZ", b"NOT GZIP DATA"):
        res = _drive(_chunked(blob + extra, len(blob) + len(extra)),
                     mode="inflate", format=fmt)
        assert _output(res) == data
        if fmt == "gzip" and len(extra) == 1:
            # ROADMAP C12: one trailing byte after a gzip member is taken
            # for the head of another member at finish, in both packages
            assert res[-2] == ("err", "FormatError")
        else:
            assert res[-1][2:4] == (len(blob), extra)


def test_truncation_at_every_stage(corpus):
    """Cut inside the header, the body and the trailer: the same output so
    far and the same error at finish."""
    data = corpus("text", 20000)
    blob = tz.compress(data, format="gzip", device="cpu", **KW)
    for cut in (0, 5, 11, 200, len(blob) // 2, len(blob) - 9,
                len(blob) - 4, len(blob) - 1):
        res = _drive(_chunked(blob[:cut], 512), mode="inflate",
                     format="gzip")
        assert res[-2][0] == "err" or cut == 0


def test_checksum_suppress_and_force_on_inflate(corpus):
    data = corpus("text", 5000)
    blob = bytearray(tz.compress(data, format="gzip", device="cpu", **KW))
    blob[-6] ^= 0xFF             # corrupt the stored CRC, not the payload
    blob = bytes(blob)
    assert _output(_drive(_chunked(blob, len(blob)), mode="inflate",
                          checksum="suppress")) == data
    assert _drive(_chunked(blob, len(blob)), mode="inflate")[0] == (
        "err", "ChecksumError")
    good = tz.compress(data, format="gzip", device="cpu", **KW)
    res = _drive(_chunked(good, 1000), mode="inflate", checksum="force")
    assert res[-1][-2:] == (zlib.crc32(data), zlib.adler32(data))


@pytest.mark.parametrize("fmt", ["gzip", "zlib"])
def test_chunked_single_member_bounded(corpus, fmt):
    data = corpus("text", 400_000) + corpus("binary", 200_000)
    blob = (_gz(data, 1) if fmt == "gzip" else zlib.compress(data, 6))
    step = 16384
    peaks = []

    def script(make):
        z = make()
        peak = 0
        out = []
        for i in range(0, len(blob), step):
            z.feed(blob[i:i + step])
            peak = max(peak, len(z._buf))
            out.append(z.read())
        out.append(z.finish())
        peaks.append(peak)
        return [out, _state(z)]

    res = _drive(script, mode="inflate", format="auto")
    assert b"".join(res[0]) == data and res[1][2] == len(blob)
    assert peaks[0] == peaks[1] < 2 * step


# ---- the partial inflators ----

@pytest.fixture(scope="module")
def cut_stream():
    """A raw stream of several dynamic, fixed and stored blocks."""
    import numpy as np
    rng = np.random.default_rng(5)
    words = [b"alpha ", b"beta ", b"gamma ", b"delta\n"]
    text = b"".join(words[i] for i in rng.integers(0, 4, 6000))
    data = text[:20000] + rng.integers(0, 256, 3000, dtype=np.uint8) \
        .tobytes() + text[:5000]
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    raw = co.compress(data[:12000]) + co.flush(zlib.Z_FULL_FLUSH)
    raw += co.compress(data[12000:]) + co.flush()
    return raw, data


CUTS = (0, 1, 7, 100, 1000, 2500, 5000, 7000, 9000, -30, -1, None)


@pytest.mark.parametrize("resume", [False, True])
def test_inflate_partial_matches_jax(cut_stream, resume):
    """Both partial inflators on the stream cut at many offsets, from its
    start or resumed where a decode of its first half stopped (with that
    output's last 32 KiB as the window): the same output, end bit and
    completeness as the JAX package's, or the same error."""
    raw, data = cut_stream
    start_bit, window = 0, b""
    if resume:
        head, start_bit, _ = jnative.inflate_partial(raw[:len(raw) // 2])
        window = head[-32768:]
        assert start_bit > 0
    for cut in CUTS:
        buf = raw[:cut]
        got = _outcome(tnative.inflate_partial, buf, window, start_bit)
        assert got == _outcome(jnative.inflate_partial, buf, window,
                               start_bit), cut
        got_py = _outcome(tz._partial_inflate_py, buf, window, start_bit)
        assert got_py == _outcome(jz._partial_inflate_py, buf, window,
                                  start_bit), cut
    out, end, complete = tnative.inflate_partial(raw)
    assert out == data and complete and (end + 7) // 8 == len(raw)
    assert tz._partial_inflate_py(raw, b"", 0) == (out, end, complete)
