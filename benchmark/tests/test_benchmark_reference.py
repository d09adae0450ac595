"""The plain reference: gzip framing, the one-block decoder, the index
check, each against Python's zlib or against broken inputs."""
import gzip
import zlib

import numpy as np
import pytest
import torch

from benchmark import corpus, reference as R


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gzip(data: bytes, level: int = 6) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, 31)
    return co.compress(data) + co.flush()


DATA = corpus.make_payload(120_000, 5, 0)


def test_sound_member():
    got = R.check_stream(_gzip(DATA), DATA)
    assert got["rejected"] == 0 and got["differing"] == 0


def test_header_fields():
    s = gzip.compress(DATA, mtime=0)
    assert R.gzip_header_len(s) == 10
    named = bytes([0x1F, 0x8B, 8, 8 | 4]) + bytes(6) + b"\x02\x00ab" \
        + b"name\0"
    assert R.gzip_header_len(named) == len(named)
    with pytest.raises(R.StreamError):
        R.gzip_header_len(b"\x1f\x8c" + bytes(8))


@pytest.mark.parametrize("where", ["body", "crc", "isize", "tail"])
def test_broken_members_are_rejected(where):
    s = bytearray(_gzip(DATA))
    if where == "body":
        s[len(s) // 2] ^= 0x20
    elif where == "crc":
        s[-6] ^= 1
    elif where == "isize":
        s[-2] ^= 1
    else:
        s += b"\0"
    got = R.check_stream(bytes(s), DATA)
    assert got["rejected"] == 1


def test_wrong_payload_differs():
    other = DATA[:-1] + bytes([DATA[-1] ^ 1])
    got = R.check_stream(_gzip(DATA), other)
    assert got["rejected"] == 1 and got["differing"] == 1
    assert R.bytes_differing(b"abc", b"abd") == 1
    assert R.bytes_differing(b"abc", b"ab") == 1


@pytest.mark.parametrize("level", [0, 1, 6, 9])
def test_block_decoder_against_zlib(level):
    co = zlib.compressobj(level, zlib.DEFLATED, -15, 9, zlib.Z_DEFAULT_STRATEGY)
    raw = co.compress(DATA) + co.flush()
    out, pos = b"", 0
    while True:
        piece, pos, final = R.inflate_block(raw, pos, out)
        out += piece
        if final:
            break
    assert out == DATA and pos <= 8 * len(raw)


def test_fixed_codes_block():
    co = zlib.compressobj(6, zlib.DEFLATED, -15, 9, zlib.Z_FIXED)
    raw = co.compress(DATA[:5000]) + co.flush()
    out, _, final = R.inflate_block(raw, 0, b"")
    assert final and out == DATA[:5000]


def _port_member(data):
    from jdeflate_tpu_torch.stream import zstrm
    return zstrm.compress_with_index(data, format="gzip", level=6,
                                     block_size=16384, batch=4, device="cpu")


def test_port_index_checks_clean():
    s, idx, hl = _port_member(DATA)
    raw = R.check_stream(s, DATA)["raw"]
    faults, _ = R.check_index(raw, idx, DATA, np.random.default_rng(0), 50)
    assert faults == []


@pytest.mark.parametrize("field", ["bits", "seam_out", "n", "win"])
def test_broken_index_is_caught(field):
    s, idx, hl = _port_member(DATA)
    raw = R.check_stream(s, DATA)["raw"]
    bad = {k: (list(v) if isinstance(v, list) else v) for k, v in idx.items()}
    if field == "bits":
        bad["block_bits"][3] += 1
    elif field == "seam_out":
        k = bad["block_bits"].index(8 * bad["sync_points"][0])
        bad["block_bytes"][k] += 1
    elif field == "n":
        bad["n"] += 1
    else:
        bad["win"].pop()
    faults, _ = R.check_index(raw, bad, DATA, np.random.default_rng(0), 50)
    assert faults
