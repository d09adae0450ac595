"""The crc32 kernel (jdeflate_tpu_torch/csrc/crc32.cu, ops/checksum.py
crc32_kernel) and crc32's route to it.

- On the CPU: bytes with device="cpu" and a CPU tensor take the plain
  program (_crc32_program), launch nothing and count no crc32.kernel;
  the launcher refuses a CPU tensor.
  A line-by-line transcript of the kernel's arithmetic in Python, fed
  tables built as the kernel's are (_kernel_tables), equals zlib at
  reduced block shapes (so that a few thousand bytes span many blocks and
  the last block's fold takes several states a thread) and at the
  kernel's own shape and tables: the logical layout (lead bytes masked,
  virtual front zeros, the tail), each thread's weight, the fold and
  init.
- On a card (marker cuda): the kernel equals zlib.crc32 and the plain
  program on the card at every size from 0 to 300 bytes, at each padding
  bucket's edge +-1 up to 2 MiB + 1, at 51,220,480 B and 64 MiB, on views
  starting at byte offsets 1, 2, 3 and 17, on strided (non-contiguous)
  views, with init chained over pieces
  that straddle thread-segment, span and fold-group edges, and on empty
  input (init back, no launch); every non-empty call is one launch, and
  each record of a round trip counts one crc32.kernel.
  zstrm.decompress still raises on a member whose CRC-32 trailer differs
  in one bit.

Exact equality everywhere. The card tests import no JAX.
"""
import zlib

import numpy as np
import pytest
import torch

from jdeflate_tpu_torch import trace
from jdeflate_tpu_torch.ops import checksum as cs
from jdeflate_tpu_torch.stream import zstrm
from jdeflate_tpu_torch.utils import errors

M32 = 0xFFFFFFFF
THREADS, SEG = 256, 64           # csrc/crc32.cu kThreads, kSeg


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's default thread pool only spins against the other test
    workers' JAX compiles."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bytes(seed: int, n: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n, np.uint8).tobytes()


# ---- on the CPU ----------------------------------------------------------

@pytest.mark.parametrize("kind", ["bytes", "tensor"])
def test_cpu_inputs_take_the_plain_program(kind, monkeypatch):
    data = _bytes(3, 70001)
    arg = (data if kind == "bytes"
           else torch.frombuffer(bytearray(data), dtype=torch.uint8))
    seen = []
    plain = cs._crc32_program

    def spy(*a):
        seen.append(a[0].numel())
        return plain(*a)
    monkeypatch.setattr(cs, "_crc32_program", spy)
    before = cs.crc32_kernel.launches
    with trace.request("test.crc32"):
        got = (cs.crc32(arg, 5, device="cpu") if kind == "bytes"
               else cs.crc32(arg, 5))
    rec = trace.last_request()
    assert got == zlib.crc32(data, 5)
    assert seen == [cs._pad_bucket(len(data), cs._CRC_CHUNK)]
    assert cs.crc32_kernel.launches == before
    assert "crc32.kernel" not in rec["counters"]
    assert rec["counters"]["d2h.calls"] == 1


@pytest.mark.parametrize("n", [0, 100])
def test_kernel_launcher_refuses_cpu_tensors(n):
    with pytest.raises(ValueError):
        cs.crc32_kernel(torch.zeros(n, dtype=torch.uint8))


def _apply(m, v: int) -> int:
    acc = 0
    for j in range(32):
        if (v >> j) & 1:
            acc ^= int(m[j])
    return acc


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gf2_matmul_equals_the_loop(seed):
    """_gf2_matmul (vectorised) against column-by-column application."""
    rng = np.random.default_rng(seed)
    a, b = rng.integers(0, 1 << 32, (2, 32), dtype=np.uint64).astype(np.uint32)
    want = [_apply(a, int(col)) for col in b]
    assert cs._gf2_matmul(a, b).tolist() == want


def _kernel_model(mem: bytes, lead: int, n: int, init: int, threads: int,
                  seg: int) -> int:
    """csrc/crc32.cu's arithmetic in Python over the bytes at base = mem
    (the data mem[lead:lead + n]), with blocks of `threads` threads of
    `seg` bytes, reading its tables from _kernel_tables(threads, log2 seg)
    at the kernel's offsets."""
    tabs = cs._kernel_tables(threads, seg.bit_length() - 1).view(np.uint32)
    t = tabs[:8 * 256].reshape(8, 256).astype(np.int64)
    pow2 = tabs[8 * 256:].reshape(-1, 32)
    wseg = tabs[8 * 256 + 64 * 32:].reshape(2, 32, threads)[0]
    wspan = tabs[8 * 256 + 64 * 32:].reshape(2, 32, threads)[1]

    def advance(v, ln):
        while ln and v:
            v = _apply(pow2[(ln & -ln).bit_length() - 1], v)
            ln &= ln - 1
        return v

    def slice8(c, lo, hi):
        c ^= lo
        return int(t[7, c & 255] ^ t[6, (c >> 8) & 255]
                   ^ t[5, (c >> 16) & 255] ^ t[4, c >> 24]
                   ^ t[3, hi & 255] ^ t[2, (hi >> 8) & 255]
                   ^ t[1, (hi >> 16) & 255] ^ t[0, hi >> 24])

    span = threads * seg
    body = (lead + n) & ~15
    tail = (lead + n) & 15
    spans = max(1, -(-body // span))
    front = spans * span - body
    words = np.frombuffer(mem[:body], "<u4").reshape(-1, 4)
    states = []
    for b in range(spans):
        xs = 0
        for tid in range(threads):
            w0 = (b * span + tid * seg - front) >> 4
            c = 0
            for w in range(w0, w0 + seg // 16):
                v = [0] * 4 if w < 0 else [int(x) for x in words[w]]
                if w == 0:
                    for k in range(4):
                        f = lead - 4 * k
                        v[k] = (v[k] if f <= 0 else 0 if f >= 4
                                else v[k] & (M32 << (8 * f)) & M32)
                c = slice8(slice8(c, v[0], v[1]), v[2], v[3])
            xs ^= _apply(wseg[:, tid], c)
        states.append(xs)
    g = -(-spans // threads)
    pad = g * threads - spans
    step = pow2[(threads * span).bit_length() - 1]
    raw = 0
    for tid in range(threads):
        acc = 0
        for i in range(g):
            j = i * threads + tid - pad
            if acc:
                acc = _apply(step, acc)
            if j >= 0:
                acc ^= states[j]
        raw ^= _apply(wspan[:, tid], acc)
    for k in range(tail):
        byte = 0 if body + k < lead else mem[body + k]
        raw = int(t[0, (raw ^ byte) & 255]) ^ (raw >> 8)
    return ~(raw ^ advance(~init & M32, n)) & M32


@pytest.mark.parametrize("threads,seg", [(4, 32), (8, 16), (2, 64)])
def test_kernel_arithmetic_equals_zlib_at_reduced_shapes(threads, seg):
    rng = np.random.default_rng(threads * 100 + seg)
    for _ in range(60):
        n = int(rng.integers(1, 40 if rng.random() < 0.4 else 2000))
        lead = int(rng.integers(0, 16))
        init = int(rng.choice([0, M32, int(rng.integers(0, 1 << 32))]))
        mem = _bytes(int(rng.integers(1 << 30)), lead + n + 16)
        assert _kernel_model(mem, lead, n, init, threads, seg) == \
            zlib.crc32(mem[lead:lead + n], init), (n, lead, init)


@pytest.mark.parametrize("n,lead", [(5, 9), (100, 0), (16384, 0),
                                    (16399, 15), (70001, 3)])
def test_kernel_arithmetic_equals_zlib_at_the_kernels_shape(n, lead):
    mem = _bytes(n, lead + n + 16)
    assert cs._SPAN == THREADS * SEG
    assert _kernel_model(mem, lead, n, 77, THREADS, SEG) == \
        zlib.crc32(mem[lead:lead + n], 77)


# ---- on the card ---------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _plain_on_card(data, init: int) -> int:
    """The plain program chain on the card (crc32's route before the
    kernel)."""
    return cs._checksum(cs._crc32_program, data, init, cs._CRC_CHUNK, True,
                        "cuda")


def _one_launch(fn):
    """fn()'s value, after holding that it made exactly one launch."""
    before = cs.crc32_kernel.launches
    got = fn()
    assert cs.crc32_kernel.launches == before + 1
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("lo,hi", [(1, 101), (101, 201), (201, 301)])
def test_card_small_sizes(lo, hi):
    _need_card()
    data = _bytes(7, hi)
    dev = torch.frombuffer(bytearray(data), dtype=torch.uint8).cuda()
    for n in range(lo, hi):
        want = zlib.crc32(data[:n], 9)
        assert _one_launch(lambda: cs.crc32(data[:n], 9)) == want, n
        assert _one_launch(lambda: cs.crc32(dev[:n], 9)) == want, n
        assert _plain_on_card(data[:n], 9) == want, n


@pytest.mark.cuda
def test_card_empty_input_returns_init():
    _need_card()
    before = cs.crc32_kernel.launches
    dev = torch.empty(0, dtype=torch.uint8, device="cuda")
    for init in (0, 1, 0xDEADBEEF, M32):
        assert cs.crc32(b"", init) == init
        assert cs.crc32(dev, init) == init
    assert cs.crc32_kernel.launches == before


def _bucket_edges(top: int = 2 << 20) -> list:
    b, out = cs._CRC_CHUNK, []
    while b <= top:
        out += [b - 1, b, b + 1]
        b = b * 2 if b < (1 << 20) else b + (1 << 20)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("source", ["bytes", "tensor"])
def test_card_bucket_edges(source):
    _need_card()
    data = _bytes(11, (2 << 20) + 1)
    dev = torch.frombuffer(bytearray(data), dtype=torch.uint8).cuda()
    for n in _bucket_edges():
        arg = data[:n] if source == "bytes" else dev[:n]
        want = zlib.crc32(data[:n])
        assert _one_launch(lambda: cs.crc32(arg)) == want, n
        assert _plain_on_card(arg, 0) == want, n


@pytest.mark.cuda
@pytest.mark.parametrize("n", [51_220_480, 64 << 20])
def test_card_large(n):
    _need_card()
    data = _bytes(n, n)
    want = zlib.crc32(data)
    assert _one_launch(lambda: cs.crc32(data)) == want
    dev = torch.frombuffer(bytearray(data), dtype=torch.uint8).cuda()
    assert _one_launch(lambda: cs.crc32(dev)) == want
    assert _plain_on_card(dev, 0) == want


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 3, 17])
def test_card_views_at_byte_offsets(offset):
    _need_card()
    data = _bytes(offset, (1 << 20) + 64)
    dev = torch.frombuffer(bytearray(data), dtype=torch.uint8).cuda()
    span = cs._SPAN
    for n in (1, 2, 13, 15, 16, 17, 31, 4096, span - 1, span, span + 1,
              (1 << 20) + 5):
        view = dev[offset:offset + n]
        assert view.data_ptr() % 16 != 0 or offset % 16 == 0
        want = zlib.crc32(data[offset:offset + n], 3)
        assert _one_launch(lambda: cs.crc32(view, 3)) == want, n
        assert _plain_on_card(view, 3) == want, n


@pytest.mark.cuda
@pytest.mark.parametrize("step,offset", [(2, 0), (3, 1), (7, 5)])
def test_card_strided_views(step, offset):
    """A non-contiguous view (x[offset::step], and a column of a 2-D
    tensor) is copied once, then read by one launch."""
    _need_card()
    data = _bytes(31 + step, (1 << 20) + 3 * cs._SPAN + 11)
    dev = torch.frombuffer(bytearray(data), dtype=torch.uint8).cuda()
    view = dev[offset::step]
    assert not view.is_contiguous()
    want = zlib.crc32(data[offset::step], 5)
    assert _one_launch(lambda: cs.crc32(view, 5)) == want
    grid = dev[:step * 4099].view(4099, step)[:, offset % step]
    assert not grid.is_contiguous()
    want = zlib.crc32(data[offset % step:step * 4099:step])
    assert _one_launch(lambda: cs.crc32(grid)) == want


@pytest.mark.cuda
@pytest.mark.parametrize("source", ["bytes", "tensor"])
def test_card_init_chained_over_edges(source):
    """Pieces that end and start inside a thread's segment, at and around
    a span's edge, across more spans than a block has threads (the fold
    then takes groups of several states)."""
    _need_card()
    span = cs._SPAN
    pieces = [1, 15, 16, 17, 63, 65, span - 1, span, span + 1, 3 * span + 5,
              257 * span + 1, 3]
    data = _bytes(19, sum(pieces))
    dev = torch.frombuffer(bytearray(data), dtype=torch.uint8).cuda()
    run, pos = 0, 0
    for n in pieces:
        arg = data[pos:pos + n] if source == "bytes" else dev[pos:pos + n]
        run = _one_launch(lambda: cs.crc32(arg, run))
        pos += n
        assert run == zlib.crc32(data[:pos]), pos


@pytest.mark.cuda
def test_card_round_trip_records_count_the_kernel():
    """A round trip's two records (compress_with_index, decompress) each
    show one launch of the crc32 kernel."""
    _need_card()
    data = _bytes(29, 1 << 20)
    stream, index, hl = zstrm.compress_with_index(data, level=1)
    enc = trace.last_request()["counters"]
    assert zstrm.decompress(stream, index=index, header_len=hl) == data
    dec = trace.last_request()["counters"]
    assert (enc["crc32.kernel"], dec["crc32.kernel"]) == (1, 1)


@pytest.mark.cuda
def test_card_decompress_rejects_one_flipped_trailer_bit():
    _need_card()
    data = _bytes(23, 300000)
    stream, index, hl = zstrm.compress_with_index(data, level=1)
    assert zstrm.decompress(stream, index=index, header_len=hl) == data
    bad = bytearray(stream)
    bad[-8] ^= 0x10                      # one bit of the CRC-32 field
    before = cs.crc32_kernel.launches
    with pytest.raises(errors.ChecksumError):
        zstrm.decompress(bytes(bad), index=index, header_len=hl)
    assert cs.crc32_kernel.launches == before + 1
    with pytest.raises(errors.ChecksumError):
        zstrm.decompress(bytes(bad))
