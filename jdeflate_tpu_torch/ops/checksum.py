"""adler32 / crc32 as parallel reductions on the tensor's device, plus the
GF(2) combine.

Same algebra as jdeflate_tpu/ops/checksum.py, which computes these in XLA
(no Pallas kernel):
  - adler32: per-chunk weighted and unweighted byte sums, folded mod 65521.
  - crc32 (reflected poly 0xEDB88320): each chunk's raw CRC is GF(2)-linear
    in the chunk's bits, so it is the XOR of per-bit constants selected by
    the data; chunk states then merge in log depth with GF(2) shift matrices
    (raw(A||B) = M_len(B) raw(A) ^ raw(B)).
  - crc32_combine / adler32_combine: host-side scalars.

On a card crc32 is one hand-written kernel, csrc/crc32.cu (crc32_kernel):
the same algebra over 16 KiB spans, slice-by-8 within a thread's segment.
Everything else is plain PyTorch: adler32 everywhere and crc32 on the CPU
run as a captured program per padded size (codec/program.py; the CPU
never captures); a size above 1 MiB runs the 1 MiB program piece by
piece, chaining the running value through its init argument, so one
program serves them all.

Word arithmetic runs in int64 masked to 32 bits (PyTorch has no u32
shifts on the CPU), except over the data itself: crc32's per-bit pass
works on int32 bit patterns and adler32 in int32 folded mod 65521, so
neither widens the data to int64.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import trace
from ..codec import program
from ..utils import device as _device

ADLER_BASE = 65521
CRC_POLY = 0xEDB88320  # reflected
_M32 = 0xFFFFFFFF
_ADLER_CHUNK = 512
_CRC_CHUNK = 256        # bytes per chunk
_PIECE = 1 << 20        # the largest padded size one program takes
_THREADS = 256          # csrc/crc32.cu: threads a block (kThreads)
_LOG_SEG = 6            # and bytes a thread (kSeg = 2^6)
_SPAN = _THREADS << _LOG_SEG    # bytes a block (kSpan)


@functools.lru_cache(maxsize=None)
def _crc_tables() -> np.ndarray:
    """Slice-by-8 tables, shape (8, 256) uint32."""
    t = np.zeros((8, 256), dtype=np.uint64)
    for i in range(256):
        c = np.uint64(i)
        for _ in range(8):
            c = (c >> np.uint64(1)) ^ (np.uint64(CRC_POLY) * (c & np.uint64(1)))
        t[0, i] = c
    for k in range(1, 8):
        for i in range(256):
            c = t[k - 1, i]
            t[k, i] = (c >> np.uint64(8)) ^ t[0, int(c & np.uint64(0xFF))]
    return t.astype(np.uint32)


def _gf2_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Product of two GF(2) 32x32 matrices, each stored as 32 uint32 columns
    (column j of the result = a applied to column j of b)."""
    bits = (b[:, None] >> np.arange(32, dtype=np.uint32)) & 1
    return np.bitwise_xor.reduce(np.where(bits > 0, a[None, :], 0),
                                 axis=1).astype(np.uint32)


@functools.lru_cache(maxsize=None)
def _shift_matrix_pow2(log2_bytes: int) -> tuple[int, ...]:
    """Matrix advancing a raw CRC state over 2^log2_bytes zero bytes, as 32
    columns (column j = image of bit j)."""
    if log2_bytes == 0:
        t0 = _crc_tables()[0]
        m = np.zeros(32, dtype=np.uint32)
        for j in range(32):
            s = np.uint32(1) << np.uint32(j)
            m[j] = (s >> np.uint32(8)) ^ t0[int(s & np.uint32(0xFF))]
        return tuple(int(x) for x in m)
    prev = np.array(_shift_matrix_pow2(log2_bytes - 1), dtype=np.uint32)
    return tuple(int(x) for x in _gf2_matmul(prev, prev))


def _apply_matrix_host(m, crc: int) -> int:
    acc = 0
    for j in range(32):
        if (crc >> j) & 1:
            acc ^= m[j]
    return acc


def _advance_host(crc: int, nbytes: int) -> int:
    """Advance a raw CRC state over nbytes zero bytes (bit decomposition)."""
    k = 0
    while nbytes:
        if nbytes & 1:
            crc = _apply_matrix_host(_shift_matrix_pow2(k), crc)
        nbytes >>= 1
        k += 1
    return crc


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """crc32(A||B) from crc32(A), crc32(B), len(B): advance crc1 through len2
    zero bytes in GF(2), xor crc2 (the pre/post complements cancel)."""
    return (_advance_host(crc1 & _M32, len2) ^ (crc2 & _M32)) & _M32


def adler32_combine(adler1: int, adler2: int, len2: int) -> int:
    """adler32(A||B) from the two parts (zlib adler32_combine algebra)."""
    rem = len2 % ADLER_BASE
    s1a, s2a = adler1 & 0xFFFF, (adler1 >> 16) & 0xFFFF
    s1b, s2b = adler2 & 0xFFFF, (adler2 >> 16) & 0xFFFF
    s1 = (s1a + s1b - 1) % ADLER_BASE
    s2 = (s2a + s2b + rem * ((s1a - 1) % ADLER_BASE)) % ADLER_BASE
    s1 = (s1 + ADLER_BASE) % ADLER_BASE
    s2 = (s2 + ADLER_BASE) % ADLER_BASE
    return (s2 << 16) | s1


@functools.lru_cache(maxsize=None)
def _bitlinear_consts(c: int) -> np.ndarray:
    """(c//4, 32) u32: contribution of each bit of each little-endian u32
    word of a c-byte chunk to the chunk's raw CRC (a byte v at position p
    contributes M_{c-1-p} . T0[v], and T0 is linear in v's bits)."""
    t0 = _crc_tables()[0]
    m8 = np.array(_shift_matrix_pow2(0), dtype=np.uint32)
    jj = np.arange(32, dtype=np.uint32)
    kb = np.zeros((c, 8), np.uint32)
    cur = t0[1 << np.arange(8)].astype(np.uint32)        # position c-1
    for p in range(c - 1, -1, -1):
        kb[p] = cur
        bits = (cur[:, None] >> jj) & 1                  # (8, 32)
        cur = np.bitwise_xor.reduce(
            np.where(bits.astype(bool), m8[None, :], 0), axis=1)
    kw = np.zeros((c // 4, 32), np.uint32)
    for j in range(32):
        kw[:, j] = kb[(np.arange(c // 4) * 4) + (j >> 3), j & 7]
    return kw


@functools.lru_cache(maxsize=None)
def _pow2_matrix_stack() -> np.ndarray:
    """(32, 32) int64: row k = columns of the matrix advancing a raw CRC
    state over 2^k zero bytes."""
    return np.stack([np.array(_shift_matrix_pow2(k), dtype=np.int64)
                     for k in range(32)])


# The tables live on each device once: a captured program cannot upload.
# Every user only reads them.
@functools.lru_cache(maxsize=None)
def _crc_tables_on(dev: torch.device):
    """(bit-linear chunk constants (c//4, 32), shift-matrix stack (32, 32))
    on `dev`, int64 holding u32 values."""
    return (torch.as_tensor(_bitlinear_consts(_CRC_CHUNK).astype(np.int64),
                            device=dev),
            torch.as_tensor(_pow2_matrix_stack(), device=dev))


@functools.lru_cache(maxsize=None)
def _crc_consts32_on(dev: torch.device) -> torch.Tensor:
    """The bit-linear chunk constants as int32 bit patterns on `dev`."""
    k = _bitlinear_consts(_CRC_CHUNK).view(np.int32)
    return torch.as_tensor(k.copy(), device=dev)


def _pad_bucket(n: int, chunk: int) -> int:
    """Padded size of an n-byte input: a chunk multiple, doubling up to
    1 MiB and in 1 MiB steps beyond, so that few shapes (captured programs)
    serve every length (the JAX package's _pad_bucket)."""
    n = max(n, 1)
    b = chunk
    while b < n:
        b = b * 2 if b < (1 << 20) else b + (1 << 20)
    return b


def _padded(data, n: int, size: int, front: bool, device) -> torch.Tensor:
    """The n bytes of `data` (bytes-like, or a uint8 tensor whose device
    is used) zero-padded to `size` bytes, at the front or the back, on the
    device."""
    if isinstance(data, torch.Tensor):
        t = data.reshape(-1).to(torch.uint8)
        if size == n:           # a copy: a view may start off a word
            return t.clone()
        z = torch.zeros(size - n, dtype=torch.uint8, device=t.device)
        return torch.cat([z, t] if front else [t, z])
    buf = np.zeros(size, np.uint8)
    src = np.frombuffer(memoryview(data), dtype=np.uint8)
    if front:
        buf[size - n:] = src
    else:
        buf[:n] = src
    return _device.upload(buf, _device.resolve(device))


def _xor_reduce_last(v: torch.Tensor) -> torch.Tensor:
    """XOR over the last dimension (a power of two) by halving."""
    while v.shape[-1] > 1:
        v = v[..., 0::2] ^ v[..., 1::2]
    return v[..., 0]


def _apply_matrix(m: torch.Tensor, crc: torch.Tensor) -> torch.Tensor:
    """GF(2) 32x32 matrix (32 int64 columns) times a tensor of states."""
    bits = (crc[..., None] >> torch.arange(32, device=crc.device)) & 1
    return _xor_reduce_last(torch.where(bits > 0, m, 0))


def _crc32_program(data: torch.Tensor, scalars: torch.Tensor):
    """crc32 of the last n bytes of `data`, a uint8 tensor of whole chunks
    front-padded with zeros (invisible to the raw CRC, whose state starts
    at zero); scalars = (init, n), int64 on data's device. Returns a 0-d
    int64 tensor. The port of the JAX _crc32_device: no host read, so it
    runs as one captured program per padded size. The per-bit pass over
    the data works on int32 bit patterns (a quarter of the int64 working
    set); the chunk states from there on are int64 u32 values."""
    c = _CRC_CHUNK
    K, stack = _crc_tables_on(data.device)
    K32 = _crc_consts32_on(data.device)
    init, n = scalars.unbind()
    words = data.view(torch.int32).reshape(-1, c // 4)
    v = torch.zeros_like(words)
    for j in range(32):
        v ^= torch.where(((words >> j) & 1) != 0, K32[:, j], 0)
    raw = _xor_reduce_last(v).to(torch.int64) & _M32
    # log-depth tree: raw(A||B) = M_len(B) raw(A) ^ raw(B)
    level = c.bit_length() - 1      # chunk bytes = 2^level
    while raw.shape[0] > 1:
        if raw.shape[0] % 2:
            raw = torch.cat([raw.new_zeros(1), raw])     # front zero chunk
        raw = _apply_matrix(stack[level], raw[0::2]) ^ raw[1::2]
        level += 1
    # std crc32(M, init) = ~( raw(M) ^ M_{8n}(~init) ), the advance by n
    # taken bit by bit of n (_advance_by_n)
    adv = (~init) & _M32
    for k in range(32):
        adv = torch.where(((n >> k) & 1) > 0, _apply_matrix(stack[k], adv),
                          adv)
    return ((~(raw[0] ^ adv)) & _M32,)


def _modsum(x: torch.Tensor) -> torch.Tensor:
    """Sum mod ADLER_BASE of int32 values, each reduced mod ADLER_BASE and
    summed 4096 at a time so that no partial sum reaches 2^31 (the JAX
    _modsum). Returns a 0-d int32 tensor."""
    while x.numel() > 1:
        pad = (-x.numel()) % 4096
        if pad:
            x = torch.cat([x, x.new_zeros(pad)])
        x = (x.reshape(-1, 4096) % ADLER_BASE).sum(
            1, dtype=torch.int32) % ADLER_BASE
    return x.reshape(()) % ADLER_BASE


def _mulmod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b mod ADLER_BASE for int32 a, b in [0, ADLER_BASE), in int32: b
    is split at bit 8 so that no product reaches 2^25."""
    hi = (a * (b >> 8)) % ADLER_BASE
    return (hi * 256 + a * (b & 255)) % ADLER_BASE


def _adler32_program(data: torch.Tensor, scalars: torch.Tensor):
    """adler32 of the first n bytes of `data`, a uint8 tensor of whole
    chunks back-padded with zeros (which add nothing to either sum);
    scalars = (init, n), int64 on data's device. Returns a 0-d int64
    tensor. The port of the JAX _adler32_device, in int32 like it: a
    chunk's sums fit (255 * 512 * 511 / 2 < 2^31), and every sum over
    chunks folds mod 65521 as it goes (_modsum, _mulmod)."""
    c = _ADLER_CHUNK
    B = ADLER_BASE
    i32 = torch.int32
    init, n = scalars.unbind()
    d = data.reshape(-1, c)
    s_c = d.sum(1, dtype=i32)                            # < 255 * 512
    w_c = (d.to(i32) * torch.arange(c, dtype=i32, device=d.device)).sum(
        1, dtype=i32)
    # each chunk's offset mod BASE, without forming the offset
    o_m = (torch.arange(d.shape[0], dtype=i32, device=d.device) % B
           * c) % B
    s1_0, s2_0 = (init & 0xFFFF) % B, ((init >> 16) & 0xFFFF) % B
    nm = n % B
    s1 = (s1_0 + _modsum(s_c)) % B
    # s2 = s2_0 + n*s1_0 + sum over chunks of (n - o_c) * S_c - W_c
    t = (_mulmod((nm.to(i32) + B - o_m) % B, s_c % B) + B - w_c % B) % B
    s2 = (s2_0 + (nm * s1_0) % B + _modsum(t)) % B
    return ((s2 << 16) | s1,)


def _checksum(fn, data, init: int, chunk: int, front: bool, device) -> int:
    """fn over data padded to its bucket (the JAX package's _pad_bucket),
    as captured programs on a card; one readback, the 32-bit result (init
    for empty data). A bucket above _PIECE bytes is whole pieces of _PIECE
    bytes, the padding in the first piece (crc32, front) or the last
    (adler32, back): each piece runs the one _PIECE-byte program with the
    running value as its init, which both checksums chain as zlib's init
    argument does. So every size above 1 MiB shares one program. Bytes
    go up in one transfer; a tensor is cut into pieces where it lies, so
    no buffer of its size is made."""
    n = data.numel() if isinstance(data, torch.Tensor) else len(data)
    if n == 0:
        return init & _M32
    size = _pad_bucket(n, chunk)
    dev = (data.device if isinstance(data, torch.Tensor)
           else _device.resolve(device))
    pad = size - n
    cuts = [min(max(k - (pad if front else 0), 0), n)
            for k in range(0, size + 1, min(size, _PIECE))]
    # the init, then each piece's count of real bytes, in one upload
    sc = _device.upload(np.array([init & _M32] + [b - a for a, b in zip(
        cuts, cuts[1:])], np.int64), dev)
    step = min(size, _PIECE)
    if isinstance(data, torch.Tensor):
        flat = data.reshape(-1)
        pieces = (_padded(flat[a:b], b - a, step, front, dev)
                  for a, b in zip(cuts, cuts[1:]))
    else:                   # one upload of the padded bucket
        whole = _padded(data, n, size, front, dev)
        pieces = (whole[k:k + step] for k in range(0, size, step))
    cur = sc[0]
    for k, piece in enumerate(pieces):
        cur = program.run(fn, (piece, torch.stack([cur, sc[k + 1]])))[0]
    return int(_device.to_host(cur))


def _weights(count: int, log_step: int) -> np.ndarray:
    """(32, count) u32: column t holds the 32 columns of the matrix that
    advances a raw CRC state over (count - 1 - t) * 2^log_step zero
    bytes (column-major, so that neighbouring threads read neighbouring
    words)."""
    step = np.array(_shift_matrix_pow2(log_step), np.uint32)
    out = np.empty((count, 32), np.uint32)
    out[-1] = np.uint32(1) << np.arange(32, dtype=np.uint32)   # identity
    for t in range(count - 2, -1, -1):
        out[t] = _gf2_matmul(step, out[t + 1])
    return out.T


@functools.lru_cache(maxsize=None)
def _kernel_tables(threads: int = _THREADS,
                   log_seg: int = _LOG_SEG) -> np.ndarray:
    """What csrc/crc32.cu reads, as int32 bit patterns of u32 values: the
    slice-by-8 tables (8 x 256); the matrices advancing a raw CRC state
    over 2^k zero bytes for k < 64, as 32 columns each; each thread's
    weight within a block (over the segments after its own) and within the
    fold (over the spans after its own), as _weights. The defaults are the
    kernel's block shape."""
    pow2 = [_shift_matrix_pow2(k) for k in range(64)]
    log_span = log_seg + threads.bit_length() - 1
    return np.concatenate([_crc_tables().reshape(-1),
                           np.array(pow2, np.uint32).reshape(-1),
                           _weights(threads, log_seg).reshape(-1),
                           _weights(threads, log_span).reshape(-1)]
                          ).view(np.int32)


@functools.lru_cache(maxsize=None)
def _kernel_tables_on(dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(_kernel_tables(), device=dev)


def crc32_kernel(data: torch.Tensor, init: int = 0) -> torch.Tensor:
    """crc32 of a non-empty uint8 CUDA tensor (zlib convention, chained
    from init) by csrc/crc32.cu, read where it lies: a view at any byte
    offset needs no copy. Returns a 0-d int32 tensor on the card holding
    the u32 bit pattern; nothing is read back. Counts its launches in
    crc32_kernel.launches and in the open request's crc32.kernel."""
    from . import _cuda
    dev = data.device
    n = data.numel()
    if dev.type != "cuda" or n == 0:
        raise ValueError(f"crc32_kernel: want a non-empty CUDA tensor, got "
                         f"{n} B on {dev}")
    _cuda.check_tensor(data, "data", torch.uint8, dev, (n,))
    ptr = data.data_ptr()
    body = ((ptr & 15) + n) & ~15
    spans = max(1, -(-body // _SPAN))
    fn = _cuda.entry("crc32", "jd_crc32",
                     [ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32,
                      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                      ctypes.c_void_p])
    # the result, the ticket, one state per block
    scratch = torch.empty(2 + spans, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = fn(ptr, n, init & _M32, _kernel_tables_on(dev).data_ptr(),
                scratch.data_ptr(), spans, _cuda.stream_ptr())
    _cuda.check(rc, "crc32 kernel launch")
    crc32_kernel.launches += 1
    trace.count("crc32.kernel")
    return scratch[0]


crc32_kernel.launches = 0


@trace.span("crc32")
def crc32(data, init: int = 0, device="cuda") -> int:
    """crc32 of a byte buffer (zlib convention), computed on `device` (or on
    the device of a uint8 tensor): on a card by crc32_kernel (bytes go up
    in one pinned copy), on the CPU by the plain program."""
    tensor = isinstance(data, torch.Tensor)
    if (data.numel() if tensor else len(data)) == 0:
        return init & _M32
    dev = data.device if tensor else _device.resolve(device)
    if dev.type == "cpu":
        return _checksum(_crc32_program, data, init, _CRC_CHUNK, True, device)
    if tensor:
        # a strided view is copied once; a contiguous one is read in place
        flat = data.reshape(-1).to(torch.uint8).contiguous()
    else:
        flat = _device.upload(np.frombuffer(memoryview(data), np.uint8), dev)
    return int(_device.to_host(crc32_kernel(flat, init))) & _M32


@trace.span("adler32")
def adler32(data, init: int = 1, device="cuda") -> int:
    """adler32 of a byte buffer, computed on `device` (or on the device of a
    uint8 tensor). Counts the bytes in the open request's adler32.bytes."""
    trace.count("adler32.bytes",
                data.numel() if isinstance(data, torch.Tensor) else len(data))
    return _checksum(_adler32_program, data, init, _ADLER_CHUNK, False,
                     device)
