"""v1 match expansion (the anchored decode's expansion stage).

Port of jdeflate_tpu/ops/expand.py. Literals are placed beforehand by one
scatter; the matches, compacted to stream order, are then expanded in place
with the contract of the reference's block-by-block, in-order expansion: a
block's 32 KiB window reaches into the output of the blocks before it
(like the reference's ring window, inflator.c:616-675). Byte i of a match
(off, d, len) copies byte off - d + (i mod d), which precedes the match,
so overlapping copies (d < len) need no doubling.

Two implementations of one contract:
  * expand_matches_ref - plain PyTorch (a cover map and a dependency-doubling
    resolve), any device;
  * expand_matches - the CUDA kernels of csrc/expand1.cu on a CUDA tensor
    (each match's collapsed sources placed in a map, then the ordered-tile
    resolve of csrc/tile_resolve.cuh over every SM), the plain version on a
    CPU tensor.
"""
from __future__ import annotations

import ctypes

import torch

from ..formats import constants as C
from . import decode as dk

HALO = C.WINDOW_SIZE                 # 32768
# Buffer geometry of the reference kernel, kept because the caller sizes
# its buffers with it: a region is 32 alignment rows + the halo + one
# block's output (+ straddle), in 128-byte rows.
RROWS = 832
REGION = RROWS * 128


def _in_ranges(ranges: torch.Tensor, T: int) -> torch.Tensor:
    """(T,) bool: match t lies in some block's [t0, t1)."""
    dev = ranges.device
    t0 = ranges[:, 0].long().clamp(0, T)
    t1 = torch.maximum(ranges[:, 1].long().clamp(0, T), t0)
    diff = torch.zeros(T + 1, dtype=torch.int64, device=dev)
    diff.index_add_(0, t0, torch.ones_like(t0))
    diff.index_add_(0, t1, -torch.ones_like(t1))
    return torch.cumsum(diff, 0)[:T] > 0


def expand_matches_ref(buf: torch.Tensor, m_off: torch.Tensor,
                       m_d: torch.Tensor, m_len: torch.Tensor,
                       ranges: torch.Tensor) -> torch.Tensor:
    """Plain version of expand_matches; returns the expanded buffer (a new
    tensor). Matches in stream order write disjoint ranges at increasing
    offsets, so resolving every match position's collapsed source by
    pointer doubling gives the bytes the in-order copy gives."""
    n = buf.shape[0]
    T = m_off.shape[0]
    dev = buf.device
    if T == 0 or ranges.shape[0] == 0:
        return buf.clone()
    off = m_off.long()
    d = m_d.long()
    ln = m_len.long()
    # a match at off < 0 reads only before 0 and so copies nothing
    ok = (_in_ranges(ranges, T) & (d > 0) & (ln > 0) & (off >= 0)
          & (off < n))
    tidx = torch.arange(T, dtype=torch.int64, device=dev)
    cover = torch.full((n + 1,), -1, dtype=torch.int64, device=dev)
    cover = cover.scatter_reduce(
        0, torch.where(ok, off, torch.full_like(off, n)),
        torch.where(ok, tidx, torch.full_like(tidx, -1)), "amax")[:n]
    cover = torch.cummax(cover, 0).values
    covc = cover.clamp(0, T - 1)
    q = torch.arange(n, dtype=torch.int64, device=dev)
    toff, td = off[covc], d[covc].clamp(min=1)
    src = toff - td + torch.remainder(q - toff, td)
    is_m = (cover >= 0) & (q < toff + ln[covc]) & (src >= 0)
    src = torch.where(is_m, src, q)
    val, _ = dk.lz_resolve(buf.long(), src, ~is_m, is_m,
                           max(2, (n - 1).bit_length()))
    return val.to(torch.uint8)


def expand_matches(buf: torch.Tensor, m_off: torch.Tensor, m_d: torch.Tensor,
                   m_len: torch.Tensor, ranges: torch.Tensor) -> torch.Tensor:
    """Expand matches in place over `buf` ((n,) u8, literals placed).

    m_off/m_d/m_len: (T,) i32 matches in stream order (absolute buffer
    offset, distance, length). ranges: (nblocks, 4) i32 [t0, t1, out_start,
    0] per block: block b expands matches [t0, t1), blocks in order.
    Expanded matches must write disjoint byte ranges at increasing offsets
    (stream order, as the anchored decode builds them; csrc/expand1.cu).
    On a CUDA tensor (buf 4-byte aligned) csrc/expand1.cu rewrites `buf`
    and returns it; on a CPU tensor the plain version returns a new
    tensor. Counts its kernel launches in expand_matches.launches."""
    if buf.device.type == "cpu":
        return expand_matches_ref(buf, m_off, m_d, m_len, ranges)
    from . import _cuda
    dev = buf.device
    n = buf.shape[0]
    T = m_off.shape[0]
    nb = ranges.shape[0]
    _cuda.check_tensor(buf, "buf", torch.uint8, dev)
    for name, t in (("m_off", m_off), ("m_d", m_d), ("m_len", m_len)):
        _cuda.check_tensor(t, name, torch.int32, dev, (T,))
    _cuda.check_tensor(ranges, "ranges", torch.int32, dev, (nb, 4))
    fn = _cuda.entry("expand1", "jd_expand1",
                     [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                      ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                      ctypes.c_void_p])
    # the furthest byte a match writes, then the resolve's ticket and flags
    srcmap, sync = _cuda.resolve_scratch(n, dev, lead=1)
    with torch.cuda.device(dev):
        rc = fn(buf.data_ptr(), n, m_off.data_ptr(), m_d.data_ptr(),
                m_len.data_ptr(), T, ranges.data_ptr(), nb,
                srcmap.data_ptr(), srcmap.numel(), sync.data_ptr(),
                sync.numel(), _cuda.stream_ptr())
    _cuda.check(rc, "expand1 kernel launch")
    expand_matches.launches += 1
    return buf


expand_matches.launches = 0
