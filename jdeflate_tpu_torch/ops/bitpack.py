"""Variable-length bitstream packing via exclusive scan (port of
jdeflate_tpu/ops/bitpack.py).

Every item (header field, precode symbol, token, EOB) is a (value <= 48
bits, nbits) pair; an exclusive scan over nbits gives each item's bit
offset, and each value splits over <= 3 u32 output words. DEFLATE is
LSB-first: bit k of the stream is bit (k mod 8) of byte (k div 8), the
little-endian u32 word layout.

PyTorch has no u32 shifts or adds on the CPU, so words are int64 tensors
holding values in [0, 2^32): every left shift is masked back to 32 bits,
and every shift amount is clamped into [0, 31] even where the result is
discarded (a negative or >= 64 shift is undefined).
"""
from __future__ import annotations

import torch

from . import scan

M32 = 0xFFFFFFFF


def _sh(x):
    """Shift amount clamped into [0, 31]."""
    return torch.clamp(x, 0, 31)


def append_bits(lo, hi, n, value, nb):
    """Append the nb-bit value (LSB-first) to a (lo, hi, n) 64-bit
    accumulator. lo, hi: int64 u32 words; n, nb: int64 bit counts."""
    v = value & M32
    zero = torch.zeros_like(lo)
    lo2 = lo | torch.where(n < 32, (v << _sh(n)) & M32, zero)
    spill = torch.where((n > 0) & (n < 32), v >> _sh(32 - n), zero)
    hi2 = hi | spill | torch.where(n >= 32, (v << _sh(n - 32)) & M32, zero)
    return lo2, hi2, n + nb


def combine64(lo1, hi1, n1, lo2, hi2, n2):
    """Concatenate two LSB-first bit strings (n1 + n2 <= 64).

    Input invariant, as in the reference: bits at positions >= n are zero
    in both operands, and n2 <= 32 whenever n1 >= 32 (hi2 is dropped on
    that branch)."""
    s = _sh(n1)
    lt32 = n1 < 32
    zero = torch.zeros_like(lo1)
    lo = lo1 | torch.where(lt32, (lo2 << s) & M32, zero)
    carry = torch.where((n1 > 0) & lt32, lo2 >> _sh(32 - n1), zero)
    hi = hi1 | torch.where(lt32, ((hi2 << s) & M32) | carry,
                           (lo2 << _sh(n1 - 32)) & M32)
    return lo, hi, n1 + n2


def pack(lo, hi, nbits, num_words: int):
    """Pack items into words.

    lo, hi: (N,) int64 u32 values, bits above nbits zero. nbits: (N,) int in
    [0, 48]. Returns (words (num_words,) int64 u32 values, offsets (N,)
    int64, total_bits (0-dim int64)).

    Segmented sum: per-item word contributions are cumsummed and each word
    takes the difference of the cumsum at consecutive word boundaries.
    Disjoint bits make add == or. The int64 cumsums do not wrap, so each
    difference is the exact sum of its word's contributions; it is masked
    to 32 bits as the u32 wraparound would leave it.
    """
    nbits = nbits.to(torch.int64)
    dev = nbits.device
    N = nbits.shape[0]
    offs = torch.cumsum(nbits, 0) - nbits                 # exclusive scan
    total = (offs[-1] + nbits[-1]) if N else torch.zeros((), dtype=torch.int64,
                                                          device=dev)
    word = offs >> 5
    s = offs & 31
    rs = torch.clamp(32 - s, max=31)                      # s == 0 guarded
    live = nbits > 0
    zero = torch.zeros_like(lo)
    w0 = torch.where(live, (lo << s) & M32, zero)
    w1 = torch.where(live, torch.where(s == 0, zero, lo >> rs)
                     | ((hi << s) & M32), zero)
    w2 = torch.where(live, torch.where(s == 0, zero, hi >> rs), zero)
    c0 = torch.cumsum(w0, 0)
    c1 = torch.cumsum(w1, 0)
    c2 = torch.cumsum(w2, 0)
    # last item index per destination word (words >= num_words dropped into
    # a spare slot), empty words filled by a running max
    idx = torch.arange(N, dtype=torch.int64, device=dev)
    bnd = torch.full((num_words + 1,), -1, dtype=torch.int64, device=dev)
    bnd.scatter_reduce_(0, torch.where(word < num_words, word, num_words),
                        idx, reduce="amax")
    bnd = scan.running(bnd[:num_words], "max")
    has = bnd >= 0
    bi = torch.clamp(bnd, min=0)
    zw = torch.zeros(num_words, dtype=torch.int64, device=dev)
    g0 = torch.where(has, c0[bi], zw) if N else zw
    g1 = torch.where(has, c1[bi], zw) if N else zw
    g2 = torch.where(has, c2[bi], zw) if N else zw

    def shift(g, k):            # [0]*k ++ g[:-k]
        return torch.cat([zw[:k], g[:num_words - k]])

    # word w collects: its own items' w0, word w-1's items' w1, w-2's w2
    d0 = (g0 - shift(g0, 1)) & M32
    d1 = (shift(g1, 1) - shift(g1, 2)) & M32
    d2 = (shift(g2, 2) - shift(g2, 3)) & M32
    return (d0 + d1 + d2) & M32, offs, total
