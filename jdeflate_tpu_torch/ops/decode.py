"""Plain token-slot expansion: the referee for the expand kernel.

Token slots -> output bytes by an offset scan, a literal scatter, a cover
map and a dependency-doubling LZ resolve. The window crosses block and batch
boundaries through the 32 KiB halo, like the reference's ring window
(inflator.c:616-675). Port of jdeflate_tpu/codec/inflate.py::_assemble_output
and jdeflate_tpu/ops/decode.py::lz_resolve.
"""
from __future__ import annotations

import torch

from ..formats import constants as C

HALO = C.WINDOW_SIZE


def lz_resolve(val: torch.Tensor, src: torch.Tensor, resolved: torch.Tensor,
               mask: torch.Tensor, max_rounds: int):
    """Resolve back-reference chains by pointer doubling, stopping as soon as
    every masked position is resolved.

    val: (N,) output bytes (literal positions already set).
    src: (N,) copy-source index per position (self for resolved).
    resolved: (N,) bool. mask: (N,) bool - positions that must resolve.
    Returns (val & 0xFF, resolved)."""
    pv = (val & 0xFF) | (resolved.to(val.dtype) << 8)
    for _ in range(max_rounds):
        if not bool(((pv < 256) & mask).any()):
            break
        done = pv >= 256
        pv = torch.where(done, pv, pv[src])
        src = torch.where(done, src, src[src])
    return pv & 0xFF, pv >= 256


def assemble_output(o_len, o_lit, o_dist, halo, out_cap: int):
    """Token slots (o_len, o_lit, o_dist flat) -> (out (out_cap,) u8,
    produced, err). err counts tokens reaching past HALO + out_cap and
    positions left unresolved."""
    dev = o_len.device
    o_len = o_len.to(torch.int64)
    o_lit = o_lit.to(torch.int64)
    o_dist = o_dist.to(torch.int64)
    off = HALO + torch.cumsum(o_len, 0) - o_len
    produced = o_len.sum()
    n = HALO + out_cap
    val = torch.zeros(n, dtype=torch.int64, device=dev)
    val[:HALO] = halo.to(torch.int64)
    is_tok = o_len > 0
    is_lit = is_tok & (o_dist == 0)
    put = is_lit & (off < n)
    val[off[put]] = o_lit[put]

    S = o_len.shape[0]
    tok_idx = torch.arange(S, dtype=torch.int64, device=dev)
    cover = torch.full((n,), -1, dtype=torch.int64, device=dev)
    put = is_tok & (off < n)           # token offsets are distinct
    cover[off[put]] = tok_idx[put]
    cover = torch.cummax(cover, 0).values
    covc = cover.clamp(0, S - 1)
    q = torch.arange(n, dtype=torch.int64, device=dev)
    d = o_dist[covc]
    is_match_pos = (cover >= 0) & (d > 0)
    # intra-match collapse: position q of a match copies straight from the
    # d-byte window before the token, so overlapping copies resolve in one
    # hop; remaining chains only cross other tokens
    toff = off[covc]
    src = torch.where(is_match_pos,
                      toff - d + (q - toff) % torch.clamp(d, min=1), q)
    src = src.clamp(0, n - 1)
    resolved = (q < HALO) | ((cover >= 0) & ~is_match_pos)
    mask = q < HALO + produced
    val, resolved = lz_resolve(val, src, resolved, mask,
                               max(2, (n - 1).bit_length()))
    err = (((off + o_len > n) & is_tok).sum()
           + (~resolved & mask).sum())
    return val[HALO:].to(torch.uint8), produced, err
