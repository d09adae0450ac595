"""Token-expansion engine v5: per-position plan, then a resolve.

Port of jdeflate_tpu/ops/expand5.py, selected by JDT_EXPAND=5. The
pipeline, for one batch of lane-major walk tokens:

  1. seed plane (kernel csrc/expand5seed.cu): from the tokens and the
     walk's lane offsets, each fast-slice token's 16-bit seed (literal
     byte / match distance) at its first output byte and 0 at every other
     position of the plane, with the flat slot (off, seed16) arrays beside
     it; the rare lanes with more than S_SLICE tokens ride the exact top-k
     spill pass (plain PyTorch).
  2. butterfly propagate (plain): every output position learns its covering
     token's pack and its phase within it, in 9 shift/select stages (a
     DEFLATE item is at most 258 bytes).
  3. resolve (kernel csrc/expand5resolve.cu): every position's entry
     (a byte, or its collapsed source) straight from its plan, grounded by
     the ordered-tile resolve shared with the other engines (16 KiB tiles
     over every SM, csrc/tile_resolve.cuh).

The collapsed source rule: a position p inside a match (off, d, len) reads
from src = off - d + (p - off) % d, which always precedes the match, so
chains only cross token boundaries (nesting), never self-overlap.

walk-token format (ops/walk.py): u32 bit patterns in int32, bits 30:32 kind
(1=lit, 2=match); lit: byte in 0:8; match: len in 0:9, dist-1 in 9:24.

Seed/plan pack (i32):
  bit 25: valid; bit 24: is_lit
  lit:   byte in bits 0:8
  match: dist-1 in bits 0:15, phase (p - off) in bits 15:24

Errors kept from the reference: the TPU seed kernel reads each 4 KiB
region's candidate slots through a window of two CANDW-slot blocks and
counts the regions whose slots do not fit (seed_window_err), and the spill
pass handles at most SPILL_K lanes. The kernels here place every seed and
have no window, but the count is kept so the port errs, and falls back to
the native decoder, exactly where the reference does (ROADMAP C3).
"""
from __future__ import annotations

import ctypes

import torch

from ..formats import constants as C
from . import walk as wk

HALO = C.WINDOW_SIZE                  # 32768
V_VALID = 1 << 25
V_LIT = 1 << 24

S_SLICE = 8        # slots per lane seeded by the fast path
SREG = 4096        # reference seed region (output bytes)
CANDW = 8192       # reference candidate slots per block; a region sees two
SPILL_K = 128      # spill lanes handled exactly per batch; more -> err

_I32 = torch.int32


def _laneoff(outlen: torch.Tensor) -> torch.Tensor:
    return (torch.cumsum(outlen, 0) - outlen).to(_I32)


def _kinds(tok):
    kind = (tok >> 30) & 3
    is_lit = kind == wk.TOK_LIT
    is_m = kind == wk.TOK_MATCH
    zero = torch.zeros_like(tok)
    ln = torch.where(is_lit, torch.ones_like(tok),
                     torch.where(is_m, tok & 0x1FF, zero))
    return is_lit, is_m, ln


def slot_attrs(tok_lm: torch.Tensor, outlen: torch.Tensor):
    """(L, S) walk tokens + (L,) outlen -> flat slot (off, seed) arrays.

    off: (L*S,) i32 output position of each slot's token (batch-relative;
      empty slots inherit the running off). seed: (L*S,) i32 plan pack
      (0 for empty slots)."""
    is_lit, is_m, ln = _kinds(tok_lm)
    within = torch.cumsum(ln, 1) - ln
    off = _laneoff(outlen)[:, None] + within
    dm1 = (tok_lm >> 9) & 0x7FFF
    lit = tok_lm & 0xFF
    seed = torch.where(is_lit, V_VALID | V_LIT | lit,
                       torch.where(is_m, V_VALID | dm1,
                                   torch.zeros_like(tok_lm)))
    return off.reshape(-1).to(_I32), seed.reshape(-1).to(_I32)


def propagate(S: torch.Tensor) -> torch.Tensor:
    """Butterfly: fill every position with its covering token's pack plus
    the accumulated phase. 9 stages (items <= 258 bytes)."""
    for b in range(9):
        sh = 1 << b
        shifted = torch.cat([torch.zeros(sh, dtype=S.dtype, device=S.device),
                             S[:-sh]])
        shifted = torch.where((shifted & V_VALID) != 0, shifted + (sh << 15),
                              torch.zeros_like(shifted))
        S = torch.where((S & V_VALID) != 0, S, shifted)
    return S


def plan_fields(P: torch.Tensor, n: int):
    """P (n,) plan packs -> (is_lit, lit, src, is_m) with src batch-relative
    (negative: into the halo). The reference takes phase % d through an f32
    floor-divide and two corrections, exact for phase <= 511; the integer
    remainder here gives the same value (tests pin it)."""
    pos = torch.arange(n, dtype=P.dtype, device=P.device)
    valid = (P & V_VALID) != 0
    is_lit = valid & ((P & V_LIT) != 0)
    lit = P & 0xFF
    d = (P & 0x7FFF) + 1
    phase = (P >> 15) & 0x1FF
    src = pos - phase - d + torch.remainder(phase, d)
    is_m = valid & ~is_lit
    return is_lit, lit, torch.where(is_m, src, pos), is_m


def seed_scatter_ref(off, seed, n: int):
    """Plain seed placement, for plan packs and 16-bit seeds alike: every
    nonzero seed max-scattered at its offset in [0, n) (offsets of valid
    seeds are distinct, so the max only guards garbage). (n,) i32."""
    idx = torch.where((seed != 0) & (off >= 0) & (off < n), off,
                      torch.full_like(off, n)).long()
    out = torch.zeros(n + 1, dtype=_I32, device=seed.device)
    return out.scatter_reduce(0, idx, seed.to(_I32), "amax")[:n]


def resolve_ref(P, halo, out_cap: int):
    """Plain resolve: global fixpoint value iteration (converges in
    max-chain-depth rounds; the kernel doubles pointers instead). The
    dependency graph is acyclic (every source precedes its position), so
    the first round that changes nothing has reached the unique result."""
    is_lit, lit, src, is_m = plan_fields(P, out_cap)
    buf = torch.cat([halo.to(_I32),
                     torch.where(is_lit, lit, torch.zeros_like(lit))])
    srch = torch.clamp(src + HALO, 0, HALO + out_cap - 1).long()
    for _ in range(out_cap):
        nb = torch.where(is_m, buf[srch], buf[HALO:])
        changed = bool((nb != buf[HALO:]).any())
        buf = torch.cat([buf[:HALO], nb])
        if not changed:
            break
    return buf[HALO:].to(torch.uint8)


def expand_tokens_ref(tok_lm, outlen, halo, out_cap: int):
    """Full-pipeline plain version over every slot (no fast slice, no
    spill): returns (out (out_cap,) u8, produced)."""
    off, seed = slot_attrs(tok_lm, outlen)
    produced = outlen.sum(dtype=_I32)
    S = seed_scatter_ref(off, seed, out_cap)
    P = propagate(S)
    return resolve_ref(P, halo, out_cap), produced


def _tok_attrs(toks: torch.Tensor, laneoff: torch.Tensor):
    """Token rows + per-lane output offsets -> (off, seed16) arrays.

    seed16: 0 empty; 0x8000|byte literal; d in 1..32767 match (d=32768 ->
    0xFFFF)."""
    is_lit, is_m, ln = _kinds(toks)
    within = torch.cumsum(ln, 1) - ln
    off = laneoff[:, None] + within
    d = ((toks >> 9) & 0x7FFF) + 1
    lit = toks & 0xFF
    zero = torch.zeros_like(toks)
    seed16 = torch.where(
        is_lit, 0x8000 | lit,
        torch.where(is_m, torch.where(d == 32768, zero + 0xFFFF, d), zero))
    return off.to(_I32), seed16.to(_I32)


def _fast_attrs(tok_lm: torch.Tensor, laneoff: torch.Tensor):
    """Flat (off, seed16) over the (L, S_SLICE) fast slice, each lane's
    offsets from laneoff."""
    off, seed16 = _tok_attrs(tok_lm[:, :S_SLICE], laneoff)
    return off.reshape(-1).contiguous(), seed16.reshape(-1).contiguous()


def slot_attrs16(tok_lm: torch.Tensor, outlen: torch.Tensor):
    """(L, S) walk tokens -> flat (off, seed16) over the (L, S_SLICE) fast
    slice, as the reference's seed kernel takes them."""
    return _fast_attrs(tok_lm, _laneoff(outlen))


def seed_window_err(off: torch.Tensor, seed16: torch.Tensor, out_cap: int):
    """The reference seed kernel's err (seed_scatter_mm,
    jdeflate_tpu/ops/expand5.py:252-266), in plain PyTorch: the flat slot
    arrays are viewed as CANDW-slot blocks, each SREG-byte output region
    reads the two blocks from the one holding its first seed, and a region
    whose seeds span more blocks counts one. Valid offsets are strictly
    increasing in flat order; empty slots carry seed 0 and extend nothing."""
    dev = off.device
    n = off.shape[0]
    NB = (-(-(-(-n // CANDW)) // 8) + 2) * 8
    offs = torch.full((NB * CANDW,), -1, dtype=_I32, device=dev)
    offs[:n] = torch.where(seed16 != 0, off, torch.full_like(off, -1))
    blk_last = torch.cummax(offs.reshape(NB, CANDW).max(1).values, 0).values
    blk_last = blk_last.contiguous()
    nreg = -(-out_cap // SREG)
    bounds = torch.arange(nreg + 1, dtype=_I32, device=dev) * SREG
    last_blk = torch.searchsorted(blk_last, blk_last[-1:])
    lo_b = torch.searchsorted(blk_last, bounds[:-1])
    hi_b = torch.minimum(torch.searchsorted(blk_last, bounds[1:]),
                         last_blk) + 1
    return (hi_b > lo_b + 2).sum(dtype=_I32)


def seed_plane_ref(tok_lm: torch.Tensor, laneoff: torch.Tensor,
                   out_cap: int):
    """Plain seed placement of the fast slice: slot_attrs16 and
    seed_scatter_ref, composed. laneoff: (L,) i64 exclusive scan of the
    lanes' output bytes (the walk's). Returns (S16 (out_cap,) i32 with
    every fast-slice seed at its token's first byte and 0 elsewhere, off
    (L*S_SLICE,) i32, seed16 (L*S_SLICE,) i32)."""
    off, seed16 = _fast_attrs(tok_lm, laneoff)
    return seed_scatter_ref(off, seed16, out_cap), off, seed16


def seed_plane(tok_lm: torch.Tensor, laneoff: torch.Tensor, out_cap: int):
    """The seed plane: csrc/expand5seed.cu on a CUDA tensor, seed_plane_ref
    on a CPU tensor. Same arguments and result as seed_plane_ref; the
    kernel writes every position of the plane, so nothing zeroes it first.
    laneoff must be the exclusive scan of the tokens' lengths, as
    ops/walk.py::walk_checked gives it. Counts its kernel launches in
    seed_plane.launches."""
    if tok_lm.device.type == "cpu":
        return seed_plane_ref(tok_lm, laneoff, out_cap)
    from . import _cuda
    dev = tok_lm.device
    L = tok_lm.shape[0]
    _cuda.check_tensor(tok_lm, "tok_lm", _I32, dev, (L, wk.S_SLOTS))
    _cuda.check_tensor(laneoff, "laneoff", torch.int64, dev, (L,))
    fn = _cuda.entry("expand5seed", "jd_expand5_seed",
                     [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                      ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_void_p])
    plane = torch.empty(out_cap, dtype=_I32, device=dev)
    off = torch.empty(L * S_SLICE, dtype=_I32, device=dev)
    seed16 = torch.empty(L * S_SLICE, dtype=_I32, device=dev)
    with torch.cuda.device(dev):
        rc = fn(tok_lm.data_ptr(), laneoff.data_ptr(), L, plane.data_ptr(),
                out_cap, off.data_ptr(), seed16.data_ptr(),
                _cuda.stream_ptr())
    _cuda.check(rc, "expand5 seed kernel launch")
    seed_plane.launches += 1
    return plane, off, seed16


seed_plane.launches = 0


def spill_pass(tok_lm, laneoff, S16_flat, out_cap: int):
    """Seed the rare lanes with more than S_SLICE tokens (dense literal
    runs). Takes the top-SPILL_K spill lanes by lane index, as lax.top_k
    does (ties of the -1 score by the lower index: a stable descending
    sort), and max-scatters their beyond-slice seeds. err is the spill
    count if more than SPILL_K lanes spilled."""
    L = tok_lm.shape[0]
    dev = tok_lm.device
    has_spill = (((tok_lm[:, S_SLICE:] >> 30) & 3) != 0).any(1)
    n_spill = has_spill.sum(dtype=_I32)
    score = torch.where(has_spill, torch.arange(L, dtype=_I32, device=dev),
                        torch.full((L,), -1, dtype=_I32, device=dev))
    vals, idxs = torch.sort(score, descending=True, stable=True)
    k = min(SPILL_K, L)
    vals, idxs = vals[:k], idxs[:k]
    rows = tok_lm[idxs]
    offr, seedr = _tok_attrs(rows, laneoff[idxs])
    sel = (seedr != 0) & (vals[:, None] >= 0)
    sel[:, :S_SLICE].fill_(False)           # fast slice already seeded
    tgt = torch.where(sel & (offr >= 0) & (offr < out_cap), offr,
                      torch.full_like(offr, out_cap)).long()
    S16 = torch.cat([S16_flat, torch.zeros(1, dtype=S16_flat.dtype,
                                           device=dev)])
    S16 = S16.scatter_reduce(0, tgt.reshape(-1),
                             seedr.reshape(-1).to(S16.dtype), "amax")
    err = torch.where(n_spill > SPILL_K, n_spill, torch.zeros_like(n_spill))
    return S16[:out_cap], err


def seed16_to_plan(S16: torch.Tensor) -> torch.Tensor:
    """Positioned 16-bit seeds -> plan packs (V_VALID/V_LIT/payload)."""
    v = S16 & 0xFFFF
    valid = v != 0
    is_lit = (v >= 0x8000) & (v <= 0x80FF)
    dm1 = torch.where(v == 0xFFFF, torch.full_like(v, 32767), v - 1)
    pay = torch.where(is_lit, v & 0xFF, dm1 & 0x7FFF)
    return torch.where(valid, V_VALID | torch.where(
        is_lit, torch.full_like(v, V_LIT), torch.zeros_like(v)) | pay,
        torch.zeros_like(v))


def resolve(P: torch.Tensor, halo: torch.Tensor, out_cap: int):
    """Resolve the plan to output bytes: csrc/expand5resolve.cu on a CUDA
    tensor, resolve_ref on a CPU tensor. Returns (out (out_cap,) u8, err).
    err is always 0, as in the reference (its resolve kernel's step returns
    err unchanged, jdeflate_tpu/ops/expand5.py:396-472); it is kept for the
    contract. On the card the kernel is a front end on the ordered-tile
    resolve (csrc/tile_resolve.cuh) over every SM; the map is scratch for
    the states its tiles publish, and P (16-byte aligned) is only read.
    Counts its kernel launches in resolve.launches."""
    zero = torch.zeros((), dtype=_I32, device=P.device)
    if P.device.type == "cpu":
        return resolve_ref(P, halo, out_cap), zero
    from . import _cuda
    dev = P.device
    _cuda.check_tensor(P, "P", _I32, dev, (out_cap,))
    _cuda.check_tensor(halo, "halo", torch.uint8, dev, (HALO,))
    fn = _cuda.entry("expand5resolve", "jd_expand5_resolve",
                     [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                      ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p])
    out = torch.empty(out_cap, dtype=torch.uint8, device=dev)
    srcmap, sync = _cuda.resolve_scratch(out_cap, dev)
    with torch.cuda.device(dev):
        rc = fn(P.data_ptr(), halo.data_ptr(), out.data_ptr(), out_cap,
                srcmap.data_ptr(), srcmap.numel(), sync.data_ptr(),
                sync.numel(), _cuda.stream_ptr())
    _cuda.check(rc, "expand5 resolve kernel launch")
    resolve.launches += 1
    return out, zero


resolve.launches = 0


def expand_tokens(tok_lm: torch.Tensor, outlen: torch.Tensor,
                  halo: torch.Tensor, out_cap: int, laneoff: torch.Tensor):
    """The v5 pipeline. Same contract as expand2.expand_tokens plus an error
    count (seed-window regions, spilled lanes, the resolve's 0; the caller
    falls back): returns (out (out_cap,) u8, produced, err). laneoff: (L,)
    i64 exclusive scan of outlen (ops/walk.py::walk_checked gives it)."""
    S16, off, seed16 = seed_plane(tok_lm, laneoff, out_cap)
    produced = outlen.sum(dtype=_I32)
    serr = seed_window_err(off, seed16, out_cap)
    S16f, sperr = spill_pass(tok_lm, laneoff, S16, out_cap)
    P = propagate(seed16_to_plan(S16f)).contiguous()
    out, rerr = resolve(P, halo, out_cap)
    return out, produced, serr + sperr + rerr
