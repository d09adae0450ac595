"""Token expansion: lane-major annotated walk tokens -> output bytes.

Two implementations of one contract (the JAX package's ops/expand2.py):
  * expand_tokens_ref - plain PyTorch (token slots through
    decode.assemble_output), any device;
  * expand_tokens - the CUDA kernel csrc/expand.cu on a CUDA tensor, the
    plain version on a CPU tensor.

The kernel is serial by design: one warp walks a batch's lanes in order,
because a match may read the bytes the token before it wrote (see the note
in csrc/expand.cu).
"""
from __future__ import annotations

import ctypes

import torch

from ..formats import constants as C
from . import decode as dk
from . import walk as wk

HALO = C.WINDOW_SIZE                  # 32768
LANE_MAX_OUT = wk.S_SLOTS * C.MAX_MATCH  # one lane's maximum output


def token_slots(tok_lm: torch.Tensor):
    """(L, S) tokens -> (len, lit, dist) per slot, each (L, S) (0 for an
    empty slot)."""
    kind = (tok_lm >> 30) & 3
    zero = torch.zeros_like(tok_lm)
    is_lit = kind == wk.TOK_LIT
    is_m = kind == wk.TOK_MATCH
    o_len = torch.where(is_lit, torch.ones_like(tok_lm),
                        torch.where(is_m, tok_lm & 0x1FF, zero))
    o_dist = torch.where(is_m, ((tok_lm >> 9) & 0x7FFF) + 1, zero)
    o_lit = torch.where(is_lit, tok_lm & 0xFF, zero)
    return o_len, o_lit, o_dist


def expand_tokens_ref(tok_lm: torch.Tensor, outlen: torch.Tensor,
                      halo: torch.Tensor, out_cap: int):
    """Plain expansion. Returns (out (out_cap,) u8, produced, err), err from
    assemble_output (tokens past the buffer, unresolved positions). outlen
    is not needed: the slots carry every length."""
    del outlen
    o_len, o_lit, o_dist = (x.reshape(-1) for x in token_slots(tok_lm))
    return dk.assemble_output(o_len, o_lit, o_dist, halo, out_cap)


def expand_tokens(tok_lm: torch.Tensor, outlen: torch.Tensor,
                  halo: torch.Tensor, out_cap: int):
    """Expand lane-major annotated tokens into output bytes.

    tok_lm: (L, S_SLOTS) i32 u32 bit patterns, run-annotated
      (walk.annotate_lit_runs). outlen: (L,) i32 per-lane output bytes.
    halo: (HALO,) u8 history. Returns (out (out_cap,) u8, produced, err):
    on CUDA err is produced > out_cap, as in the reference's kernel path.
    Counts its kernel launches in expand_tokens.launches."""
    if tok_lm.device.type == "cpu":
        return expand_tokens_ref(tok_lm, outlen, halo, out_cap)
    from . import _cuda
    dev = tok_lm.device
    L = tok_lm.shape[0]
    for name, t, dt, shape in (("tok_lm", tok_lm, torch.int32,
                                (L, wk.S_SLOTS)),
                               ("outlen", outlen, torch.int32, (L,)),
                               ("halo", halo, torch.uint8, (HALO,))):
        _cuda.check_tensor(t, name, dt, dev, shape)
    fn = _cuda.entry("expand", "jd_expand",
                     [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                      ctypes.c_int64, ctypes.c_void_p])
    buf_len = HALO + out_cap + LANE_MAX_OUT
    buf = torch.empty(buf_len, dtype=torch.uint8, device=dev)
    buf[:HALO] = halo
    with torch.cuda.device(dev):
        rc = fn(tok_lm.data_ptr(), L, buf.data_ptr(), buf_len,
                _cuda.stream_ptr())
    _cuda.check(rc, "expand kernel launch")
    expand_tokens.launches += 1
    produced = outlen.sum(dtype=torch.int64)
    return buf[HALO:HALO + out_cap], produced, (produced > out_cap).long()


expand_tokens.launches = 0
