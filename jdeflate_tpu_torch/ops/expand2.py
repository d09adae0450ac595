"""Token expansion: lane-major walk tokens -> output bytes.

Two implementations of one contract (the JAX package's ops/expand2.py):
  * expand_tokens_ref - plain PyTorch (token slots through
    decode.assemble_output), any device;
  * expand_tokens - the CUDA kernels of csrc/expand.cu on a CUDA tensor, the
    plain version on a CPU tensor.

On the card a place kernel writes each output position's collapsed source
(or literal byte) into a map, and the ordered-tile resolve shared with the
v1 and v5 engines grounds the map in 16 KiB tiles spread over every SM:
pointer doubling inside a tile, then pointers into earlier tiles followed
through the states those tiles publish, so no tile waits for another to
finish (see the notes in csrc/expand.cu and csrc/tile_resolve.cuh).
"""
from __future__ import annotations

import ctypes

import torch

from ..formats import constants as C
from . import _cuda
from . import decode as dk
from . import walk as wk

HALO = C.WINDOW_SIZE                  # 32768
TILE = _cuda.TILE                     # positions per resolve tile


def expand_tokens_ref(tok_lm: torch.Tensor, outlen: torch.Tensor,
                      halo: torch.Tensor, out_cap: int):
    """Plain expansion. Returns (out (out_cap,) u8, produced, err), err from
    assemble_output (tokens past the buffer, unresolved positions). outlen
    is not needed: the slots carry every length."""
    del outlen
    o_len, o_lit, o_dist = (x.reshape(-1) for x in wk.token_slots(tok_lm))
    return dk.assemble_output(o_len, o_lit, o_dist, halo, out_cap)


def expand_tokens(tok_lm: torch.Tensor, outlen: torch.Tensor,
                  halo: torch.Tensor, out_cap: int,
                  laneoff: torch.Tensor | None = None):
    """Expand lane-major tokens into output bytes.

    tok_lm: (L, S_SLOTS) i32 u32 bit patterns; the literal run lengths of
      walk.annotate_lit_runs are optional (a literal's byte is read from
      bits 0:8 only). outlen: (L,) i32 per-lane output bytes.
    halo: (HALO,) u8 history. laneoff: optional (L,) i64 exclusive cumsum of
      outlen (the caller's, so it is not computed twice).
    Returns (out (out_cap,) u8, produced, err): on CUDA err is produced >
    out_cap, as in the reference's kernel path, and nothing is read back to
    the host. Counts its kernel launches in expand_tokens.launches."""
    if tok_lm.device.type == "cpu":
        return expand_tokens_ref(tok_lm, outlen, halo, out_cap)
    dev = tok_lm.device
    L = tok_lm.shape[0]
    if laneoff is None:
        laneoff = torch.cumsum(outlen, 0, dtype=torch.int64) - outlen
    for name, t, dt, shape in (("tok_lm", tok_lm, torch.int32,
                                (L, wk.S_SLOTS)),
                               ("outlen", outlen, torch.int32, (L,)),
                               ("laneoff", laneoff, torch.int64, (L,)),
                               ("halo", halo, torch.uint8, (HALO,))):
        _cuda.check_tensor(t, name, dt, dev, shape)
    fn = _cuda.entry("expand", "jd_expand",
                     [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                      ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                      ctypes.c_int64, ctypes.c_void_p])
    buf = torch.empty(HALO + out_cap, dtype=torch.uint8, device=dev)
    buf[:HALO] = halo
    srcmap, sync = _cuda.resolve_scratch(out_cap, dev)
    produced = outlen.sum(dtype=torch.int64)
    with torch.cuda.device(dev):
        rc = fn(tok_lm.data_ptr(), laneoff.data_ptr(), L, srcmap.data_ptr(),
                srcmap.numel(), buf.data_ptr(), produced.data_ptr(), out_cap,
                sync.data_ptr(), sync.numel(), _cuda.stream_ptr())
    _cuda.check(rc, "expand kernel launch")
    expand_tokens.launches += 1
    return buf[HALO:], produced, (produced > out_cap).long()


expand_tokens.launches = 0
