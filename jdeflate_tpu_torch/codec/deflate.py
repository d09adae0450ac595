"""Block-parallel DEFLATE encoder on a CUDA device (or the CPU): port of
jdeflate_tpu/codec/deflate.py.

Each batch of fixed-size blocks runs: hash + sorted-bucket candidate probes
-> match extension -> local greedy/lazy decision -> the match walk (kernel
csrc/lz77walk.cu) -> per-chunk symbol frequencies -> entropy-DP block
splitting -> batched Huffman build -> precode RLE -> per-item (value, nbits)
-> one exclusive scan bit pack -> window anchors for the parallel decoder.
Every running max or min of these stages is ops/scan.py::running (kernel
csrc/rowscan.cu on a CUDA device).
Blocks inside a batch are bit-contiguous; batch seams are byte-aligned
sync-flush blocks (the reference's DEFLT_FLUSH framing,
src/deflator.c:609-654) padded to 4 bytes, which the decoder's 32-bit
window grid relies on.

Reference parity notes: block type by exact cost (flushblock,
src/deflator.c:1724-1805); dynamic header HLIT/HDIST/HCLEN, permuted precode
lengths and RLE'd trees (emittrees, src/deflator.c:1633-1722); RLE symbols
16/17/18 with the leave-3 remainder (countprecodes,
src/deflator.c:1287-1354).

Words are int64 tensors holding u32 values (PyTorch has no u32 shifts on
the CPU). The JAX package's one-hot matmul frequency counts and code
lookups were MXU workarounds; here they are bincount-style scatter-adds and
gathers on integers, which are exact.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import trace
from ..formats import constants as C
from ..ops import bitpack, huffman, lz77, scan, stamp
from ..utils import device as _device
from . import levels as levels_mod
from . import program

HALO = C.WINDOW_SIZE          # per-block history (previous block tail / dict)
PAD = 272                     # match-extension overread guard
RLE_SLOTS = 320               # >= 286+30 worst-case precode RLE symbols
HDR_ITEMS = 2 + 19 + RLE_SLOTS
_SENT = 19                    # run-breaking sentinel code length
CHUNK = 8192                  # splitter granularity (bytes of input)
_SPLIT_HDR_C0 = 120.0
_SPLIT_HDR_C1 = 5.5
# the card's clock stamps of a batch at the end of its meta (read_batch):
# the match program's first and last node, the coding program's first,
# the entropy stage's entry and exit, the coding program's last
STAMPS = 6

# Precode RLE extra-bit counts per symbol (16 -> 2, 17 -> 3, 18 -> 7).
_P_EXTRA = np.zeros(19, np.int64)
_P_EXTRA[16:19] = (2, 3, 7)

_I64 = torch.int64


def _nch(bl: int, chunk: int = CHUNK) -> int:
    """Chunks per block. Blocks smaller than 2 chunks never split."""
    return max(bl // chunk, 1)


def anchors_cap(bl: int, chunk: int = CHUNK) -> int:
    """Window-anchor slots per block: one per 32 stream bits at the
    worst-case compressed size, plus per-sub-block header slack."""
    return (9 * bl + 8192 + _nch(bl, chunk) * 4200) // 32 + 8


def words_bound(bl: int, batch: int, chunk: int = CHUNK) -> int:
    """Static output-word bound: <= 11 bits/byte plus per-sub-block header
    slack."""
    return (batch * (11 * bl + 8192 + _nch(bl, chunk) * 4200)) // 32 + 4


def _t(a, dev):
    return torch.as_tensor(np.asarray(a), dtype=_I64, device=dev)


# The constant tables live on each device once: a captured program cannot
# upload. Every user only reads them.
@functools.lru_cache(maxsize=None)
def _tables(dev: torch.device) -> dict:
    """The fixed code tables and extra-bit counts on `dev`."""
    NL, ND = C.NUM_LITLEN_USED, C.NUM_DIST_USED
    return {
        "lext_bits": _t(np.concatenate([np.zeros(257, np.int64),
                                        C.LENGTH_EXTRA]), dev),
        "dext_bits": _t(C.DIST_EXTRA, dev),
        "porder": _t(C.PRECODE_ORDER, dev),
        "pextra": _t(_P_EXTRA, dev),
        "fll": _t(C.FIXED_LITLEN_LENGTHS[:NL], dev),
        "flr": _t(C.FIXED_LITLEN_CODES_REV[:NL], dev),
        "fdr": _t(C.FIXED_DIST_CODES_REV[:ND], dev),
        "fdl": _t(C.FIXED_DIST_LENGTHS[:ND], dev),
    }


@functools.lru_cache(maxsize=None)
def _item_layout(nch: int, CS: int, dev: torch.device):
    """(owning chunk of each item, symbol-item mask) of the virtual item
    layout of nch chunks of stride CS, on `dev`: the eob slot of chunk c
    belongs to chunk c - 1, its header items to no symbol, its token items
    and the final EOB to symbols."""
    nitems = nch * CS + 1
    kind = np.zeros(nitems, np.int64)             # 0 hdr, 1 token, 2 eob
    sc_np = np.zeros(nitems, np.int64)            # owning chunk per item
    for c in range(nch):
        base = c * CS
        kind[base] = 2
        sc_np[base] = max(c - 1, 0)
        kind[base + 1 + HDR_ITEMS: base + CS] = 1
        sc_np[base + 1 + HDR_ITEMS: base + CS] = c
    kind[nitems - 1] = 2
    sc_np[nitems - 1] = nch - 1
    return (torch.as_tensor(sc_np, device=dev),
            torch.as_tensor(kind > 0, device=dev))


def _rle_emit(comb: torch.Tensor):
    """Per-position precode RLE symbols, computed positionally, over (G, n)
    combined code lengths. Semantics of the reference's sequential RLE with
    the leave-3 remainder (countprecodes, src/deflator.c:1287-1354).
    Returns (sym, extra, emit), each (G, n)."""
    G, n = comb.shape
    dev = comb.device
    idx = torch.arange(n, dtype=_I64, device=dev)[None, :].expand(G, n)
    prev = torch.cat([torch.full((G, 1), -1, dtype=_I64, device=dev),
                      comb[:, :-1]], 1)
    is_start = comb != prev
    BIG = 1 << 20
    startpos = scan.running(torch.where(is_start, idx, -1), "max")
    nxt_start = scan.running(torch.cat(
        [torch.where(is_start, idx, BIG)[:, 1:],
         torch.full((G, 1), n, dtype=_I64, device=dev)], 1), "min",
        reverse=True)
    r = nxt_start - startpos                   # whole-run length
    q = idx - startpos                         # offset within run
    v = comb
    live = v != _SENT

    # zero runs: K full 138-units, then m in [3,140]: one unit or (m-3, 3)
    K = torch.clamp((r - 3) // 138, min=0)
    m = r - 138 * K
    zb1 = 138 * K
    zb2 = zb1 + m - 3
    z_small = r < 3
    z_at_full = (q < zb1) & (q % 138 == 0)
    z_at_m = q == zb1
    z_at_3 = (m > 138) & (q == zb2)
    z_unit = torch.where(z_at_full, 138,
                         torch.where(z_at_m, torch.where(m > 138, m - 3, m),
                                     3))
    z_emit = z_small | z_at_full | z_at_m | z_at_3
    z_sym = torch.where(z_small, 0, torch.where(z_unit <= 10, 17, 18))
    z_extra = torch.where(z_sym == 17, z_unit - 3,
                          torch.where(z_sym == 18, z_unit - 11, 0))

    # nonzero runs: the literal, then 16-units of 6 (m-3 when 7/8 remain)
    m0 = r - 1
    qq = q - 1
    K6 = torch.clamp((m0 - 3) // 6, min=0)
    m6 = m0 - 6 * K6
    nb1 = 6 * K6
    nb2 = nb1 + m6 - 3
    n_small = m0 < 3
    n_at_full = (qq >= 0) & (qq < nb1) & (qq % 6 == 0)
    n_at_m = (qq == nb1) & (m0 >= 3)
    n_at_3 = (m6 > 6) & (qq == nb2) & (m0 >= 3)
    n_unit = torch.where(n_at_full, 6,
                         torch.where(n_at_m, torch.where(m6 > 6, m6 - 3, m6),
                                     3))
    n_emit = (q == 0) | (n_small & (qq >= 0)) | n_at_full | n_at_m | n_at_3
    n_is_rep = (q > 0) & ~n_small
    n_sym = torch.where(n_is_rep, 16, v)
    n_extra = torch.where(n_is_rep, n_unit - 3, 0)

    zero = v == 0
    sym = torch.where(zero, z_sym, n_sym)
    extra = torch.where(zero, z_extra, n_extra)
    emit = torch.where(zero, z_emit, n_emit) & live
    return torch.where(emit, sym, 0), torch.where(emit, extra, 0), emit


def _entropy_with_trees(dl, dd, lfreq, dfreq, live, fixed_codes: bool):
    """Header + emission tables + exact total cost for one candidate tree
    pair, over G groups. Returns ((hdr_lo, hdr_nb (G, HDR_ITEMS), el, er
    (G, 286), edl, edr (G, 30), eob_lo, eob_nb (G,)), dyn_cost (G,))."""
    G = dl.shape[0]
    dev = dl.device
    tab = _tables(dev)
    NL, ND = C.NUM_LITLEN_USED, C.NUM_DIST_USED
    _, dlr = huffman.canonical_codes(dl, C.MAX_CODE_BITS)
    _, ddr = huffman.canonical_codes(dd, C.MAX_CODE_BITS)
    lext_bits, dext_bits = tab["lext_bits"], tab["dext_bits"]

    symidx = torch.arange(NL, dtype=_I64, device=dev)[None, :]
    hlit = torch.clamp(torch.where(dl > 0, symidx + 1, 0).max(1).values,
                       min=257)
    didx = torch.arange(ND, dtype=_I64, device=dev)[None, :]
    hdist = torch.clamp(torch.where(dd > 0, didx + 1, 0).max(1).values, min=1)

    ncomb = NL + ND
    comb = torch.full((G, ncomb + ND), _SENT, dtype=_I64, device=dev)
    comb[:, :NL] = torch.where(symidx < hlit[:, None], dl, _SENT)
    comb.scatter_(1, hlit[:, None] + didx,
                  torch.where(didx < hdist[:, None], dd, _SENT))
    comb = comb[:, :ncomb]
    rle_sym, rle_extra, rle_emit = _rle_emit(comb)

    pfreq = torch.zeros((G, C.NUM_PRECODE), dtype=_I64, device=dev)
    pfreq.scatter_add_(1, rle_sym, rle_emit.to(_I64))
    pl = huffman.code_lengths_pm(pfreq, C.MAX_PRECODE_BITS)
    _, plr = huffman.canonical_codes(pl, C.MAX_PRECODE_BITS)
    pl_perm = pl[:, tab["porder"]]
    pidx = torch.arange(C.NUM_PRECODE, dtype=_I64, device=dev)[None, :]
    lastp = torch.where(pl_perm > 0, pidx + 1, 0).max(1).values
    hclen = torch.clamp(lastp, min=4) - 4

    pextra = tab["pextra"]
    pl_rs = pl.gather(1, rle_sym)
    pex_rs = pextra[rle_sym]

    # exact costs (flushblock decision, deflator.c:1752-1772)
    extra_cost = (lfreq * lext_bits).sum(1) + (dfreq * dext_bits).sum(1)
    hdr_cost = 14 + 3 * (hclen + 4) + torch.where(
        rle_emit, pl_rs + pex_rs, 0).sum(1)
    dyn_cost = ((lfreq * dl).sum(1) + (dfreq * dd).sum(1) + extra_cost
                + hdr_cost)
    fll = tab["fll"]
    stat_cost = (lfreq * fll).sum(1) + (dfreq * 5).sum(1) + extra_cost
    # DEFLT_FIXEDCODES analog (deflator.h:74-76): force the static trees
    use_dyn = (dyn_cost < stat_cost) & (not fixed_codes)
    ud = use_dyn[:, None]

    flr, fdr, fdl = tab["flr"], tab["fdr"], tab["fdl"]
    el = torch.where(ud, dl, fll)
    er = torch.where(ud, dlr, flr)
    edl = torch.where(ud, dd, fdl)
    edr = torch.where(ud, ddr, fdr)

    # ---- header items ----
    hdr_lo = torch.zeros((G, HDR_ITEMS), dtype=_I64, device=dev)
    hdr_nb = torch.zeros((G, HDR_ITEMS), dtype=_I64, device=dev)
    hdr_lo[:, 0] = torch.where(use_dyn, 2, 1) << 1   # BFINAL or'd in later
    hdr_nb[:, 0] = torch.where(live, 3, 0)
    dynhdr = (hlit - 257) | ((hdist - 1) << 5) | (hclen << 10)
    hdr_lo[:, 1] = torch.where(use_dyn, dynhdr, 0)
    hdr_nb[:, 1] = torch.where(live & use_dyn, 14, 0)
    pc_n = torch.where((live & use_dyn)[:, None] & (pidx < hclen[:, None] + 4),
                       3, 0)
    hdr_lo[:, 2:21] = torch.where(pc_n > 0, pl_perm, 0)
    hdr_nb[:, 2:21] = pc_n
    rle_n = torch.where((live & use_dyn)[:, None] & rle_emit, pl_rs + pex_rs,
                        0)
    rle_v = (plr.gather(1, rle_sym) | (rle_extra << pl_rs)) & bitpack.M32
    hdr_lo[:, 21:21 + ncomb] = torch.where(rle_n > 0, rle_v, 0)
    hdr_nb[:, 21:21 + ncomb] = rle_n

    eob_lo = torch.where(live, er[:, C.EOB], 0)
    eob_nb = torch.where(live, el[:, C.EOB], 0)
    return (hdr_lo, hdr_nb, el, er, edl, edr, eob_lo, eob_nb), dyn_cost


def _block_entropy(lfreq, dfreq, live, cfg: levels_mod.LevelConfig,
                   fixed_codes: bool = False):
    """Per-sub-block entropy stage over G groups: dynamic trees, precode
    RLE, header items, exact static-vs-dynamic decision. At levels 8-9
    (tree_both) the package-merge and two-queue trees are both costed end
    to end and the cheaper wins per group."""
    out1, cost1 = _entropy_with_trees(
        huffman.code_lengths_pm(lfreq, C.MAX_CODE_BITS),
        huffman.code_lengths_pm(dfreq, C.MAX_CODE_BITS),
        lfreq, dfreq, live, fixed_codes)
    if not cfg.tree_both:
        return out1
    out2, cost2 = _entropy_with_trees(
        huffman.code_lengths(lfreq, C.MAX_CODE_BITS),
        huffman.code_lengths(dfreq, C.MAX_CODE_BITS),
        lfreq, dfreq, live, fixed_codes)
    pick1 = cost1 <= cost2
    return tuple(torch.where(pick1.view(-1, *([1] * (a.dim() - 1))), a, b)
                 for a, b in zip(out1, out2))


def _split_dp(Pl, Pd, nch: int, c0=_SPLIT_HDR_C0, c1=_SPLIT_HDR_C1):
    """Optimal contiguous chunk partition per block.

    Pl: (B, nch+1, NL) prefix histograms, Pd likewise for distances.
    Minimises the sum over groups of entropy(merged histogram) + estimated
    dynamic-header bits, in float32 as the reference does. Returns (B, nch)
    bool group-start flags (flag 0 always set)."""
    B = Pl.shape[0]
    dev = Pl.device
    hl = Pl[:, None, :, :] - Pl[:, :, None, :]   # [b, i, j] = P[j] - P[i]
    hd = Pd[:, None, :, :] - Pd[:, :, None, :]

    def ent(h):
        tot = h.sum(-1, keepdim=True).to(torch.float32)
        hf = h.to(torch.float32)
        return torch.where(
            h > 0, hf * (torch.log2(torch.clamp(tot, min=1.0))
                         - torch.log2(torch.clamp(hf, min=1.0))),
            torch.zeros_like(hf)).sum(-1)

    distinct = ((hl > 0).sum(-1) + (hd > 0).sum(-1)).to(torch.float32)
    cost = (ent(hl) + ent(hd) + np.float32(c0)
            + np.float32(c1) * distinct)                # (B, i, j)

    INF = 3e18
    best = torch.full((B, nch + 1), INF, dtype=torch.float32, device=dev)
    best[:, 0].fill_(0.0)
    arg = torch.zeros((B, nch + 1), dtype=_I64, device=dev)
    iidx = torch.arange(nch + 1, dtype=_I64, device=dev)[None, :]
    for j in range(1, nch + 1):
        cand = torch.where(iidx < j, best + cost[:, :, j],
                           torch.full_like(best, INF))
        arg[:, j] = torch.argmin(cand, 1)
        best[:, j] = cand.min(1).values

    start = torch.zeros((B, nch), dtype=torch.bool, device=dev)
    j = torch.full((B,), nch, dtype=_I64, device=dev)
    for _ in range(nch):                        # backtrack, <= nch hops
        a = arg.gather(1, j[:, None])[:, 0]
        hop = j > 0
        idx = torch.clamp(a, 0, nch - 1)[:, None]
        start.scatter_(1, idx, start.gather(1, idx) | hop[:, None])
        j = torch.where(hop, a, 0)
    start[:, 0].fill_(True)
    return start


def _batch_rows(data: torch.Tensor, start_block, total_len, dict_len,
                final_block, bl: int, batch: int):
    """(block_len, valid_from, bfinal, ext) of one batch: each block's live
    length, the first byte of its row that holds history, its BFINAL flag
    (int64), and its row of `data` (HALO history + the block + PAD), (batch,
    HALO + bl + PAD) u8."""
    dev = data.device
    bidx = start_block + torch.arange(batch, dtype=_I64, device=dev)
    starts = bidx * bl
    block_len = torch.clamp(total_len - starts, 0, bl)
    avail = torch.clamp(starts + dict_len, max=HALO)
    valid_from = HALO - avail
    bfinal = (bidx == final_block).to(_I64)

    # one slice per block; starts clamp into the buffer as dynamic_slice does
    rowlen = HALO + bl + PAD
    s0 = torch.clamp(starts, 0, data.shape[0] - rowlen)
    ext = data[s0[:, None] + torch.arange(rowlen, dtype=_I64,
                                          device=dev)[None, :]]
    return block_len, valid_from, bfinal, ext


def match_batch(data: torch.Tensor, start_block, total_len, dict_len,
                final_block, bl: int, batch: int, level: int):
    """The match stage of encode_batch: the best match per position of each
    block, (length, dist), (batch, bl) int64 (ops/lz77.py
    find_matches_batch at the level's probe depth)."""
    cfg = levels_mod.get_level(level)
    block_len, valid_from, _, ext = _batch_rows(
        data, start_block, total_len, dict_len, final_block, bl, batch)
    return lz77.find_matches_batch(
        ext, block_len, valid_from, HALO, bl, PAD, max(cfg.probes, 1),
        ext_top=cfg.ext_top, ext_rounds=cfg.ext_rounds, rescue=cfg.rescue,
        probe_words=cfg.probe_words, ext_mdiv=cfg.ext_mdiv)


def encode_batch(data: torch.Tensor, start_block: int, total_len: int,
                 dict_len: int, final_block: int, bl: int, batch: int,
                 level: int, num_words: int, fixed_codes: bool = False,
                 stage: str = ""):
    """Encode `batch` consecutive blocks of `data` into one bit-contiguous
    DEFLATE fragment (each block adaptively split into sub-blocks); the
    port of the JAX package's encode_batch_impl: match_batch, then
    code_batch on its result.

    data: (HALO + N_padded + PAD,) u8 on the encode device: input with a
      HALO-byte history prefix (zeros or preset dictionary) and PAD zeros.
    start_block, total_len, dict_len, final_block: ints, or 0-d int64
      tensors on data's device, as the reference's traced scalars
      (final_block gets BFINAL); the captured programs pass tensors, so
      that no batch's values are baked into them.
    stage: when set, return that stage's intermediate values ("match",
      "walk", "freqs", "split", "entropy", "codes", "items", "stored",
      "pack", "offsets"), as the reference does.

    Returns (words (num_words,) int64 u32 values, total_bits, block_bits
    (batch,), ntok, start_flags (batch, nch), hdr_off (batch, nch), gwin
    (batch, nch), wanch (batch, A_BLK), use_stored (batch,)), on the device.
    """
    length, dist = match_batch(data, start_block, total_len, dict_len,
                               final_block, bl, batch, level)
    if stage == "match":
        return length, dist
    return code_batch(data, start_block, total_len, dict_len, final_block,
                      length, dist, bl, batch, level, num_words, fixed_codes,
                      stage)


def code_batch(data: torch.Tensor, start_block, total_len, dict_len,
               final_block, length: torch.Tensor, dist: torch.Tensor,
               bl: int, batch: int, level: int, num_words: int,
               fixed_codes: bool = False, stage: str = "", stamps=None):
    """The coding stages of encode_batch, from match_batch's (length, dist)
    of the same batch: the parse, the match walk, frequencies, the split,
    the trees, the pack and the window anchors. Arguments and result as
    encode_batch's (stage from "walk" on). stamps: a (STAMPS,) int64
    tensor whose slots 3 and 4 get the card's clock as the entropy stage
    (the groups, their frequencies and _block_entropy) starts and ends
    (ops/stamp.py); none where None or on the CPU."""
    cfg = levels_mod.get_level(level)
    dev = data.device
    nch = _nch(bl, cfg.chunk)
    CH = bl // nch
    CS = 1 + HDR_ITEMS + CH       # virtual per-position stride (anchors)
    CHP = CH // 2                 # token slots pair-combined for pack()
    CSP = 1 + HDR_ITEMS + CHP     # packed chunk stride
    nitems = nch * CS + 1
    nitemsp = nch * CSP + 1
    NL = C.NUM_LITLEN_USED
    ND = C.NUM_DIST_USED
    B = batch
    M32 = bitpack.M32

    def ar(n):
        return torch.arange(n, dtype=_I64, device=dev)

    block_len, _, bfinal, ext = _batch_rows(
        data, start_block, total_len, dict_len, final_block, bl, batch)

    take = lz77.parse_take(length, dist, block_len, cfg.lazy,
                           cfg.good_length)
    # the sequential parse via the match walk (kernel on a CUDA device)
    is_tok, t_take = lz77.token_marks_batch(length, take, block_len, bl)
    if stage == "walk":
        return is_tok, t_take
    t_len = torch.where(t_take, length, 0)
    t_dist = torch.where(t_take, dist, 0)
    t_lit = ext[:, HALO:HALO + bl].to(_I64)

    # arithmetic symbol mapping: length n = len-3; sym = 257+n (n<8) else
    # 265 + 4*(log2(n)-3) + ((n>>(log2(n)-2)) & 3); len 258 -> 285
    n_ = torch.clamp(t_len - 3, min=0)
    l2n = lz77._floor_log2(torch.clamp(n_, min=1))
    lsym_m = torch.where(
        n_ < 8, 257 + n_,
        265 + ((l2n - 3) << 2) + ((n_ >> torch.clamp(l2n - 2, min=0)) & 3))
    lsym_m = torch.where(t_len == 258, 285, lsym_m)
    lextra_bits = torch.where((n_ < 8) | (t_len == 258), 0, l2n - 2)
    lextra = n_ & ((1 << torch.clamp(lextra_bits, min=0)) - 1)
    # dist m = d-1; sym = m (m<4) else 2*log2(m) + ((m>>(log2(m)-1)) & 1)
    m_ = torch.clamp(t_dist - 1, min=0)
    l2m = lz77._floor_log2(torch.clamp(m_, min=1))
    dsym = torch.where(m_ < 4, m_,
                       (l2m << 1) + ((m_ >> torch.clamp(l2m - 1, min=0)) & 1))
    dextra_bits = torch.where(m_ < 4, 0, l2m - 1)
    dextra = m_ & ((1 << torch.clamp(dextra_bits, min=0)) - 1)
    lsym = torch.where(t_take, lsym_m, t_lit)

    # ---- per-chunk frequencies ----
    ls_c = lsym.reshape(B * nch, CH)
    lfreq_c = torch.zeros((B * nch, NL), dtype=_I64, device=dev)
    lfreq_c.scatter_add_(1, ls_c, is_tok.reshape(B * nch, CH).to(_I64))
    lfreq_c = lfreq_c.reshape(B, nch, NL)
    ds_c = dsym.reshape(B * nch, CH)
    dfreq_c = torch.zeros((B * nch, ND), dtype=_I64, device=dev)
    dfreq_c.scatter_add_(1, ds_c, (t_take & is_tok).reshape(B * nch, CH).to(
        _I64))
    dfreq_c = dfreq_c.reshape(B, nch, ND)
    if stage == "freqs":
        return lfreq_c, dfreq_c

    # ---- adaptive split (entropy DP over chunk histograms) ----
    Pl = torch.cat([torch.zeros((B, 1, NL), dtype=_I64, device=dev),
                    torch.cumsum(lfreq_c, 1)], 1)
    Pd = torch.cat([torch.zeros((B, 1, ND), dtype=_I64, device=dev),
                    torch.cumsum(dfreq_c, 1)], 1)
    ci = ar(nch)[None, :]
    if nch > 1 and cfg.level >= 1:
        start_f = _split_dp(Pl, Pd, nch, cfg.split_c0, cfg.split_c1)
    else:
        start_f = torch.zeros((B, nch), dtype=torch.bool, device=dev)
        start_f[:, 0].fill_(True)
    if stage == "split":
        return start_f
    stamp.stamp(stamps, 3)

    # group-of-chunk, and the end chunk (exclusive) of each start's group
    gs = scan.running(torch.where(start_f, ci, 0), "max")
    srt = torch.where(start_f, ci, nch)
    nxt = scan.running(torch.cat([srt[:, 1:], torch.full(
        (B, 1), nch, dtype=_I64, device=dev)], 1), "min", reverse=True)

    def gsel(P, idx):
        return P.gather(1, idx[:, :, None].expand(-1, -1, P.shape[2]))
    cib = ci.expand(B, nch)
    lfreq_g = gsel(Pl, nxt) - gsel(Pl, cib)
    dfreq_g = gsel(Pd, nxt) - gsel(Pd, cib)
    live_g = start_f & (ci * CH < block_len[:, None])
    lfreq_g[:, :, C.EOB] += live_g.to(_I64)

    hdr_lo, hdr_nb, el, er, edl, edr, eob_lo, eob_nb = _block_entropy(
        lfreq_g.reshape(B * nch, NL), dfreq_g.reshape(B * nch, ND),
        live_g.reshape(B * nch), cfg, fixed_codes)
    stamp.stamp(stamps, 4)
    if stage == "entropy":
        return hdr_lo, hdr_nb, el, er, edl, edr
    hdr_lo = hdr_lo.reshape(B, nch, HDR_ITEMS)
    hdr_nb = hdr_nb.reshape(B, nch, HDR_ITEMS)

    # BFINAL on the last live sub-block of the stream's final block
    lastc = torch.where(live_g, ci, -1).max(1).values
    fin_mask = (bfinal[:, None] > 0) & (ci == lastc[:, None]) & live_g
    hdr_lo[:, :, 0] |= fin_mask.to(_I64)

    # broadcast each group's tables to its member chunks
    def bcast(x, n):
        return x.reshape(B, nch, n).gather(1, gs[:, :, None].expand(-1, -1, n))
    el_a, er_a = bcast(el, NL), bcast(er, NL)
    edl_a, edr_a = bcast(edl, ND), bcast(edr, ND)
    eob_lo_a = eob_lo.reshape(B, nch).gather(1, gs)
    eob_nb_a = eob_nb.reshape(B, nch).gather(1, gs)
    live_a = live_g.gather(1, gs)

    # two packed code lookups per position: litlen (code<<4|len) and dist
    lpack = ((er_a << 4) | el_a).reshape(B * nch, NL)
    dpack = ((edr_a << 4) | edl_a).reshape(B * nch, ND)
    le = lpack.gather(1, ls_c).reshape(B, bl)
    de = dpack.gather(1, ds_c).reshape(B, bl)
    lcode, llen = le >> 4, le & 15
    dcode, dlen = de >> 4, de & 15
    if stage == "codes":
        return le, de

    # literal: lcode/llen alone; match: lcode+lextra+dcode+dextra
    m_lo, m_hi, m_n = bitpack.append_bits(
        lcode, torch.zeros_like(lcode), llen, lextra, lextra_bits)
    m_lo, m_hi, m_n = bitpack.append_bits(m_lo, m_hi, m_n, dcode, dlen)
    m_lo, m_hi, m_n = bitpack.append_bits(m_lo, m_hi, m_n, dextra,
                                          dextra_bits)
    tv_lo = torch.where(t_take, m_lo, lcode)
    tv_hi = torch.where(t_take, m_hi, 0)
    tv_n = torch.where(is_tok, torch.where(t_take, m_n, llen), 0)

    # ---- pair-combine adjacent token slots (any pair <= 63 bits) ----
    tvm_lo = torch.where(tv_n > 0, tv_lo, 0)
    tvm_hi = torch.where(tv_n > 0, tv_hi, 0)
    tvp_lo, tvp_hi, tvp_n = bitpack.combine64(
        tvm_lo[:, 0::2], tvm_hi[:, 0::2], tv_n[:, 0::2],
        tvm_lo[:, 1::2], tvm_hi[:, 1::2], tv_n[:, 1::2])

    # ---- item assembly: (B, nch, CSP) = [eob slot | header | CH/2 pairs] ----
    ch_lo = torch.zeros((B, nch, CSP), dtype=_I64, device=dev)
    ch_hi = torch.zeros((B, nch, CSP), dtype=_I64, device=dev)
    ch_nb = torch.zeros((B, nch, CSP), dtype=_I64, device=dev)
    z1 = torch.zeros((B, 1), dtype=_I64, device=dev)
    # eob slot c: previous group's EOB, emitted where a new group starts
    prev_eob_lo = torch.cat([z1, eob_lo_a[:, :-1]], 1)
    prev_eob_nb = torch.cat([z1, eob_nb_a[:, :-1]], 1)
    prev_live = torch.cat([z1.bool(), live_a[:, :-1]], 1)
    eob_emit = start_f & prev_live & (ci > 0)
    ch_lo[:, :, 0] = torch.where(eob_emit, prev_eob_lo, 0)
    ch_nb[:, :, 0] = torch.where(eob_emit, prev_eob_nb, 0)
    ch_lo[:, :, 1:1 + HDR_ITEMS] = hdr_lo
    ch_nb[:, :, 1:1 + HDR_ITEMS] = hdr_nb
    ch_lo[:, :, 1 + HDR_ITEMS:] = tvp_lo.reshape(B, nch, CHP)
    ch_hi[:, :, 1 + HDR_ITEMS:] = tvp_hi.reshape(B, nch, CHP)
    ch_nb[:, :, 1 + HDR_ITEMS:] = tvp_n.reshape(B, nch, CHP)
    # final slot: last group's EOB
    fin_lo = torch.where(live_a[:, -1], eob_lo_a[:, -1], 0)
    fin_nb = torch.where(live_a[:, -1], eob_nb_a[:, -1], 0)
    lo = torch.cat([ch_lo.reshape(B, nch * CSP), fin_lo[:, None]], 1)
    hi = torch.cat([ch_hi.reshape(B, nch * CSP), z1], 1)
    nb = torch.cat([ch_nb.reshape(B, nch * CSP), fin_nb[:, None]], 1)
    ntok = is_tok.sum()
    if stage == "items":
        return lo, hi, nb

    # ---- stored-block fallback (compress0 semantics, deflator.c:796-926) --
    # a stored block costs 3 hdr bits + pad-to-byte + 32 LEN/NLEN bits + 8n,
    # split in two when n exceeds the 16-bit LEN field; the pad depends on
    # the block's starting bit offset mod 8, so an 8-state scan over the
    # batch decides stored-vs-compressed
    comp_bits = nb.sum(1)
    split = 32768
    len1 = torch.clamp(block_len, max=split)
    len2 = block_len - len1
    s = torch.zeros((), dtype=_I64, device=dev)
    us_l, pad_l, bits_l = [], [], []
    for i in range(B):
        n, n2, cb = block_len[i], len2[i], comp_bits[i]
        pad = (8 - ((s + 3) & 7)) & 7
        stored = torch.where(n > 0, 3 + pad + 32 + 8 * n
                             + torch.where(n2 > 0, 40, 0), 0)
        use = (n > 0) & ((cfg.level == 0) | (stored < cb))
        bits = torch.where(use, stored, cb)
        s = (s + bits) & 7
        us_l.append(use)
        pad_l.append(pad)
        bits_l.append(bits)
    use_stored = torch.stack(us_l)
    pad_bits = torch.stack(pad_l)
    if cfg.level == 0:
        use_stored = block_len > 0

    lennlen1 = (len1 | ((len1 ^ 0xFFFF) << 16)) & M32
    lennlen2 = (len2 | ((len2 ^ 0xFFFF) << 16)) & M32
    has2 = len2 > 0
    s_lo = torch.zeros((B, nch, CSP), dtype=_I64, device=dev)
    s_hi = torch.zeros((B, nch, CSP), dtype=_I64, device=dev)
    s_nb = torch.zeros((B, nch, CSP), dtype=_I64, device=dev)
    s_lo[:, 0, 1] = torch.where(has2, 0, bfinal)
    s_nb[:, 0, 1] = torch.where(block_len > 0, 3, 0)
    zb = torch.zeros_like(lennlen1)
    p_lo, p_hi, p_n = bitpack.append_bits(zb, zb, pad_bits, lennlen1,
                                          torch.full_like(zb, 32))
    s_lo[:, 0, 2] = p_lo
    s_hi[:, 0, 2] = p_hi
    s_nb[:, 0, 2] = torch.where(block_len > 0, p_n, 0)
    # second stored header at the 32 KiB boundary chunk's eob slot
    if bl > split:
        c2 = split // CH
        s_lo[:, c2, 0] = (bfinal | (lennlen2 << 8)) & M32
        s_hi[:, c2, 0] = lennlen2 >> 24
        s_nb[:, c2, 0] = torch.where(has2, 40, 0)
    pos = ar(bl)[None, :]
    live_b = pos < block_len[:, None]
    blk_bytes = torch.where(live_b, t_lit, 0)
    s_lo[:, :, 1 + HDR_ITEMS:] = (blk_bytes[:, 0::2]
                                  | (blk_bytes[:, 1::2] << 8)).reshape(
                                      B, nch, CHP)
    s_nb[:, :, 1 + HDR_ITEMS:] = (8 * (live_b[:, 0::2].to(_I64)
                                       + live_b[:, 1::2].to(_I64))).reshape(
                                           B, nch, CHP)
    sel = use_stored[:, None]
    lo = torch.where(sel, torch.cat([s_lo.reshape(B, nch * CSP), z1], 1), lo)
    hi = torch.where(sel, torch.cat([s_hi.reshape(B, nch * CSP), z1], 1), hi)
    nb = torch.where(sel, torch.cat([s_nb.reshape(B, nch * CSP), z1], 1), nb)
    if stage == "stored":
        return lo, hi, nb

    words, offs, total = bitpack.pack(lo.reshape(-1), hi.reshape(-1),
                                      nb.reshape(-1), num_words)
    if stage == "pack":
        return words, total
    per_block_bits = nb.sum(1)
    offs2p = offs.reshape(B, nitemsp)

    # per-chunk header bit offsets (index entries for parallel decode)
    hdr_off = offs2p[:, ci[0] * CSP + 1]

    # per-POSITION offsets/widths in the virtual (unpaired) layout for the
    # window-anchor scan: the odd position of a pair sits n_even bits after
    # the pair's offset
    nb_pos = torch.where(use_stored[:, None], torch.where(live_b, 8, 0), tv_n)
    off3 = offs2p[:, :nitemsp - 1].reshape(B, nch, CSP)
    tok_off_p = off3[:, :, 1 + HDR_ITEMS:]
    n_even = nb_pos[:, 0::2].reshape(B, nch, CHP)
    tok_off = torch.stack([tok_off_p, tok_off_p + n_even], -1).reshape(
        B, nch, CH)
    offs2 = torch.cat([torch.cat([off3[:, :, :1 + HDR_ITEMS], tok_off],
                                 2).reshape(B, nch * CS), offs2p[:, -1:]], 1)
    nb3 = nb[:, :nitemsp - 1].reshape(B, nch, CSP)
    nbv = torch.cat([torch.cat([nb3[:, :, :1 + HDR_ITEMS],
                                nb_pos.reshape(B, nch, CH)],
                               2).reshape(B, nch * CS), nb[:, -1:]], 1)
    if stage == "offsets":
        return offs2, nbv

    # ---- window anchors for the parallel walk ----
    # The stream is cut on a 32-bit word grid anchored at each group's first
    # symbol bit (& ~31); for every window, the bit offset of the first
    # symbol starting in it is the decode lane's entry point
    sc, is_sym = _item_layout(nch, CS, dev)
    sym_mask = (nbv > 0) & is_sym[None, :]
    gso = offs2.gather(1, gs * CS + 1 + HDR_ITEMS)     # group sym-start
    gsc = gs[:, sc]                               # (B, nitems) owning group
    org_it = gso[:, sc] & ~31
    wid = (offs2 - org_it) >> 5                   # window id within group
    # gwin[b, g] = max window id + 1 over the group's symbol items: a
    # per-chunk max (eob slots belong to the previous chunk), then folded
    # into groups
    wv = torch.where(sym_mask, wid + 1, 0)
    wv3 = wv[:, :nitems - 1].reshape(B, nch, CS)
    cmax = wv3[:, :, 1:].max(2).values
    eobv = wv3[:, :, 0]
    cmax = torch.cat([torch.maximum(cmax[:, :-1], eobv[:, 1:]),
                      cmax[:, -1:]], 1)
    cmax[:, nch - 1] = torch.maximum(cmax[:, nch - 1], wv[:, -1])
    own = gs[:, :, None] == ci[0][None, None, :]  # (B, chunk, group)
    gwin = torch.where(own, cmax[:, :, None], 0).max(1).values
    gbase = torch.cumsum(gwin, 1) - gwin
    aidx = gbase.gather(1, gsc) + wid
    A_BLK = anchors_cap(bl, cfg.chunk)
    BIGA = 1 << 30
    # anchor a = offset of the FIRST symbol item in window a: first-in-window
    # items are where aidx rises past every earlier symbol's; the scatter-min
    # needs no sorted-index assumption
    lsa = scan.running(torch.where(sym_mask, aidx, -1), "max")
    lsa_prev = torch.cat([torch.full((B, 1), -1, dtype=_I64, device=dev),
                          lsa[:, :-1]], 1)
    fw = sym_mask & (aidx > lsa_prev) & (aidx >= 0) & (aidx < A_BLK)
    wanch = torch.full((B, A_BLK + 1), BIGA, dtype=_I64, device=dev)
    wanch.scatter_reduce_(1, torch.where(fw, aidx, A_BLK),
                          torch.where(fw, offs2, BIGA), reduce="amin")
    return (words, total, per_block_bits, ntok, start_f, hdr_off, gwin,
            wanch[:, :A_BLK], use_stored)


def index_entries_from_meta(bl: int, batch: int, startf, hdr_off, gwin,
                            wanch, stored_h, nblocks: int, n_total: int,
                            base_bits: int, base_byte: int,
                            chunk: int = CHUNK):
    """Parallel-decode index entries (bits, bytes, window anchors) from one
    batch's host-side meta, one entry per emitted sub-block. A window value
    >= 2^30 (no symbol starts in it) becomes -1."""
    nch = _nch(bl, chunk)
    CH = bl // nch
    index_bits, index_bytes, win_out = [], [], []
    BIGA = 1 << 30
    for i in range(min(batch, nblocks)):
        blk_byte0 = base_byte + i * bl
        if stored_h[i]:
            index_bits.append(base_bits + int(hdr_off[i, 0]))
            index_bytes.append(blk_byte0)
            win_out.append(None)
            continue
        cs_list = [c for c in range(nch)
                   if startf[i, c] and blk_byte0 + c * CH < n_total]
        gbase = {}
        acc = 0
        for c in range(nch):
            gbase[c] = acc
            acc += int(gwin[i, c])
        for c in cs_list:
            nw = int(gwin[i, c])
            a = wanch[i, gbase[c]:gbase[c] + nw].astype(np.int64)
            a = np.where(a >= BIGA, np.int64(-1), a + base_bits)
            index_bits.append(base_bits + int(hdr_off[i, c]))
            index_bytes.append(blk_byte0 + c * CH)
            win_out.append(a)
    return index_bits, index_bytes, win_out


def batch_handle(res, stamps=None):
    """What the host reads of one encode_batch result: (words, meta,
    wanch), with the small per-block meta (total bits, stored flags, start
    flags, header offsets, window counts) and the batch's STAMPS clock
    stamps (zeros where `stamps` is None) in one device tensor, so a
    readback moves it at once."""
    words, total, _, _, start_f, hdr_off, gwin, wanch, stored = res
    if stamps is None:
        stamps = torch.zeros(STAMPS, dtype=_I64, device=words.device)
    meta = torch.cat([total.reshape(1), stored.to(_I64),
                      start_f.reshape(-1).to(_I64), hdr_off.reshape(-1),
                      gwin.reshape(-1), stamps])
    return words, meta, wanch


def unstamped(handle):
    """A batch_handle without the clock stamps at the end of its meta: what
    two runs of one batch give alike."""
    words, meta, wanch = handle
    return words, meta[:-STAMPS], wanch


def _match_handle(data, scalars, bl: int, batch: int, level: int):
    """match_batch(...) with the per-batch scalars (start_block, total_len,
    dict_len, final_block) read from `scalars`, a (4,) int64 tensor on
    data's device: the match stage's captured program per shape. Returns
    (length, dist, stamps): on a card the program's first and last node
    stamp the card's clock into slots 0 and 1 of stamps, a (STAMPS,) int64
    tensor (ops/stamp.py); on the CPU it is zeros."""
    stamps = stamp.slots(STAMPS, data.device)
    stamp.stamp(stamps, 0)
    length, dist = match_batch(data, *scalars.unbind(), bl, batch, level)
    stamp.stamp(stamps, 1)
    return length, dist, stamps


def _code_handle(data, scalars, length, dist, stamps, bl: int, batch: int,
                 level: int, num_words: int, fixed_codes: bool):
    """batch_handle(code_batch(...)), scalars as in _match_handle, on its
    (length, dist, stamps): the coding stages' captured program per shape.
    On a card its first node stamps slot 2, the entropy stage slots 3 and
    4, and its last node the last slot of meta."""
    stamp.stamp(stamps, 2)
    words, meta, wanch = batch_handle(code_batch(
        data, *scalars.unbind(), length, dist, bl, batch, level, num_words,
        fixed_codes, stamps=stamps), stamps)
    stamp.stamp(meta, meta.shape[0] - 1)
    return words, meta, wanch


def launch_batch(data, start_block: int, total_len: int, dict_len: int,
                 final_block: int, bl: int, batch: int, level: int,
                 num_words: int, fixed_codes: bool = False):
    """Launch one batch's encode_batch on data's device and return its
    batch_handle (words, meta, wanch); nothing is read back. On a card the
    encode is two replayed programs of its shape (codec/program.py), the
    match stage, then the coding stages on its (length, dist, stamps), on
    the caller's stream; the four scalars travel as one small upload that
    does not synchronise, and the open request counts encode.match_kernel
    by the probe kernel's launches in the match stage, encode.ext_kernel
    by the exact extension kernel's there, encode.tree_kernel by the
    two-queue kernel's and encode.scan_kernel by the running scan
    kernel's in the coding stages (program.launched: on a replay those its
    capture recorded). The two programs stamp the card's clock into the
    end of meta (_match_handle, _code_handle), which read_batch reads."""
    dev = data.device
    sc = _device.upload(np.array([start_block, total_len, dict_len,
                                  final_block], np.int64), dev)
    length, dist, stamps = program.run(_match_handle, (data, sc),
                                       (bl, batch, level))
    probes = program.launched(lz77.match_probe)
    if probes:
        trace.count("encode.match_kernel", probes)
    exts = program.launched(lz77.extend_top)
    if exts:
        trace.count("encode.ext_kernel", exts)
    handle = program.run(_code_handle, (data, sc, length, dist, stamps),
                         (bl, batch, level, num_words, fixed_codes))
    trees = program.launched(huffman.code_lengths)
    if trees:
        trace.count("encode.tree_kernel", trees)
    scans = program.launched(scan.running)
    if scans:
        trace.count("encode.scan_kernel", scans)
    return handle


def _count_stages(s) -> None:
    """A batch's device times from its clock stamps `s` (the last STAMPS
    values of its meta, ns) into the open request: encode.match_ns, the
    match program from its first node to its last; encode.launch_wait_ns,
    from there to the coding program's first node (the match program's
    output clones, the coding program's input copies, and the card's wait
    for the host to launch it); encode.code_ns, the coding program from
    its first node to its last; encode.entropy_ns, the entropy stage
    inside it."""
    s = [int(v) for v in s]
    trace.count("encode.match_ns", s[1] - s[0])
    trace.count("encode.launch_wait_ns", s[2] - s[1])
    trace.count("encode.code_ns", s[5] - s[2])
    trace.count("encode.entropy_ns", s[4] - s[3])


def read_batch(handle, batch: int, nch: int):
    """Read one launch_batch handle back: (total bits, the word bytes
    covering them, stored flags, start flags, header offsets, window
    counts, window anchors). Only the produced words and the used prefix
    of each block's anchor row move. Words are u32 values in int64, so
    they are narrowed to little-endian u32 before the bytes are taken. On
    a card the batch's stage times, from the stamps that came back with
    its meta, join the open request's counters (_count_stages)."""
    words, meta_dev, wanch_dev = handle
    m = _device.to_host(meta_dev)
    if meta_dev.is_cuda:
        _count_stages(m[-STAMPS:])
    total = int(m[0])
    o = 1
    stored_h = m[o:o + batch]
    o += batch
    startf = m[o:o + batch * nch].reshape(batch, nch)
    o += batch * nch
    hdr_off = m[o:o + batch * nch].reshape(batch, nch)
    o += batch * nch
    gwin = m[o:o + batch * nch].reshape(batch, nch)
    used = int(gwin.sum(axis=1).max()) if gwin.size else 0
    used = min(max(used, 1), wanch_dev.shape[1])
    wanch = _device.to_host(wanch_dev[:, :used])
    total_w = min((total + 31) // 32 + 1, words.shape[0])
    wb = _device.to_host(words[:total_w]).astype("<u4").view(np.uint8)
    return total, wb, stored_h, startf, hdr_off, gwin, wanch


class RawDeflater:
    """Host driver producing a complete raw DEFLATE stream (RFC 1951) and
    its parallel-decode index, encoding on `device`.

    Batches of blocks are encoded on the device; batch seams are
    byte-aligned sync-flush empty stored blocks (zlib Z_SYNC_FLUSH, cf.
    deflator.h:135-141) padded to 4 bytes. The index has the JAX package's
    keys (block_bits, block_bytes, sync_points, n, win), so either
    package's decoder reads it. On a card each batch is two replayed
    programs of its shape, the match stage and the coding stages
    (launch_batch, codec/program.py).
    """

    def __init__(self, level: int = 6, block_size: int = 1 << 16,
                 batch: int = 16, fixed_codes: bool = False, device="cuda"):
        # blocks split into even half-chunks (pair-combined pack items)
        if block_size < 256 or block_size % 2:
            raise ValueError(
                f"block_size must be even and >= 256, got {block_size}")
        levels_mod.get_level(level)               # validates the level
        self.level = level
        self.bl = block_size
        self.batch = batch
        self.fixed_codes = fixed_codes   # DEFLT_FIXEDCODES (deflator.h:74-76)
        self.device = _device.resolve(device)
        # when True, compress keeps every batch's encode_batch arguments in
        # last_calls as (data, start, seg_n, halo_len, final_rel), with the
        # static ones in call_statics, so a harness can replay a batch
        self.capture_calls = False
        self.last_calls: list = []
        self.call_statics: tuple = ()

    @trace.request("RawDeflater.compress")
    def compress(self, data: bytes, dictionary: bytes | None = None,
                 final: bool = True):
        """Compress to a raw DEFLATE stream. Returns (raw bytes, index).

        final=False omits BFINAL and ends with a byte-aligned sync-flush
        seam instead (Z_SYNC_FLUSH / DEFLT_FLUSH), so further segments can
        be concatenated."""
        return self.finish(self.launch(data, dictionary, final))

    @trace.span("encode.launch")
    def launch(self, data: bytes, dictionary: bytes | None = None,
               final: bool = True):
        """Phase 1 of compress: launch every batch's encode; nothing is
        read back, and on a card nothing waits for the device. Returns
        what finish() assembles."""
        bl, batch = self.bl, self.batch
        dev = self.device
        self.last_calls = []
        n = len(data)
        if n == 0:
            return n, final, []
        dict_bytes = (dictionary or b"")[-C.WINDOW_SIZE:]
        nblocks = (n + bl - 1) // bl
        arr = np.frombuffer(data, np.uint8)
        chunk = levels_mod.get_level(self.level).chunk
        seg = batch * bl
        nw = words_bound(bl, batch, chunk)
        final_idx = nblocks - 1 if final else -1
        statics = (bl, batch, self.level, nw, self.fixed_codes)

        handles = []
        for b0 in range(0, nblocks, batch):
            s = b0 * bl
            seg_n = min(n - s, seg)
            buf = np.zeros(HALO + seg + PAD, np.uint8)
            h = min(HALO, s + len(dict_bytes))
            if s >= HALO:
                buf[0:HALO] = arr[s - HALO:s]
            elif h:
                hist = dict_bytes[len(dict_bytes) - (h - s):] + data[:s] \
                    if h > s else data[s - h:s]
                buf[HALO - h:HALO] = np.frombuffer(hist, np.uint8)
            buf[HALO:HALO + seg_n] = arr[s:s + seg_n]
            dbuf = _device.upload(buf, dev)
            args = (dbuf, 0, seg_n, h, final_idx - b0)
            if self.capture_calls:
                self.last_calls.append(args)
                self.call_statics = statics
            handles.append((b0, launch_batch(*args, *statics)))
        return n, final, handles

    @trace.span("encode.finish")
    def finish(self, launched):
        """Phase 2 of compress: read back what launch() started (the small
        meta first, then only the produced words and the used prefix of
        each block's anchor row) and assemble the stream and its index."""
        n, final, handles = launched
        if n == 0:
            # empty stream: one static block with just EOB = 0x03 0x00
            return (b"\x03\x00" if final else b""), {
                "block_bits": [], "block_bytes": [], "sync_points": [],
                "n": 0, "win": []}
        bl, batch = self.bl, self.batch
        chunk = levels_mod.get_level(self.level).chunk
        nch = _nch(bl, chunk)
        nblocks = (n + bl - 1) // bl
        out = bytearray()
        index_bits, index_bytes, sync_points, anchors_out = [], [], [], []
        for b0, handle in handles:
            total, wb, stored_h, startf, hdr_off, gwin, wanch = read_batch(
                handle, batch, nch)
            base_bits = len(out) * 8
            ib, iy, ia = index_entries_from_meta(
                bl, batch, startf, hdr_off, gwin, wanch, stored_h,
                nblocks - b0, n, base_bits, b0 * bl, chunk)
            index_bits += ib
            index_bytes += iy
            anchors_out += ia
            if b0 + batch >= nblocks and final:
                out += wb[: (total + 7) // 8].tobytes()
            else:
                # sync flush: 3 zero bits (BFINAL=0, BTYPE=00) + pad + 00 00
                # ff ff, then empty stored blocks to 4-byte alignment so
                # every batch's bit offsets are word-aligned for the
                # decoder's 32-bit window grid
                out += wb[: (total + 3 + 7) // 8].tobytes()
                out += b"\x00\x00\xff\xff"
                out += b"\x00\x00\x00\xff\xff" * ((-len(out)) % 4)
                sync_points.append(len(out))
        index = {"block_bits": index_bits, "block_bytes": index_bytes,
                 "sync_points": sync_points, "n": n, "win": anchors_out}
        return bytes(out), index
