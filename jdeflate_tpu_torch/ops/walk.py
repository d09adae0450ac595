"""Window-parallel DEFLATE symbol walk (the decode-side hot kernel).

The stream is cut on a fixed 32-bit window grid aligned to u32 words. The
index records, for every 32-bit window of a block's symbol span, the bit
offset of the first symbol starting in that window, so each window is one
decode lane with an exact entry point:

  * a lane decodes at most 32 symbols (a symbol costs >= 1 bit);
  * a symbol spans at most 48 bits (15+5+15+13), so the three words w, w+1,
    w+2 cover any symbol starting in window w.

Huffman decode is table-free canonical arithmetic: the 15-bit MSB-aligned
code window gives the code length by a binary search over the per-tree
interval limits, then the symbol by its rank in a (length, symbol)-sorted
array. All per-tree state packs into four 128-entry i32 rows:

  T1 row: [0:15]  litlen limt[l]  (l = col+1; (first+cnt)<<(15-l), 15-bit axis)
          [16:31] litlen first|base<<16
          [32:47] dist limt
          [48:63] dist first|base<<16
          [64:94] dist sorted symbols
          [94:124] dist attr: base | extra<<16
  T2a/T2b: litlen sorted symbols [0:128)/[128:256)
  T2c row: [0:32]  litlen sorted symbols [256:288)
           [32:61] length attr for lsym 257..285: base | extra<<12

Two implementations of one contract (the JAX package's ops/walk.py, and
the checks its decode runs right after the walk):
  * walk_ref / walk_windows_ref - plain PyTorch, any device (the referee);
    walk_checked_ref - walk_windows_ref and the checks (the CPU path);
  * walk_checked - the CUDA kernel csrc/walk.cu on a CUDA tensor: the walk
    with the checks in its epilogue.

Word arithmetic in the plain version runs in int64 masked to 32 bits:
PyTorch has no u32 shifts or adds on the CPU. Token words travel as int32
holding the u32 bit pattern (kind in bits 30:32; literal byte, or len 0:9 and
dist-1 9:24), so readers mask after every shift.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..formats import constants as C

K_BITS = 32          # window grid pitch (bits) == one u32 word
S_SLOTS = 32         # max symbols starting in one window (>= K_BITS / 1)
PE_LANES = 1024      # lanes per pseudo-entry: one tree per 1024 lanes
PE_ROWS = PE_LANES // 128
WALK_BLOCK = 256     # lanes per block of the kernel (csrc/walk.cu)

TOK_LIT = 1          # tok kind codes (bits 30:32)
TOK_MATCH = 2

_M32 = 0xFFFFFFFF


def _attr_tables():
    """Static length/dist attribute rows (numpy)."""
    lattr = (C.LENGTH_BASE | (C.LENGTH_EXTRA << 12)).astype(np.int32)   # (29,)
    dattr = (C.DIST_BASE | (C.DIST_EXTRA << 16)).astype(np.int32)       # (30,)
    return lattr, dattr


@functools.lru_cache(maxsize=None)
def _attr_rows_on(dev: torch.device):
    """The length and dist attribute rows as int64 tensors resident on
    `dev`: a captured decode program cannot upload them."""
    return tuple(torch.as_tensor(a, dtype=torch.int64, device=dev)
                 for a in _attr_tables())


def _tree_rows(lengths: torch.Tensor, nsym: int):
    """(limt (E,15), firstbase (E,15), sorted_syms (E,nsym)) for E trees.

    Canonical interval math per RFC 1951 §3.2.2: limt[l] = (first[l]+cnt[l])
    << (15-l) on the 15-bit MSB-aligned code axis; a decoded window c has
    length l = 1 + #{j: c >= limt[j]}; symbol = sorted_syms[base[l] +
    (c >> (15-l)) - first[l]]. Incomplete trees leave c >= limt[15] slots
    invalid. Oversubscribed trees (Kraft > 1) clamp limt at 2^15 and may
    decode without error, as in the reference; the header parse rejects
    them before they reach the walk.
    """
    l = lengths.to(torch.int64)
    E, n = l.shape
    used = l > 0
    cnt = torch.zeros(E, 16, dtype=torch.int64, device=l.device)
    cnt.scatter_add_(1, l.clamp(0, 15), used.to(torch.int64))
    cnt[:, 0].fill_(0)
    limt, fb = [], []
    code = torch.zeros(E, dtype=torch.int64, device=l.device)
    base = torch.zeros(E, dtype=torch.int64, device=l.device)
    for lb in range(1, 16):
        code = (code + cnt[:, lb - 1]) << 1
        limt.append(torch.clamp((code + cnt[:, lb]) << (15 - lb), max=1 << 15))
        fb.append(code | (base << 16))
        base = base + cnt[:, lb]
    sym = torch.arange(n, dtype=torch.int64, device=l.device)
    key = torch.where(used, (l << 10) | sym, torch.full_like(l, 1 << 20))
    skey, order = torch.sort(key, dim=1)
    ssym = torch.where(skey < (1 << 20), order, torch.zeros_like(order))
    if nsym > n:
        ssym = torch.cat([ssym, ssym.new_zeros(E, nsym - n)], dim=1)
    return torch.stack(limt, 1), torch.stack(fb, 1), ssym[:, :nsym]


def build_entry_tables(ll: torch.Tensor, dl: torch.Tensor):
    """(E, 288) litlen + (E, 32) dist code lengths -> T1, T2a, T2b, T2c,
    each (E, 128) i32 (layout in the module docstring)."""
    dev = ll.device
    lattr, dattr = _attr_rows_on(dev)
    E = ll.shape[0]
    llim, lfb, lsym = _tree_rows(ll, 288)
    dlim, dfb, dsym = _tree_rows(dl, 32)
    t1 = torch.zeros(E, 128, dtype=torch.int64, device=dev)
    t1[:, 0:15] = llim
    t1[:, 16:31] = lfb
    t1[:, 32:47] = dlim
    t1[:, 48:63] = dfb
    t1[:, 64:94] = dsym[:, :30]
    t1[:, 94:124] = dattr
    t2c = torch.zeros(E, 128, dtype=torch.int64, device=dev)
    t2c[:, 0:32] = lsym[:, 256:288]
    t2c[:, 32:61] = lattr
    i32 = torch.int32
    return (t1.to(i32), lsym[:, 0:128].to(i32).contiguous(),
            lsym[:, 128:256].to(i32).contiguous(), t2c.to(i32))


def _rev15(x):
    x = ((x & 0x5555) << 1) | ((x >> 1) & 0x5555)
    x = ((x & 0x3333) << 2) | ((x >> 2) & 0x3333)
    x = ((x & 0x0F0F) << 4) | ((x >> 4) & 0x0F0F)
    x = ((x & 0x00FF) << 8) | ((x >> 8) & 0x00FF)
    return x >> 1


def _field(s0, s1, s2, o, n):
    """n-bit LSB-first field at bit offset o of the 96-bit lane window.

    s0/s1/s2 are int64 words in [0, 2^32); o, n int64 tensors (or n an int).
    Code reads start at o <= 51 and extra-bit fields end at <= 96, so the
    two-word funnel with a zero high word past 64 is exact. A shift by 32 is
    guarded as in the reference (oo == 0 takes no high word)."""
    a = torch.where(o < 32, s0, torch.where(o < 64, s1, s2))
    b = torch.where(o < 32, s1, torch.where(o < 64, s2, torch.zeros_like(s2)))
    oo = o & 31
    hi = torch.where(oo == 0, torch.zeros_like(b), (b << (32 - oo)) & _M32)
    lo = (a >> oo) | hi
    if isinstance(n, int):
        return lo & ((1 << n) - 1)
    return lo & ((torch.ones_like(n) << n) - 1)


def _decode_step(s0, s1, s2, pos, t1g, t2g, active):
    """Decode ONE symbol per lane at bit pos (relative to lane word 0).

    t1g(idx) / t2g(kind, idx) gather from the lane's tree rows; every index
    is clamped into its row, so unselected branches read harmless values.
    Returns (tok int64 u32-valued, nbits, outlen, err bool, eob bool)."""
    c15 = _rev15(_field(s0, s1, s2, pos, 15))
    k = torch.zeros_like(pos)
    for step in (8, 4, 2, 1):
        kk = k + step
        t = t1g(torch.clamp(kk - 1, max=14))
        k = torch.where((kk <= 15) & (c15 >= t), kk, k)
    bad = k >= 15
    l = torch.clamp(k + 1, max=15)
    fb = t1g(16 + torch.clamp(k, max=14))
    first = fb & 0xFFFF
    sidx = ((fb >> 16) + (c15 >> (15 - l)) - first).clamp(0, 287)
    sym = torch.where(sidx < 128, t2g(0, sidx),
                      torch.where(sidx < 256, t2g(1, sidx - 128),
                                  t2g(2, torch.clamp(sidx - 256, max=31))))
    is_eob = ~bad & (sym == C.EOB)
    is_lit = ~bad & (sym < 256)
    is_len = ~bad & (sym > 256)

    lsym = (sym - 257).clamp(0, 28)
    lat = t2g(2, 32 + lsym)
    lext = lat >> 12
    o2 = pos + l
    lval = _field(s0, s1, s2, o2, lext)
    length = (lat & 0xFFF) + lval
    bad = bad | (is_len & (sym > 285))
    o3 = o2 + torch.where(is_len, lext, torch.zeros_like(lext))

    # distance (masked for non-matches; garbage reads are harmless)
    c15d = _rev15(_field(s0, s1, s2, o3, 15))
    kd = torch.zeros_like(pos)
    for step in (8, 4, 2, 1):
        kk = kd + step
        t = t1g(32 + torch.clamp(kk - 1, max=14))
        kd = torch.where((kk <= 15) & (c15d >= t), kk, kd)
    badd = kd >= 15
    ld = torch.clamp(kd + 1, max=15)
    dfb = t1g(48 + torch.clamp(kd, max=14))
    didx = ((dfb >> 16) + (c15d >> (15 - ld)) - (dfb & 0xFFFF)).clamp(0, 29)
    dsym = t1g(64 + didx)
    dat = t1g(94 + dsym.clamp(0, 29))
    dext = dat >> 16
    o4 = o3 + ld
    dval = _field(s0, s1, s2, o4, dext)
    dist = (dat & 0xFFFF) + dval
    bad = bad | (is_len & (badd | (dsym > 29)))

    nbits = torch.where(is_len, l + lext + ld + dext, l)
    lit_tok = (TOK_LIT << 30) | sym
    m_tok = (TOK_MATCH << 30) | length | (((dist - 1) << 9) & _M32)
    zero = torch.zeros_like(sym)
    tok = torch.where(is_lit, lit_tok, torch.where(is_len, m_tok, zero))
    outlen = torch.where(is_lit, torch.ones_like(sym),
                         torch.where(is_len, length, zero))
    err = active & bad
    ok = active & ~bad
    return (torch.where(ok, tok, zero), nbits, torch.where(ok, outlen, zero),
            err, is_eob)


def _to_i32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 holding a u32 value -> int32 with the same bit pattern."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def walk_ref(seg0, seg1, seg2, start_rel, t1, t2a, t2b, t2c):
    """Plain walk on flat (L,) lanes (any device).

    seg0/1/2: (L,) lane words w, w+1, w+2 (int32 bit patterns or int64).
    start_rel: (L,) i32 first-symbol bit within the lane word (< 32); < 0
      marks an inactive (padding) lane.
    t1/t2a/t2b/t2c: (ceil(L/128), 128) i32 per-ROW table rows (all 128 lanes
      of a row share one tree).
    Returns (tok (L, S) i32 lane-major, outlen (L,) i32, cnt (L,) i32,
    err (L,) bool, pos (L,) i32, eob (L,) bool); err includes a lane still
    active after S_SLOTS steps. The JAX reference returns tok slot-major.
    """
    s0 = seg0.to(torch.int64) & _M32
    s1 = seg1.to(torch.int64) & _M32
    s2 = seg2.to(torch.int64) & _M32
    L = s0.shape[0]
    dev = s0.device
    rowbase = (torch.arange(L, dtype=torch.int64, device=dev) >> 7) * 128
    t1f = t1.reshape(-1).to(torch.int64)
    t2f = [t.reshape(-1).to(torch.int64) for t in (t2a, t2b, t2c)]

    def t1g(idx):
        return t1f[rowbase + idx.clamp(0, 127)]

    def t2g(kind, idx):
        return t2f[kind][rowbase + idx.clamp(0, 127)]

    start = start_rel.to(torch.int64)
    active = (start >= 0) & (start < K_BITS)
    pos = torch.where(active, start, torch.zeros_like(start))
    outlen = torch.zeros(L, dtype=torch.int64, device=dev)
    cnt = torch.zeros(L, dtype=torch.int64, device=dev)
    err = torch.zeros(L, dtype=torch.bool, device=dev)
    eobf = torch.zeros(L, dtype=torch.bool, device=dev)
    toks = []
    for _ in range(S_SLOTS):
        tok, nbits, ol, e, eob = _decode_step(s0, s1, s2, pos, t1g, t2g,
                                              active)
        pos = pos + torch.where(active, nbits, torch.zeros_like(nbits))
        outlen = outlen + ol
        cnt = cnt + (active & ~eob & ~e).to(torch.int64)
        err = err | e
        eobf = eobf | (active & eob)
        active = active & ~eob & ~e & (pos < K_BITS)
        toks.append(tok)
    tok_lm = _to_i32_bits(torch.stack(toks, 1))
    i32 = torch.int32
    return (tok_lm, outlen.to(i32), cnt.to(i32), err | active, pos.to(i32),
            eobf)


def segment_starts(pe_word0, wwords: int):
    """First word of each pseudo-entry's lanes in the batch's word window.

    The reference slices a (PE_LANES + 8)-word segment per pseudo-entry out
    of the batch's bucketed window of wwords words with a dynamic slice,
    which clamps the start into that window. The same clamp here: the last
    pseudo-entry of a batch whose lanes reach past the window then reads
    shifted words, fails the exit-chain check and falls back to the native
    decoder, as in the reference."""
    return torch.clamp(torch.clamp(pe_word0, min=0), 0,
                       wwords - (PE_LANES + 8))


def walk_windows_ref(words, seg_word0, pe_tab, start_rel, t1, t2a, t2b, t2c):
    """Plain version of the kernel's contract (any device).

    words: (W,) i32 stream words. seg_word0: (npe,) first word of each
    pseudo-entry's lanes. pe_tab: (npe,) tree row of each pseudo-entry.
    start_rel: (npe * PE_LANES,) i32. t1..t2c: (ntrees, 128) i32.
    Returns walk_ref's tuple for the npe * PE_LANES lanes."""
    lane_w = (seg_word0.to(torch.int64)[:, None]
              + torch.arange(PE_LANES, device=words.device)[None, :]
              ).reshape(-1)
    w = words.to(torch.int64)
    W = w.shape[0]

    def word(i):        # words past the stream read as 0, as in the kernel
        return torch.where(i < W, w[i.clamp(max=W - 1)], torch.zeros_like(i))

    def rows(tab):
        return tab[pe_tab.long()].repeat_interleave(PE_ROWS, dim=0)

    return walk_ref(word(lane_w), word(lane_w + 1), word(lane_w + 2),
                    start_rel.reshape(-1), rows(t1), rows(t2a), rows(t2b),
                    rows(t2c))


def pack_meta(outlen, cnt, err, pos, eob) -> torch.Tensor:
    """walk_ref's per-lane fields -> the kernel's meta word (i32): outlen
    0:15, cnt 15:21, err 21, eob 22, exit pos 23:31."""
    i32 = torch.int32
    return (outlen.to(i32) | (cnt.to(i32) << 15) | (err.to(i32) << 21)
            | (eob.to(i32) << 22) | (pos.clamp(max=255).to(i32) << 23))


def token_slots(tok_lm: torch.Tensor):
    """(L, S) tokens -> (len, lit, dist) per slot, each (L, S) (0 for an
    empty slot)."""
    kind = (tok_lm >> 30) & 3
    zero = torch.zeros_like(tok_lm)
    is_lit = kind == TOK_LIT
    is_m = kind == TOK_MATCH
    o_len = torch.where(is_lit, torch.ones_like(tok_lm),
                        torch.where(is_m, tok_lm & 0x1FF, zero))
    o_dist = torch.where(is_m, ((tok_lm >> 9) & 0x7FFF) + 1, zero)
    o_lit = torch.where(is_lit, tok_lm & 0xFF, zero)
    return o_len, o_lit, o_dist


def walk_checked_ref(words, seg_word0, pe_tab, start_rel, t1, t2a, t2b, t2c,
                     pe_word0, hist):
    """Plain version of the kernel's contract (any device): the window walk
    (walk_windows_ref, its first eight arguments) and the checks the
    reference runs right after it (jdeflate_tpu/codec/inflate.py,
    _decode_batch_windows_impl).

    pe_word0: (npe,) i32 first word of each pseudo-entry as the index gives
      it (the anchors' base, clamped at 0; seg_word0 is clamped into the
      word window as well, ROADMAP C5). hist: () i32 bytes of history
      before the batch.
    Returns (tok (L, 32) i32, meta (L,) i32 (pack_meta), outlen (L,) i32,
    laneoff (L,) i64 the exclusive scan of outlen, err (1,) i32 = lane
    errors + broken exit-chain links + matches reaching past the
    history)."""
    tok_lm, outlen_w, cnt, err_l, posf, eobf = walk_windows_ref(
        words, seg_word0, pe_tab, start_rel, t1, t2a, t2b, t2c)
    meta = pack_meta(outlen_w, cnt, err_l, posf, eobf)
    PE = PE_LANES
    npe = pe_tab.shape[0]
    dev = tok_lm.device
    err_l = err_l.reshape(npe, PE)
    eobf = eobf.reshape(npe, PE)
    posf = posf.reshape(npe, PE)
    start_rel = start_rel.reshape(npe, PE)
    lanebit = (torch.clamp(pe_word0, min=0)[:, None]
               + torch.arange(PE, dtype=torch.int32, device=dev)[None, :]) * 32
    # exit-chain validation: every lane's final bit position must be exactly
    # the next lane's anchor (the structural check corruption cannot dodge)
    BIGV = 1 << 29
    active = start_rel >= 0
    sabs = torch.where(active, lanebit + start_rel,
                       torch.full_like(start_rel, BIGV))
    exit_abs = lanebit + posf
    nxt_in = torch.flip(torch.cummin(torch.flip(sabs, [1]), 1).values, [1])
    big = torch.full((npe, 1), BIGV, dtype=sabs.dtype, device=dev)
    nxt_in = torch.cat([nxt_in[:, 1:], big], 1)
    head = sabs.min(1).values
    same_ent = torch.cat([pe_tab[1:] == pe_tab[:-1],
                          torch.zeros(1, dtype=torch.bool, device=dev)])
    nxt_head = torch.where(same_ent, torch.cat([head[1:], big[0]]), big[:, 0])
    nxt = torch.minimum(nxt_in, nxt_head[:, None])
    chain_bad = active & ~eobf & (exit_abs != nxt)
    err_w = err_l.sum() + chain_bad.sum()

    len2, _, dist2 = token_slots(tok_lm)
    outlen = len2.sum(1, dtype=torch.int32)
    # far-offset validation (INFLT_EFAROFFSET analog, inflator.c:1233-1237):
    # a match may not reach past the available history
    laneoff = torch.cumsum(outlen, 0) - outlen
    off_in = laneoff[:, None] + torch.cumsum(len2, 1) - len2
    far = (dist2 > 0) & (dist2 > off_in + hist)
    err_w = err_w + far.sum()
    return tok_lm, meta, outlen, laneoff, err_w.reshape(1).to(torch.int32)


def walk_checked(words, seg_word0, pe_tab, start_rel, t1, t2a, t2b, t2c,
                 pe_word0, hist):
    """The window walk and its checks: csrc/walk.cu on a CUDA tensor,
    walk_checked_ref on a CPU tensor. Same arguments and result as
    walk_checked_ref; nothing is read back to the host. Counts its kernel
    launches in walk_checked.launches."""
    if words.device.type == "cpu":
        return walk_checked_ref(words, seg_word0, pe_tab, start_rel,
                                t1, t2a, t2b, t2c, pe_word0, hist)
    from . import _cuda
    dev = words.device
    npe = seg_word0.shape[0]
    L = npe * PE_LANES
    _cuda.check_tensor(words, "words", torch.int32, dev)
    for name, t in (("seg_word0", seg_word0), ("pe_word0", pe_word0),
                    ("pe_tab", pe_tab)):
        _cuda.check_tensor(t, name, torch.int32, dev, (npe,))
    _cuda.check_tensor(start_rel, "start_rel", torch.int32, dev, (L,))
    _cuda.check_tensor(hist, "hist", torch.int32, dev, ())
    for name, t in (("t1", t1), ("t2a", t2a), ("t2b", t2b), ("t2c", t2c)):
        _cuda.check_tensor(t, name, torch.int32, dev, (t1.shape[0], 128))
    fn = _cuda.entry("walk", "jd_walk", [ctypes.c_void_p] * 15
                     + [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p])
    tok = torch.empty(L, S_SLOTS, dtype=torch.int32, device=dev)
    meta = torch.empty(L, dtype=torch.int32, device=dev)
    outlen = torch.empty(L, dtype=torch.int32, device=dev)
    laneoff = torch.empty(L, dtype=torch.int64, device=dev)
    # the ticket, the err count, one 64-bit look-back state per block
    sync = torch.zeros(2 + 2 * (L // WALK_BLOCK), dtype=torch.int32,
                       device=dev)
    with torch.cuda.device(dev):
        rc = fn(words.data_ptr(), seg_word0.data_ptr(), pe_word0.data_ptr(),
                pe_tab.data_ptr(), start_rel.data_ptr(), hist.data_ptr(),
                t1.data_ptr(), t2a.data_ptr(), t2b.data_ptr(), t2c.data_ptr(),
                tok.data_ptr(), meta.data_ptr(), outlen.data_ptr(),
                laneoff.data_ptr(), sync.data_ptr(), words.shape[0], npe,
                _cuda.stream_ptr())
    _cuda.check(rc, "walk kernel launch")
    walk_checked.launches += 1
    return tok, meta, outlen, laneoff, sync[1:2]


walk_checked.launches = 0


def annotate_lit_runs(tok_lm: torch.Tensor) -> torch.Tensor:
    """Write the literal-run length into bits [8:14] of each run's FIRST
    literal slot (a run = consecutive TOK_LIT slots within a lane). The
    expand kernel then copies whole runs instead of single bytes."""
    S = tok_lm.shape[1]
    is_lit = ((tok_lm >> 30) & 3) == TOK_LIT
    acc = torch.zeros(tok_lm.shape[0], dtype=torch.int32, device=tok_lm.device)
    cols = []
    for s in range(S - 1, -1, -1):
        acc = torch.where(is_lit[:, s], acc + 1, torch.zeros_like(acc))
        cols.append(acc)
    run = torch.stack(cols[::-1], dim=1)
    prev_lit = torch.zeros_like(is_lit)
    prev_lit[:, 1:] = is_lit[:, :-1]
    start = is_lit & ~prev_lit
    return torch.where(start, tok_lm | (run << 8), tok_lm)
