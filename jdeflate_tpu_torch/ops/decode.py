"""Plain-PyTorch decode stages: the token expansion referee and the legacy
wavefront decode.

Token slots -> output bytes by an offset scan, a literal scatter, a cover
map and a dependency-doubling LZ resolve (assemble_output, lz_resolve). The
window crosses block and batch boundaries through the 32 KiB halo, like the
reference's ring window (inflator.c:616-675). Port of
jdeflate_tpu/codec/inflate.py::_assemble_output and of
jdeflate_tpu/ops/decode.py.

The legacy decode of the anchored and dense branches: flat 15-bit decode
tables per block (build_tables_batch; entry: bits 0..4 code length, 5..7
kind, 8..11 extra bits, 16..31 payload), one symbol decoded at any bit
position (f_eval), a speculative decode at every bit position
(wavefront_decode) whose symbol lattice is the orbit of each block's first
symbol (orbits, segmented_orbits), and exact walks between symbol anchors
(anchored_walk). These are XLA code in the reference and stay plain
PyTorch on the card.

Stream words travel as int64 holding u32 values: PyTorch has no u32 shifts
on the CPU (ROADMAP C1), so every shift amount is clamped into [0, 31] and
every left shift masked to 32 bits. Gathers follow XLA's rule: a negative
index counts from the end once, then every index is clamped into range.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..formats import constants as C
from . import huffman

HALO = C.WINDOW_SIZE

KIND_INVALID = 0
KIND_LIT = 1
KIND_CODE = 2
KIND_EOB = 3

TABLE_BITS = 15
TABLE_SIZE = 1 << TABLE_BITS
ANCHOR_STRIDE = 64   # an anchors index holds every 64th symbol's bit offset

_M32 = 0xFFFFFFFF


def lz_resolve(val: torch.Tensor, src: torch.Tensor, resolved: torch.Tensor,
               mask: torch.Tensor, max_rounds: int):
    """Resolve back-reference chains by pointer doubling: the reference's
    while_loop (jdeflate_tpu/ops/decode.py::lz_resolve), which stops once
    every masked position is resolved or after max_rounds rounds, run as
    max_rounds masked rounds with no host read. A round changes nothing
    once the loop's condition is false (every position then holds still),
    so the result is the while_loop's, unmasked positions included.

    val: (N,) output bytes (literal positions already set).
    src: (N,) copy-source index per position (self for resolved).
    resolved: (N,) bool. mask: (N,) bool - positions that must resolve.
    Returns (val & 0xFF, resolved)."""
    pv = (val & 0xFF) | (resolved.to(val.dtype) << 8)
    for _ in range(max_rounds):
        go = ((pv < 256) & mask).any()
        hold = (pv >= 256) | ~go
        pv = torch.where(hold, pv, pv[src])
        src = torch.where(hold, src, src[src])
    return pv & 0xFF, pv >= 256


def drop_index(keep: torch.Tensor, idx: torch.Tensor,
               n: int) -> torch.Tensor:
    """Scatter targets into an (n + 1,) buffer whose slot n is dropped: idx
    where keep and inside [0, n), else n."""
    return torch.where(keep & (idx >= 0) & (idx < n), idx,
                       torch.full_like(idx, n))


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
    is_tok = o_len > 0
    is_lit = is_tok & (o_dist == 0)
    # scatters with a drop slot at n (the reference's mode="drop"): no
    # boolean index, so no shape depends on the data
    val = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    val[:HALO] = halo.to(torch.int64)
    val = val.scatter_(0, drop_index(is_lit, off, n), o_lit)[:n]

    S = o_len.shape[0]
    tok_idx = torch.arange(S, dtype=torch.int64, device=dev)
    cover = torch.full((n + 1,), -1, dtype=torch.int64, device=dev)
    # token offsets are distinct, so the reference's max is a plain write
    cover = cover.scatter_(0, drop_index(is_tok, off, n), tok_idx)[:n]
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


def _take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[i] with XLA's gather rule: negative i counts from the end once,
    then i is clamped into [0, len(x) - 1]."""
    n = x.shape[0]
    i = i.long()
    return x[torch.where(i < 0, i + n, i).clamp(0, n - 1)]


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 value with the same low 32 bits."""
    return ((x & _M32) ^ 0x80000000) - 0x80000000


def _shl(x, s):
    return (x << s) & _M32


def rev15(x: torch.Tensor) -> torch.Tensor:
    """Elementwise 15-bit reversal (u32 values in int64)."""
    x = ((x & 0x5555) << 1) | ((x >> 1) & 0x5555)
    x = ((x & 0x3333) << 2) | ((x >> 2) & 0x3333)
    x = ((x & 0x0F0F) << 4) | ((x >> 4) & 0x0F0F)
    x = ((x & 0x00FF) << 8) | ((x >> 8) & 0x00FF)
    return x >> 1


@functools.lru_cache(maxsize=None)
def _attrs_on(kinds: bytes, extras: bytes, payloads: bytes,
              dev: torch.device):
    """Per-symbol attribute rows (the int32 bytes of each) as int64
    tensors resident on `dev`: a captured decode program cannot upload
    them."""
    return tuple(torch.as_tensor(np.frombuffer(a, np.int32).astype(np.int64),
                                 device=dev)
                 for a in (kinds, extras, payloads))


def build_tables_batch(lengths: torch.Tensor, kinds, extras,
                       payloads) -> torch.Tensor:
    """Flat decode tables for a batch of trees.

    lengths: (B, n) per-block code lengths; kinds/extras/payloads: (n,)
    numpy per-symbol attributes. Returns (B * TABLE_SIZE,) int64 u32
    entries: block b's table occupies [b*TABLE_SIZE, (b+1)*TABLE_SIZE).
    Slots not covered by any code decode as invalid (kind 0).

    Each code's entry is scattered at its MSB-aligned interval start and
    forward-filled by a per-block cummax of (start << 16 | entry half) keys,
    two passes for the two halves; coverage comes from a +1/-1 interval
    diff and a cumsum, as in the reference."""
    dev = lengths.device
    B, n = lengths.shape
    kinds, extras, payloads = _attrs_on(
        *(np.asarray(a, np.int32).tobytes() for a in (kinds, extras,
                                                      payloads)), dev)
    l = lengths.to(torch.int64)
    codes = huffman.canonical_codes(l, C.MAX_CODE_BITS)[0]
    used = l > 0
    sh = torch.clamp(TABLE_BITS - l, 0, TABLE_BITS)
    start = torch.where(used, codes << sh, torch.full_like(l, TABLE_SIZE))
    width = torch.where(used, torch.ones_like(l) << sh, torch.zeros_like(l))
    entry = (l | kinds[None, :] << 5 | extras[None, :] << 8
             | payloads[None, :] << 16) & _M32
    entry = torch.where(used, entry, torch.zeros_like(entry))

    NT = B * TABLE_SIZE
    bbase = (torch.arange(B, dtype=torch.int64, device=dev)
             * TABLE_SIZE)[:, None]
    pos = torch.where(used, bbase + start, torch.full_like(l, NT))
    pos = pos.reshape(-1).clamp(0, NT)
    lo16 = entry & 0xFFFF
    hi16 = entry >> 16
    zero = torch.zeros_like(l)
    key1 = _wrap32(torch.where(used, (start << 16) | lo16, zero))
    key2 = _wrap32(torch.where(used, (start << 16) | hi16, zero))

    def fill(key):
        pk = torch.zeros(NT + 1, dtype=torch.int64, device=dev)
        pk = pk.scatter_reduce(0, pos, key.reshape(-1), "amax")[:NT]
        return torch.cummax(pk.reshape(B, TABLE_SIZE), 1).values.reshape(-1)

    pk1, pk2 = fill(key1), fill(key2)
    ent = (pk1 & 0xFFFF) | ((pk2 & 0xFFFF) << 16)
    T1 = TABLE_SIZE + 1
    bbase1 = (torch.arange(B, dtype=torch.int64, device=dev) * T1)[:, None]
    pos1 = torch.where(used, bbase1 + start,
                       torch.full_like(l, B * T1)).reshape(-1)
    end1 = torch.where(used, bbase1 + start + width,
                       torch.full_like(l, B * T1)).reshape(-1)
    one = used.to(torch.int64).reshape(-1)
    dif = torch.zeros(B * T1 + 1, dtype=torch.int64, device=dev)
    dif.index_add_(0, pos1.clamp(0, B * T1), one)
    dif.index_add_(0, end1.clamp(0, B * T1), -one)
    covered = torch.cumsum(dif[:B * T1].reshape(B, T1),
                           1)[:, :TABLE_SIZE].reshape(-1) > 0
    return torch.where(covered, ent, torch.zeros_like(ent))


def litlen_attrs():
    """(kinds, extras, payloads) for the 288-symbol literal/length alphabet."""
    kinds = np.full(288, KIND_LIT, np.int32)
    kinds[C.EOB] = KIND_EOB
    kinds[257:286] = KIND_CODE
    kinds[286:] = KIND_CODE        # reserved; only decodable if present
    extras = np.zeros(288, np.int32)
    payloads = np.arange(288, dtype=np.int32)
    payloads[256:] = 0
    extras[257:286] = C.LENGTH_EXTRA
    payloads[257:286] = C.LENGTH_BASE
    return kinds, extras, payloads


def dist_attrs():
    kinds = np.full(32, KIND_CODE, np.int32)
    kinds[30:] = KIND_INVALID      # reserved symbols: present in the fixed
    extras = np.zeros(32, np.int32)  # tree (completeness) but invalid on use
    payloads = np.zeros(32, np.int32)
    extras[:30] = C.DIST_EXTRA
    payloads[:30] = C.DIST_BASE
    return kinds, extras, payloads


def _mask(n):
    if isinstance(n, int):
        return (1 << n) - 1
    return ((torch.ones_like(n) << n.clamp(0, 32)) - 1) & _M32


def extract_bits(words: torch.Tensor, p: torch.Tensor, n) -> torch.Tensor:
    """n-bit LSB-first field at absolute bit position p (n <= 25) from a
    two-word window."""
    pw = p >> 5
    s = p & 31
    w0 = _take(words, pw)
    w1 = _take(words, pw + 1)
    lo = (w0 >> s) | torch.where(s == 0, torch.zeros_like(w1),
                                 _shl(w1, (32 - s).clamp(0, 31)))
    return lo & _mask(n)


def _fld(lo: torch.Tensor, hi: torch.Tensor, o: torch.Tensor, n):
    """n-bit LSB-first field at offset o (< 49) of a 64-bit window."""
    lo32 = torch.where(
        o < 32,
        (lo >> o.clamp(0, 31)) | torch.where(
            o == 0, torch.zeros_like(hi), _shl(hi, (32 - o).clamp(0, 31))),
        hi >> (o - 32).clamp(0, 31))
    return lo32 & _mask(n)


def _entry_fields(e):
    return e & 31, (e >> 5) & 7, (e >> 8) & 15, e >> 16


def f_eval(words: torch.Tensor, ltab: torch.Tensor, dtab: torch.Tensor,
           tb: torch.Tensor, p: torch.Tensor):
    """Decode ONE symbol at bit positions p (any shape); tb: table base
    (bid * TABLE_SIZE) per position. Returns (next bit, outlen, lit, dist,
    invalid, is_eob). One 3-word window covers the 48 bits a symbol can
    take."""
    pw = p >> 5
    s = p & 31
    w0 = _take(words, pw)
    w1 = _take(words, pw + 1)
    w2 = _take(words, pw + 2)
    ns = (32 - s).clamp(0, 31)
    zero = torch.zeros_like(w0)
    lo = (w0 >> s) | torch.where(s == 0, zero, _shl(w1, ns))
    hi = (w1 >> s) | torch.where(s == 0, zero, _shl(w2, ns))

    e1 = _take(ltab, tb + rev15(lo & (TABLE_SIZE - 1)))
    c1, k1, ex1, pay1 = _entry_fields(e1)
    is_lit = k1 == KIND_LIT
    is_eob = k1 == KIND_EOB
    is_len = k1 == KIND_CODE
    invalid = k1 == KIND_INVALID

    length = pay1 + _fld(lo, hi, c1, ex1)
    o2 = c1 + ex1
    e2 = _take(dtab, tb + rev15(_fld(lo, hi, o2, TABLE_BITS)))
    c2, k2, ex2, pay2 = _entry_fields(e2)
    dist = pay2 + _fld(lo, hi, o2 + c2, ex2)
    invalid = invalid | (is_len & (k2 != KIND_CODE))

    zero = torch.zeros_like(p)
    nxt = torch.where(is_len, p + o2 + c2 + ex2, p + c1)
    outlen = torch.where(is_lit, torch.ones_like(p),
                         torch.where(is_len, length, zero))
    lit = torch.where(is_lit, pay1, zero)
    dist = torch.where(is_len, dist, zero)
    return nxt, outlen, lit, dist, invalid, is_eob


def wavefront_decode(words: torch.Tensor, bit_lo, nbits: int,
                     bid: torch.Tensor, ltab: torch.Tensor,
                     dtab: torch.Tensor):
    """Speculative decode at every bit position in [bit_lo, bit_lo + nbits).

    words: (W,) int64 u32 words of the batch's window. bit_lo: the window
    bit of local position 0, an int or a 0-d int64 tensor (a captured
    program's input). bid: (nbits,) block id per position (tables are per
    block). Returns (f_local, outlen, lit, dist, flags, eob), each
    (nbits + 1,) int64 with an absorbing sentinel at index nbits: f_local
    is the next symbol position in local coordinates (EOB and invalid
    entries map to the sentinel); flags is 1 for an invalid entry."""
    dev = words.device
    p = bit_lo + torch.arange(nbits, dtype=torch.int64, device=dev)
    tb = bid.to(torch.int64) * TABLE_SIZE
    e1 = _take(ltab, tb + rev15(extract_bits(words, p, TABLE_BITS)))
    c1, k1, ex1, pay1 = _entry_fields(e1)
    is_lit = k1 == KIND_LIT
    is_eob = k1 == KIND_EOB
    is_len = k1 == KIND_CODE
    invalid = k1 == KIND_INVALID

    p_ext = p + c1
    length = pay1 + extract_bits(words, p_ext, ex1)
    p2 = p_ext + ex1
    e2 = _take(dtab, tb + rev15(extract_bits(words, p2, TABLE_BITS)))
    c2, k2, ex2, pay2 = _entry_fields(e2)
    dist = pay2 + extract_bits(words, p2 + c2, ex2)
    invalid = invalid | (is_len & (k2 != KIND_CODE))

    f_abs = torch.where(is_len, p2 + c2 + ex2, p + c1)
    f_local = torch.where(is_eob | invalid, torch.full_like(p, nbits),
                          f_abs - bit_lo).clamp(0, nbits)
    zero = torch.zeros_like(p)
    outlen = torch.where(is_lit, torch.ones_like(p),
                         torch.where(is_len, length, zero))
    lit = torch.where(is_lit, pay1, zero)
    dist = torch.where(is_len, dist, zero)

    def sent(x, v):
        return torch.cat([x.to(torch.int64),
                          torch.full((1,), v, dtype=torch.int64, device=dev)])

    return (sent(f_local, nbits), sent(outlen, 0), sent(lit, 0),
            sent(dist, 0), sent(invalid, 0), sent(is_eob, 0))


def segmented_orbits(f: torch.Tensor, eobf: torch.Tensor,
                     sym_starts: torch.Tensor, block_ends: torch.Tensor,
                     nbits: int, nseg: int, seg_bits: int,
                     fix_iters: int = 3):
    """Exact symbol positions by strided speculation with lookback (the
    reference's algorithm, jdeflate_tpu/ops/decode.py::segmented_orbits):
    an A-pass walks each segment from one segment back and records the
    positions in its window; entries are stitched from the A-exits and
    verified by D-walks, fix_iters times; the first D-walk position found
    in the A-records is the merge point. The step counts are the
    reference's: the err flag (unconverged or broken entries) depends on
    them.

    Returns (positions (B*nseg*(2*seg_bits+1),) int64 in stream order,
    sentinel nbits for inactive slots; err)."""
    dev = f.device
    i64 = torch.int64
    B = sym_starts.shape[0]
    S = seg_bits
    sym_starts = sym_starts.to(i64)
    m = torch.arange(nseg, dtype=i64, device=dev).repeat(B)
    sb = sym_starts.repeat_interleave(nseg)
    eb = torch.clamp(block_ends.to(i64), max=nbits).repeat_interleave(nseg)
    seg_start = torch.minimum(sb + m * S, eb)
    seg_end = torch.minimum(seg_start + S, eb)
    lanes = B * nseg
    big = nbits + 8
    DEAD = nbits             # true end of chain (EOB reached)
    BROKEN = nbits + 1       # a speculative walk hit an invalid slot
    bw = (nbits >> 5) + 2

    def walk(p0, steps, bitmap):
        p = p0
        exit_p = torch.full_like(p0, big)
        q = torch.full_like(p0, big)
        recs = []
        for _ in range(steps):
            exited = exit_p < big
            at_end = p >= seg_end
            newly = ~exited & at_end
            exit_p = torch.where(newly, torch.clamp(p, max=BROKEN), exit_p)
            walking = ~exited & ~at_end
            inwin = walking & (p >= seg_start)
            recs.append(torch.where(inwin, p, torch.full_like(p, nbits)))
            if bitmap is not None:
                wq = _take(bitmap, torch.clamp(p >> 5, max=(nbits >> 5) + 1))
                hit = inwin & (((wq >> (p & 31)) & 1) == 1)
                q = torch.where((q >= big) & hit, p, q)
            pc = torch.clamp(p, max=nbits)
            fp = _take(f, pc)
            ended = walking & (fp >= nbits)
            fp = torch.where(ended & (_take(eobf, pc) > 0),
                             torch.full_like(fp, DEAD),
                             torch.where(ended, torch.full_like(fp, BROKEN),
                                         fp))
            p = torch.where(walking, fp, p)
        exit_p = torch.where(exit_p >= big, torch.clamp(p, max=BROKEN),
                             exit_p)
        return torch.stack(recs), exit_p, q

    p0a = torch.maximum(seg_start - S, torch.minimum(sb, seg_start))
    a_recs, a_exit, _ = walk(p0a, 2 * S, None)
    # compress the 2S-step records into S+1 window slots
    inwin = (a_recs < nbits).to(i64)
    slot = torch.cumsum(inwin, 0) - inwin
    lane_idx = torch.arange(lanes, dtype=i64, device=dev)[None, :]
    flatidx = (lane_idx * (S + 1) + torch.clamp(slot, max=S)).reshape(-1)
    a_pos = torch.full((lanes * (S + 1),), nbits, dtype=i64, device=dev)
    a_pos = a_pos.scatter_reduce(0, flatidx, a_recs.reshape(-1),
                                 "amin").reshape(lanes, S + 1)

    # visited bitmap: recorded positions are unique, so a wrapping u32 add
    # is an or
    flat = a_recs.reshape(-1)
    bitmap = torch.zeros(bw, dtype=i64, device=dev)
    bitmap.index_add_(0, torch.clamp(flat >> 5, max=bw - 1),
                      torch.where(flat < nbits, torch.ones_like(flat)
                                  << (flat & 31), torch.zeros_like(flat)))
    bitmap = bitmap & _M32

    # lanes whose clamped segment is empty never hold symbols
    degenerate = seg_start >= seg_end
    dead = torch.full_like(seg_start, DEAD)

    def entries_from(exits):
        e = torch.where(degenerate, dead, exits).reshape(B, nseg)
        ent = torch.cat([sym_starts[:, None], e[:, :-1]], 1).reshape(-1)
        return torch.where(degenerate, dead, ent)

    entry = entries_from(a_exit)
    err = torch.zeros((), dtype=i64, device=dev)
    d_recs = a_recs[:S]
    q = torch.full_like(entry, big)
    live = ~degenerate
    for it in range(fix_iters):
        d_recs, d_exit, q = walk(entry, S, bitmap)
        exit_sel = torch.where(q < big, a_exit, d_exit)
        new_entry = entries_from(exit_sel)
        if it == fix_iters - 1:
            # unconverged or still-broken entries: the caller falls back
            err = (((new_entry != entry) & live).sum()
                   + ((new_entry == nbits + 1) & live).sum())
        entry = new_entry

    nb_ = torch.full_like(d_recs, nbits)
    d_slots = torch.where(d_recs < q[None, :], d_recs, nb_)   # (S, lanes)
    a_slots = torch.where(a_pos >= q[:, None], a_pos,
                          torch.full_like(a_pos, nbits))       # (lanes, S+1)
    slots = torch.cat([d_slots.T, a_slots], 1)
    return slots.reshape(-1), err


def anchored_walk(words: torch.Tensor, ltab: torch.Tensor,
                  dtab: torch.Tensor, tb: torch.Tensor, starts: torch.Tensor,
                  ends: torch.Tensor, steps: int = ANCHOR_STRIDE):
    """Exact decode walks between known symbol anchors: each lane decodes
    `steps` symbols from its start anchor. A lane finishes by landing on or
    past its end anchor (past it is an overshoot: err) or by decoding the
    block's EOB; an invalid entry or an unfinished lane also errs. Lanes
    with starts < 0 are inactive.

    Returns (outlen, lit, dist: (L, steps) int64 slot arrays, err)."""
    tb = tb.to(torch.int64)
    ends = ends.to(torch.int64)
    p = starts.to(torch.int64)
    done = p < 0
    errs = torch.zeros_like(done)
    zero = torch.zeros_like(p)
    outs, lits, dists = [], [], []
    for _ in range(steps):
        active = ~done
        nxt, outlen, lit, dist, invalid, is_eob = f_eval(
            words, ltab, dtab, tb, torch.clamp(p, min=0))
        outs.append(torch.where(active, outlen, zero))
        lits.append(torch.where(active, lit, zero))
        dists.append(torch.where(active, dist, zero))
        errs = errs | (active & invalid) | (active & ~is_eob & (nxt > ends))
        done = done | (active & (is_eob | (nxt >= ends)))
        p = torch.where(active, nxt, p)
    err = errs.sum() + (~done).sum()
    return (torch.stack(outs, 1), torch.stack(lits, 1),
            torch.stack(dists, 1), err)


def orbits(f_local: torch.Tensor, starts: torch.Tensor,
           max_syms: int) -> torch.Tensor:
    """P[b, m] = f^m(starts[b]) for all blocks at once (pointer doubling).

    f_local: (nbits + 1,) with an absorbing sentinel at nbits."""
    p = starts.to(torch.int64)[:, None]
    j = f_local.to(torch.int64)
    while p.shape[1] < max_syms:
        p = torch.cat([p, _take(j, p.reshape(-1)).reshape(p.shape)], 1)
        if p.shape[1] < max_syms:
            j = _take(j, j)
    return p[:, :max_syms]
