"""LZ77 match finding and parse resolution (port of jdeflate_tpu/ops/lz77.py).

Reference behavior reproduced: the deflator's per-hash chains (hash mult
0x1e35a7bd, src/deflator.c:32-70, 1930-1947) become a (hash, pos) sort whose
k preceding same-hash entries are the first k candidates the chain walk
visits; lengths are exact up to the 258-byte cap (getmatchlength,
src/deflator.c:1977-2101); the parse is greedy for levels 1-5 and lazy for
6-9 (compress1/compress2) as a local decision rule (parse_take) plus one
sequential walk in match space: the kernel csrc/lz77walk.cu
(match_walk), with match_walk_ref its plain version. The chain walk itself
is the kernel csrc/lz77probe.cu (match_probe), with match_probe_ref its
plain version, and the exact extension's top-distance runs the kernel
csrc/lz77extend.cu (extend_top), with extend_top_ref its plain version.

Arrays keep the reference's flat batch layout: (B, row) rows with row =
halo + bl + pad. u32 words and hashes live in int64 tensors masked to 32
bits (PyTorch has no u32 shifts on the CPU): the hash
(w * 0x1E35A7BD) >> 17 is ((w * 0x1E35A7BD) & 0xFFFFFFFF) >> 17 here.
"""
from __future__ import annotations

import ctypes

import torch

from ..formats import constants as C
from . import scan

HASH_MULT = 0x1E35A7BD            # cf. deflator.c:1946
HASH_BITS = 15
M32 = 0xFFFFFFFF

WALK_CAP = 176 * 128              # plist slots per block (>= bl/3 + 128)


def _hash(w, bits: int):
    return ((w * HASH_MULT) & M32) >> (32 - bits)


def _floor_log2(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(x)) for positive ints <= 2^24 via f32 exponent bits."""
    bits = x.to(torch.float32).view(torch.int32).to(torch.int64)
    return ((bits >> 23) & 0xFF) - 127


def _words_le_flat(ext: torch.Tensor) -> torch.Tensor:
    """w[p] = the 4 bytes at p as a little-endian u32 over a flat buffer
    (bytes past the end read as zero)."""
    e = ext.to(torch.int64)
    z = torch.zeros(3, dtype=torch.int64, device=e.device)
    ez = torch.cat([e, z])
    n = e.shape[0]
    return (e | (ez[1:n + 1] << 8) | (ez[2:n + 2] << 16)
            | (ez[3:n + 3] << 24))


def _lead_eq_bytes(x: torch.Tensor) -> torch.Tensor:
    """Number of leading (low-order) equal bytes given the XOR x."""
    return (((x & 0xFF) == 0).to(torch.int64)
            + ((x & 0xFFFF) == 0).to(torch.int64)
            + ((x & 0xFFFFFF) == 0).to(torch.int64))


def _cmp16(w, a, b):
    """Exact common-prefix length of ext[a:] vs ext[b:] capped at 16 bytes.
    a, b: flat indices, clamped into w (an index outside belongs to a slot
    whose result the caller discards)."""
    hi = w.shape[0] - 1
    l = torch.zeros_like(a)
    run = torch.ones_like(a, dtype=torch.bool)
    first_x = torch.zeros_like(a)
    for t in range(4):
        wa = w[torch.clamp(a + 4 * t, 0, hi)]
        wb = w[torch.clamp(b + 4 * t, 0, hi)]
        eq = wa == wb
        first_x = torch.where(run & ~eq, wa ^ wb, first_x)
        l = l + torch.where(run & eq, 4, 0)
        run = run & eq
    return torch.clamp(
        l + torch.where(l < 16, _lead_eq_bytes(first_x), 0), max=16)


def _shift_left_cols(a, k: int):
    """b[:, j] = a[:, j + k], zero past the end."""
    return torch.cat([a[:, k:], torch.zeros_like(a[:, :k])], 1)


def _word_cols(e64, off: int, nh: int):
    """w[:, p] = the 4 bytes at p + off of each row, a little-endian u32."""
    return (e64[:, off:off + nh] | (e64[:, off + 1:off + 1 + nh] << 8)
            | (e64[:, off + 2:off + 2 + nh] << 16)
            | (e64[:, off + 3:off + 3 + nh] << 24))


def probe_keys(e64, nh: int):
    """(w0, skey) of (B, row) int64 byte rows: w0[:, p] the 4-byte word at
    each position p < nh, skey each row's (hash << 17 | p) keys sorted
    (unique, since the position is in the key)."""
    w0 = _word_cols(e64, 0, nh)
    pos = torch.arange(nh, dtype=torch.int64, device=e64.device)[None, :]
    return w0, torch.sort((_hash(w0, HASH_BITS) << 17) | pos, dim=1).values


def match_probe_ref(ext, skey, valid_from, k: int, probe_words: int):
    """Plain version of the bucket probe (any device, no host reads).

    ext: (B, row) u8 rows; skey: (B, nh) int64 sorted (hash << 17 | pos)
    keys of positions [0, nh) of each row; valid_from: (B,) ints. For each
    sorted index j and kk = 1..k, the candidate j - kk counts when it lies
    in the row, has j's hash, a distance in (0, WINDOW_SIZE] and a position
    >= valid_from; its length is the common prefix of the two positions'
    first 4 * probe_words bytes (probe_words co-sorted 4-byte words), and a
    strictly longer one replaces the best. Returns (plen, pdist), (B, nh)
    int64 in position order."""
    B, nh = skey.shape
    dev = ext.device
    e64 = ext.to(torch.int64)
    spos = skey & 0x1FFFF
    shash = skey >> 17
    svfrom = valid_from.to(torch.int64)[:, None]
    pos = torch.arange(nh, dtype=torch.int64, device=dev)[None, :].expand(
        B, nh)
    PW = probe_words
    sw = [_word_cols(e64, 4 * t, nh).gather(1, spos) for t in range(PW)]

    best_len = torch.zeros((B, nh), dtype=torch.int64, device=dev)
    best_dist = torch.zeros((B, nh), dtype=torch.int64, device=dev)
    for kk in range(1, k + 1):
        cpos = torch.roll(spos, kk, 1)
        chash = torch.roll(shash, kk, 1)
        dist = spos - cpos
        ok = ((pos >= kk) & (chash == shash) & (dist > 0)
              & (dist <= C.WINDOW_SIZE) & (cpos >= svfrom))
        l = torch.zeros((B, nh), dtype=torch.int64, device=dev)
        run = torch.ones((B, nh), dtype=torch.bool, device=dev)
        firstx = torch.zeros((B, nh), dtype=torch.int64, device=dev)
        for t in range(PW):
            ct = torch.roll(sw[t], kk, 1)
            eq = sw[t] == ct
            firstx = torch.where(run & ~eq, sw[t] ^ ct, firstx)
            l = l + torch.where(run & eq, 4, 0)
            run = run & eq
        l32 = torch.clamp(
            l + torch.where(l < 4 * PW, _lead_eq_bytes(firstx), 0),
            max=4 * PW)
        l32 = torch.where(ok, l32, 0)
        better = l32 > best_len
        best_len = torch.where(better, l32, best_len)
        best_dist = torch.where(better, dist, best_dist)

    # back to position order: spos is a permutation of [0, nh) per row
    plen = torch.zeros_like(best_len).scatter_(1, spos, best_len)
    pdist = torch.zeros_like(best_dist).scatter_(1, spos, best_dist)
    return plen, pdist


def match_probe(ext, skey, valid_from, k: int, probe_words: int):
    """The bucket probe: csrc/lz77probe.cu on a CUDA tensor,
    match_probe_ref on a CPU tensor; same arguments and result. The kernel
    walks each sorted index's same-hash predecessors and stops at the
    first that fails a condition, or at the length cap, which returns the
    plain loop's result. Counts its kernel launches in
    match_probe.launches."""
    if ext.device.type == "cpu":
        return match_probe_ref(ext, skey, valid_from, k, probe_words)
    from . import _cuda
    dev = ext.device
    B, row = ext.shape
    nh = skey.shape[1]
    _cuda.check_tensor(ext, "ext", torch.uint8, dev)
    _cuda.check_tensor(skey, "skey", torch.int64, dev, (B, nh))
    if probe_words not in (8, 16) or row < nh + 4 * probe_words + 4 \
            or nh > 1 << 17:
        raise ValueError(f"match probe: {probe_words} words over rows of "
                         f"{row} B with {nh} positions")
    vf = valid_from.to(torch.int64).contiguous()
    _cuda.check_tensor(vf, "valid_from", torch.int64, dev, (B,))
    fn = _cuda.entry("lz77probe", "jd_match_probe", [ctypes.c_void_p] * 5
                     + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    # the kernel writes every position: spos is a permutation of [0, nh)
    plen = torch.empty((B, nh), dtype=torch.int64, device=dev)
    pdist = torch.empty((B, nh), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        rc = fn(ext.data_ptr(), skey.data_ptr(), vf.data_ptr(),
                plen.data_ptr(), pdist.data_ptr(), B, row, nh, k,
                probe_words, C.WINDOW_SIZE, _cuda.stream_ptr())
    _cuda.check(rc, "match probe kernel launch")
    match_probe.launches += 1
    return plen, pdist


match_probe.launches = 0


def top_distances(plen, pdist, T: int):
    """The T distances with the most boundary-capped mass (a length > 0,
    a multiple of 16, under 258) over every 4th flat position of (B, nh)
    int64 (plen, pdist): (T,) int64 on their device, distinct, most first,
    ties and zero-count bins by the lower distance, 0 counted as none."""
    dev = plen.device
    stuck0 = (plen > 0) & (plen % 16 == 0) & (plen < 258)
    dws = torch.where(stuck0, pdist, 0).reshape(-1)[::4]
    # distances are at most WINDOW_SIZE: a histogram of fixed length (a
    # bincount would read its length back from the device)
    hist = torch.zeros(C.WINDOW_SIZE + 1, dtype=torch.int64, device=dev)
    hist.scatter_add_(0, dws, torch.ones_like(dws))
    hist[0].fill_(0)
    # lax.top_k breaks ties by lower index: a stable descending sort does too
    return torch.sort(hist, descending=True, stable=True).indices[:T]


def extend_top_ref(ext, plen, pdist, topd):
    """Plain version of the exact extension's stage 1 (any device, no host
    reads).

    ext: (B, row) u8 rows; plen, pdist: (B, nh) int64, nh <= row; topd:
    (T,) int64 distinct distances. For each d of topd, every position j
    with pdist == d and a length > 0 takes the suffix run of
    ext[j] == ext[j - d] (to the first mismatch or the row's end; 0 where
    j < d), capped at MAX_MATCH. Returns the new plen, (B, nh) int64."""
    B, row = ext.shape
    nh = plen.shape[1]
    dev = ext.device
    e64 = ext.to(torch.int64)
    col_row = torch.arange(row, dtype=torch.int64, device=dev)[None, :]
    BIG = 1 << 20
    pl2 = plen
    for t in range(topd.shape[0]):
        d = topd[t]
        # jnp.roll(ext, d)[j] = ext[j - d] for j >= d (the rest is masked)
        src = torch.clamp(col_row - d, min=0).expand(B, row)
        eq = (e64 == e64.gather(1, src)) & (col_row >= d)
        nz = torch.where(eq, BIG, col_row)
        nnm = torch.flip(torch.cummin(torch.flip(nz, [1]), 1).values, [1])
        runlen = torch.clamp(nnm, max=row) - col_row
        runlen = torch.clamp(runlen[:, :nh], max=C.MAX_MATCH)
        sel = (pdist == d) & (pl2 > 0)
        pl2 = torch.where(sel, runlen, pl2)
    return pl2


def extend_top(ext, plen, pdist, topd):
    """The exact extension's stage 1: csrc/lz77extend.cu on a CUDA tensor,
    extend_top_ref on a CPU tensor; same arguments and result. The kernel
    takes each position once: the distances of topd are distinct, so at
    most one of the plain loop's passes selects it. Counts its kernel
    launches in extend_top.launches."""
    if ext.device.type == "cpu":
        return extend_top_ref(ext, plen, pdist, topd)
    from . import _cuda
    dev = ext.device
    B, row = ext.shape
    nh = plen.shape[1]
    T = topd.shape[0]
    _cuda.check_tensor(ext, "ext", torch.uint8, dev)
    _cuda.check_tensor(plen, "plen", torch.int64, dev, (B, nh))
    _cuda.check_tensor(pdist, "pdist", torch.int64, dev, (B, nh))
    _cuda.check_tensor(topd, "topd", torch.int64, dev, (T,))
    if nh > row or T > 64:
        raise ValueError(f"exact extension: {nh} positions over rows of "
                         f"{row} B, {T} distances")
    fn = _cuda.entry("lz77extend", "jd_match_extend", [ctypes.c_void_p] * 5
                     + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    out = torch.empty_like(plen)
    with torch.cuda.device(dev):
        rc = fn(ext.data_ptr(), plen.data_ptr(), pdist.data_ptr(),
                topd.data_ptr(), out.data_ptr(), B, row, nh, T,
                _cuda.stream_ptr())
    _cuda.check(rc, "exact extension kernel launch")
    extend_top.launches += 1
    return out


extend_top.launches = 0


def find_matches_batch(ext: torch.Tensor, block_len: torch.Tensor,
                       valid_from: torch.Tensor, halo: int, bl: int, pad: int,
                       k: int, exact_ext: bool = True, ext_top: int = 8,
                       ext_rounds: int = 4, rescue: bool = False,
                       probe_words: int = 8, ext_mdiv: int = 16):
    """Best match per position for a batch of blocks.

    ext: (B, halo + bl + pad) u8 rows (halo history + block + zero pad).
    block_len, valid_from: (B,) ints. Returns (length, dist): (B, bl) int64.

    The (hash, pos) key is sorted, so the chain walk becomes a probe of
    each sorted index's k predecessors (match_probe: the kernel
    csrc/lz77probe.cu on a card, match_probe_ref's k shifted compares of
    co-sorted prefix words on the CPU), with prefixes of 4 * probe_words
    bytes. Lengths then extend by the link rule LCP(i,d) = s + LCP(i+s,d),
    the suffix runs of the top-T distances (extend_top: the kernel
    csrc/lz77extend.cu on a card, extend_top_ref's T passes on the CPU),
    and compacted gather-compare rounds.
    """
    B = ext.shape[0]
    dev = ext.device
    nh = halo + bl
    e64 = ext.to(torch.int64)
    w0, skey = probe_keys(e64, nh)
    plen, pdist = match_probe(ext, skey, valid_from, k, probe_words)

    if rescue:
        # 3-byte secondary hash (levels >= 6): the reference's QBITS=14
        # short-match table (deflator.c:49-70, 2676-2711), rejecting len-3
        # beyond offset 8192 (deflator.c:2829-2831)
        pos = torch.arange(nh, dtype=torch.int64, device=dev)[None, :].expand(
            B, nh)
        svfrom = valid_from.to(torch.int64)[:, None]
        h3 = _hash(w0 & 0xFFFFFF, 14)
        sk3, perm3 = torch.sort((h3 << 17) | pos, dim=1)
        s3w = w0.gather(1, perm3)
        sp3 = sk3 & 0x1FFFF
        sh3 = sk3 >> 17
        r_len = torch.zeros((B, nh), dtype=torch.int64, device=dev)
        r_dist = torch.zeros((B, nh), dtype=torch.int64, device=dev)
        for kk in (1, 2):
            cp = torch.roll(sp3, kk, 1)
            chh = torch.roll(sh3, kk, 1)
            cw = torch.roll(s3w, kk, 1)
            dist3 = sp3 - cp
            ok3 = ((pos >= kk) & (chh == sh3) & (dist3 > 0)
                   & (dist3 <= 8192) & (cp >= svfrom)
                   & (((s3w ^ cw) & 0xFFFFFF) == 0) & (r_len == 0))
            r_len = torch.where(ok3, 3, r_len)
            r_dist = torch.where(ok3, dist3, r_dist)
        r_len = torch.zeros_like(r_len).scatter_(1, sp3, r_len)
        r_dist = torch.zeros_like(r_dist).scatter_(1, sp3, r_dist)
        use3 = (plen < C.MIN_MATCH) & (r_len == 3)
        plen = torch.where(use3, 3, plen)
        pdist = torch.where(use3, r_dist, pdist)

    # link extension: LCP(i,d) = s + LCP(i+s,d) when the distance matches
    for shift in (16, 32, 64, 128):
        nlen = _shift_left_cols(plen, shift)
        ndist = _shift_left_cols(pdist, shift)
        linked = (plen == shift) & (ndist == pdist)
        plen = torch.where(linked, shift + nlen, plen)
    n256l = _shift_left_cols(plen, 256)
    n256d = _shift_left_cols(pdist, 256)
    plen = torch.where((plen == 256) & (n256d == pdist) & (n256l >= 2),
                       258, plen)

    bpos = torch.arange(bl, dtype=torch.int64, device=dev)[None, :]
    blen = block_len.to(torch.int64)[:, None]

    def finish(plen):
        length = torch.minimum(torch.clamp(plen[:, halo:], max=C.MAX_MATCH),
                               blen - bpos)
        length = torch.where(length >= C.MIN_MATCH, length, 0)
        dist = torch.where(length > 0, pdist[:, halo:], 0)
        return length, dist

    if not exact_ext:
        return finish(plen)

    # Stage 1: for each of the T distances with the most boundary-capped
    # mass, the suffix run of ext[j] == ext[j - d] is the exact LCP at every
    # position whose match distance is d
    plen = extend_top(ext, plen, pdist, top_distances(plen, pdist, ext_top))

    # Stage 2: compacted gather-compare rounds for the residue. The
    # reference's loop stops when no boundary survivor remains, at most
    # ext_rounds rounds; here every round runs, masked: a round after the
    # last active one changes nothing, and no round reads the device back
    wflat = _words_le_flat(ext.reshape(-1))
    N = B * nh
    M = max(N // ext_mdiv, 1024)
    pl = plen.reshape(-1)
    pd = pdist.reshape(-1)
    fidx = torch.arange(N, dtype=torch.int64, device=dev)
    in_block = (fidx % nh) >= halo
    stuck = (pl > 0) & (pl % 16 == 0) & (pl < 258) & in_block
    sidx = torch.sort(torch.where(stuck, fidx, -1 - fidx)).values[-M:]
    valid = sidx >= 0
    si = torch.clamp(sidx, min=0)
    qi_s = si + (si // nh) * pad            # flat (B, nh) -> flat row index
    cand_s = qi_s - pd[si]
    lx = torch.where(valid, pl[si], 0)
    for _ in range(ext_rounds):
        active = (lx > 0) & (lx % 16 == 0) & (lx < 258)
        add = _cmp16(wflat, qi_s + lx, cand_s + lx)
        lx = torch.where(active, lx + add, lx)
    plx = torch.cat([pl, pl.new_zeros(1)])
    plx.scatter_(0, torch.where(valid, si, N),
                 torch.clamp(lx, max=C.MAX_MATCH))
    return finish(plx[:N].reshape(B, nh))


def _match_cost_bits(length, dist):
    """Approximate emitted bits of a match token: ~7-bit length code +
    length extra + ~6-bit distance code + distance extra."""
    n_ = torch.clamp(length - 3, min=0)
    lex = torch.where((n_ < 8) | (length >= 258), 0,
                      torch.clamp(_floor_log2(torch.clamp(n_, min=1)) - 2,
                                  min=0))
    dex = torch.clamp(_floor_log2(torch.clamp(dist, min=1)) - 2, min=0)
    return 13 + lex + dex


def parse_take(length, dist, block_len, lazy: bool, good_length: int):
    """Per-position candidate rule: would the sequential parser accept a
    match here if it arrives? (greedy: len > 3, compress1 deflator.c:2476;
    lazy: compress2's lookahead with the reference package's cost-aware
    deferral)."""
    B = length.shape[0]
    if not lazy:
        return length > C.MIN_MATCH
    ok = (length >= C.MIN_MATCH) & ~((length == C.MIN_MATCH) & (dist > 256))
    ln = torch.cat([length[:, 1:], length.new_zeros(B, 1)], 1)
    dn = torch.cat([dist[:, 1:], dist.new_ones(B, 1)], 1)
    ok_n = (ln >= C.MIN_MATCH) & ~((ln == C.MIN_MATCH) & (dn > 256))
    defer = ok_n & ((8 + _match_cost_bits(ln, dn)) * length
                    < _match_cost_bits(length, dist) * (1 + ln))
    return ok & ((length >= good_length) | ~defer)


def walk_inputs(length, take, block_len, bl: int):
    """The match walk's inputs: cnextp (next accepted candidate at or after
    p, bl when none) and lenp (max(length, 1)), each (B, bl + padn) int32
    with padn >= 1 columns of padding (bl and 1), as the reference builds
    them (lz77.py:463-472). The reference's further padding to whole SMEM
    chunks has no counterpart here."""
    B = length.shape[0]
    dev = length.device
    pos = torch.arange(bl, dtype=torch.int64, device=dev)[None, :]
    cand = torch.where(take & (pos < block_len.to(torch.int64)[:, None]),
                       pos, bl)
    cnext = scan.running(cand, "min", reverse=True)
    padn = (-(bl + 1)) % 128 + 1
    i32 = torch.int32
    cnextp = torch.cat([cnext.to(i32), torch.full((B, padn), bl, dtype=i32,
                                                  device=dev)], 1)
    lenp = torch.cat([torch.clamp(length, min=1).to(i32),
                      torch.ones((B, padn), dtype=i32, device=dev)], 1)
    return cnextp.contiguous(), lenp.contiguous()


def _check_cap(bl: int) -> None:
    # p has 17 bits in a plist entry; the list holds the worst-case count
    if bl > 1 << 17 or WALK_CAP < bl // 3 + 128:
        raise ValueError(f"match walk: block size {bl} exceeds the plist "
                         "capacity")


def match_walk_ref(cnextp, lenp, block_len, bl: int):
    """Plain version of the match walk (any device, no host reads).

    Pointer doubling on nxt = p + (take ? len : 1) over each block, where
    take[p] is cnextp[p] == p, gives the sequential parse's orbit; the
    orbit positions where take holds are the emitted matches, in order,
    compacted into the plist layout: (B, WALK_CAP) int32, slot 0 = count+1,
    slots 1..count = p | len << 17, zeros after."""
    _check_cap(bl)
    B = cnextp.shape[0]
    dev = cnextp.device
    pos = torch.arange(bl, dtype=torch.int64, device=dev)[None, :]
    cn = cnextp[:, :bl].to(torch.int64)
    ln = lenp[:, :bl].to(torch.int64)
    take = cn == pos
    blen = block_len.to(torch.int64)[:, None]
    nxt = torch.clamp(pos + torch.where(take, ln, 1), max=bl)
    nxt = torch.where(pos < blen, nxt, bl)
    nxt = torch.cat([nxt, torch.full((B, 1), bl, dtype=torch.int64,
                                     device=dev)], 1)
    base = (torch.arange(B, dtype=torch.int64, device=dev) * (bl + 1))[:, None]
    p = orbit_batch((nxt + base).reshape(-1), B, bl)        # (B, bl) local
    pc = torch.clamp(p, max=bl - 1)
    hit = (p < bl) & take.gather(1, pc)
    slot = torch.cumsum(hit.to(torch.int64), 1)             # 1-based
    val = pc | (ln.gather(1, pc) << 17)
    plist = torch.zeros((B, WALK_CAP + 1), dtype=torch.int64, device=dev)
    plist.scatter_(1, torch.where(hit, slot, WALK_CAP), val)
    plist[:, 0] = slot[:, -1] + 1
    return plist[:, :WALK_CAP].to(torch.int32)


def match_walk(cnextp, lenp, block_len, bl: int):
    """The match walk: csrc/lz77walk.cu on a CUDA tensor, match_walk_ref on
    a CPU tensor; same arguments and result. Counts its kernel launches in
    match_walk.launches."""
    if cnextp.device.type == "cpu":
        return match_walk_ref(cnextp, lenp, block_len, bl)
    from . import _cuda
    _check_cap(bl)
    dev = cnextp.device
    B, n = cnextp.shape
    if n <= bl:
        raise ValueError(f"match walk: want > {bl} columns, got {n}")
    _cuda.check_tensor(cnextp, "cnextp", torch.int32, dev)
    _cuda.check_tensor(lenp, "lenp", torch.int32, dev, (B, n))
    _cuda.check_tensor(block_len, "block_len", torch.int32, dev, (B,))
    fn = _cuda.entry("lz77walk", "jd_match_walk", [ctypes.c_void_p] * 5
                     + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    plist = torch.empty((B, WALK_CAP), dtype=torch.int32, device=dev)
    # the kernel's ping-pong jump tables, 2 x (bl + 1) per block
    jumps = torch.empty((B, 2, bl + 1), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = fn(cnextp.data_ptr(), lenp.data_ptr(), block_len.data_ptr(),
                plist.data_ptr(), jumps.data_ptr(), B, n, bl, WALK_CAP,
                _cuda.stream_ptr())
    _cuda.check(rc, "match walk kernel launch")
    match_walk.launches += 1
    return plist


match_walk.launches = 0


def token_marks_batch(length, take, block_len, bl: int):
    """Token flags for the whole batch: (is_tok, is_match), each (B, bl).

    is_match marks the match tokens the sequential greedy/lazy cursor would
    emit; is_tok also marks every literal position not covered by an
    emitted match. The match walk lists the emitted matches; scattering
    their starts and ends and a cumsum give the marks."""
    B = length.shape[0]
    dev = length.device
    cnextp, lenp = walk_inputs(length, take, block_len, bl)
    plist = match_walk(cnextp, lenp, block_len.to(torch.int32).contiguous(),
                       bl).to(torch.int64)
    cap = plist.shape[1]
    slot = torch.arange(cap, dtype=torch.int64, device=dev)[None, :]
    livem = (slot >= 1) & (slot < plist[:, :1])
    mp = torch.where(livem, plist & 0x1FFFF, bl)
    mlen = torch.where(livem, plist >> 17, 0)
    li = livem.to(torch.int64)
    ms = torch.zeros((B, bl + 1), dtype=torch.int64, device=dev)
    ms.scatter_add_(1, torch.clamp(mp, max=bl), li)
    me = torch.zeros((B, bl + 1), dtype=torch.int64, device=dev)
    me.scatter_add_(1, torch.clamp(mp + mlen, max=bl), li)
    ms, me = ms[:, :bl], me[:, :bl]
    active = torch.cumsum(ms - me, 1)
    is_match = ms > 0
    pos = torch.arange(bl, dtype=torch.int64, device=dev)[None, :]
    live = pos < block_len.to(torch.int64)[:, None]
    is_tok = (is_match | (active <= 0)) & live
    return is_tok, is_match & live


def parse_batch(length, dist, block_len, bl: int, lazy: bool,
                good_length: int):
    """Local greedy/lazy decision -> flat next[] with per-block sentinels.

    Returns (next_flat (B*(bl+1),), take (B, bl)): block b's positions live
    at [b*(bl+1), b*(bl+1)+bl] with an absorbing sentinel at local index
    bl."""
    B = length.shape[0]
    dev = length.device
    take = parse_take(length, dist, block_len, lazy, good_length)
    i = torch.arange(bl, dtype=torch.int64, device=dev)[None, :]
    nxt = torch.clamp(i + torch.where(take, length, 1), max=bl)
    nxt = torch.where(i < block_len.to(torch.int64)[:, None], nxt, bl)
    nxt = torch.cat([nxt, torch.full((B, 1), bl, dtype=torch.int64,
                                     device=dev)], 1)
    base = (torch.arange(B, dtype=torch.int64, device=dev) * (bl + 1))[:, None]
    return (nxt + base).reshape(-1), take


def orbit_batch(next_flat, B: int, bl: int):
    """P[b, m] = next^m(start_b) for every block via flat pointer doubling.

    next_flat: (B*(bl+1),) absolute indices with absorbing per-block
    sentinels. Returns (B, bl) orbit positions, local to the block (bl is
    the sentinel)."""
    dev = next_flat.device
    base = (torch.arange(B, dtype=torch.int64, device=dev) * (bl + 1))[:, None]
    p = base
    j = next_flat.to(torch.int64)
    while p.shape[1] < bl:
        p = torch.cat([p, j[p.reshape(-1)].reshape(p.shape)], 1)
        if p.shape[1] < bl:
            j = j[j]
    return p[:, :bl] - base
