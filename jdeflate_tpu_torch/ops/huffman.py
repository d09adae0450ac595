"""Huffman code lengths and canonical codes, batched over a leading dimension
(port of jdeflate_tpu/ops/huffman.py, whose functions are vmapped).

Reference behavior reproduced: minimum-redundancy code lengths limited to
15/7 bits (src/deflator.c:933-1081, 991-1028), degenerate trees forced to
>= 2 symbols (src/deflator.c:1138-1178), canonical codes bit-reversed for
the LSB-first stream (src/deflator.c:1188-1285).

Every sort is stable, as in the JAX package: tied frequencies must order
by symbol index, or another tree comes out.

The two-queue code lengths of levels 8-9 are the kernel csrc/huffman2q.cu on a
card (code_lengths), with code_lengths_ref its plain version.
"""
from __future__ import annotations

import ctypes

import torch

_INF = 0x3FFFFFFF


def _stable_argsort(key):
    return torch.sort(key, dim=-1, stable=True).indices


def _scatter_back(order, vals):
    """out[g, order[g, i]] = vals[g, i]."""
    return torch.zeros_like(vals).scatter_(1, order, vals)


def code_lengths(freqs: torch.Tensor, max_bits: int) -> torch.Tensor:
    """Two-queue code lengths: csrc/huffman2q.cu on a CUDA tensor,
    code_lengths_ref on a CPU tensor; same arguments and result. The
    kernel builds each row's tree on one warp, in one launch on the current
    stream for all rows. Counts its kernel launches in
    code_lengths.launches."""
    if freqs.device.type == "cpu":
        return code_lengths_ref(freqs, max_bits)
    from . import _cuda
    dev = freqs.device
    f = freqs.to(torch.int64).contiguous()
    G, n = f.shape
    if not 1 <= n <= 288 or not 1 <= max_bits <= 15:
        raise ValueError(f"two-queue code lengths: {n} symbols at "
                         f"{max_bits} bits")
    out = torch.empty((G, n), dtype=torch.int64, device=dev)
    fn = _cuda.entry("huffman2q", "jd_code_lengths", [ctypes.c_void_p] * 2
                     + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    with torch.cuda.device(dev):
        rc = fn(f.data_ptr(), out.data_ptr(), G, n, max_bits,
                _cuda.stream_ptr())
    _cuda.check(rc, "two-queue code lengths kernel launch")
    code_lengths.launches += 1
    return out


code_lengths.launches = 0


def code_lengths_ref(freqs: torch.Tensor, max_bits: int) -> torch.Tensor:
    """Length-limited code lengths by the two-queue Huffman merge plus the
    zlib-style overflow repair (the reference's computelengths +
    limitlengths). freqs: (G, n) -> (G, n) int64 lengths.

    The merge is a sequential loop of n-1 steps, vectorised over groups."""
    f = freqs.to(torch.int64)
    G, n = f.shape
    dev = f.device
    rows = torch.arange(G, device=dev)
    m = (f > 0).sum(1)

    key = torch.where(f > 0, f, torch.full_like(f, _INF))
    order = _stable_argsort(key)               # used symbols first, freq asc
    wleaf = torch.cat([key.gather(1, order),
                       torch.full((G, 1), _INF, dtype=torch.int64,
                                  device=dev)], 1)

    li = torch.zeros(G, dtype=torch.int64, device=dev)
    ni = torch.zeros(G, dtype=torch.int64, device=dev)
    node_w = torch.full((G, n), _INF, dtype=torch.int64, device=dev)
    leaf_par = torch.zeros((G, n + 1), dtype=torch.int64, device=dev)
    node_par = torch.zeros((G, n), dtype=torch.int64, device=dev)
    def set_where(par, idx, sel, t):
        i = idx[:, None]
        par.scatter_(1, i, torch.where(sel[:, None], t, par.gather(1, i)))

    for t in range(n - 1):
        valid = t < m - 1
        ws = []
        for _ in range(2):
            # reads past the ends clamp, as XLA's gathers do (weights that
            # saturate at _INF can run a cursor onto the padding)
            li_c = li.clamp(max=n)
            ni_c = ni.clamp(max=n - 1)
            lw = wleaf[rows, li_c]
            nw = node_w[rows, ni_c]
            take_leaf = lw <= nw
            ws.append(torch.where(take_leaf, lw, nw))
            lsel = valid & take_leaf
            nsel = valid & ~take_leaf
            set_where(leaf_par, li_c, lsel, t)
            set_where(node_par, ni_c, nsel, t)
            li = li + lsel.to(torch.int64)
            ni = ni + nsel.to(torch.int64)
        node_w[:, t] = torch.where(
            valid, torch.clamp(ws[0] + ws[1], max=_INF), node_w[:, t])

    # node depths: parents have larger indices; sweep from the root down
    root = torch.clamp(m - 2, min=0)
    depth = torch.zeros((G, n), dtype=torch.int64, device=dev)
    for i in range(n - 2, -1, -1):
        d = torch.where(root == i, torch.zeros_like(root),
                        depth[rows, node_par[:, i]] + 1)
        depth[:, i] = d

    leaf_rank = torch.arange(n, dtype=torch.int64, device=dev)[None, :]
    leaf_depth = depth.gather(1, leaf_par[:, :n]) + 1
    is_leaf = leaf_rank < m[:, None]
    leaf_depth = torch.where(is_leaf, leaf_depth, torch.zeros_like(leaf_depth))

    clamped = torch.clamp(leaf_depth, max=max_bits)
    bl_count = torch.zeros((G, max_bits + 1), dtype=torch.int64, device=dev)
    bl_count.scatter_add_(1, clamped, is_leaf.to(torch.int64))
    bl_count[:, 0].fill_(0)
    bits_idx = torch.arange(max_bits + 1, dtype=torch.int64, device=dev)
    excess = torch.where(
        m >= 2,
        (bl_count << torch.clamp(max_bits - bits_idx, min=0)).sum(1)
        - (1 << max_bits), torch.zeros_like(m))
    # Kraft excess repair: each step moves one leaf one level down, pairing
    # it with an overflowed leaf, and takes one unit off the excess. The
    # reference loops while the excess is positive; here a fixed number of
    # masked steps runs, so no step reads the device back. The bound: the
    # excess is the sum, over the t internal nodes at depth max_bits, of
    # (leaves below - 1), that is m - s - t with s the leaves at depths
    # 1..max_bits; in a full binary tree with a node at depth max_bits,
    # s + t >= max_bits + 1 (a_1 = 2 and a_d >= 2 nodes at each depth d,
    # s + t = a_1 + sum over d = 2..max_bits of a_d / 2). So the excess is
    # at most m - max_bits - 1 <= n - max_bits - 1, which the caterpillar
    # tree of Fibonacci frequencies reaches.
    for _ in range(max(n - max_bits - 1, 0)):
        act = (excess > 0).to(torch.int64)
        cand = torch.where((bl_count > 0) & (bits_idx < max_bits)
                           & (bits_idx > 0), bits_idx, torch.zeros_like(
                               bits_idx))
        b = cand.max(1).values
        bl_count.scatter_add_(1, b[:, None], -act[:, None])
        bl_count.scatter_add_(1, (b + 1)[:, None], 2 * act[:, None])
        bl_count[:, max_bits] -= act
        excess = excess - act

    # redistribute: sorted-desc-by-freq leaves get ascending lengths
    cum = torch.cumsum(bl_count, 1).contiguous()
    pos = leaf_rank.expand(G, n).contiguous()
    length_at_pos = torch.searchsorted(cum, pos, right=True)
    slot = torch.clamp(m[:, None] - 1 - leaf_rank, 0, n - 1)
    leaf_len = torch.where(is_leaf, length_at_pos.gather(1, slot),
                           torch.zeros_like(slot))
    return _scatter_back(order, _degenerate(leaf_len, leaf_rank, m))


def _degenerate(leaf_len, rank, m):
    """A single used symbol gets a second (unused) one beside it, so every
    emitted tree is complete (computelengths, deflator.c:1138-1178)."""
    m = m[:, None]
    one = torch.where(rank <= 1, 1, 0).to(leaf_len.dtype).expand_as(leaf_len)
    leaf_len = torch.where(m == 1, one, leaf_len)
    return torch.where(m == 0, torch.zeros_like(leaf_len), leaf_len)


def code_lengths_pm(freqs: torch.Tensor, max_bits: int) -> torch.Tensor:
    """Optimal length-limited code lengths by boundary package-merge.
    freqs: (G, n) -> (G, n) int64 lengths. Same contract as code_lengths,
    never worse: it minimises sum(f*l) under the Kraft budget and
    l <= max_bits exactly."""
    f = freqs.to(torch.int64)
    G, n = f.shape
    dev = f.device
    L = max_bits
    used = f > 0
    m = used.sum(1)

    key = torch.where(used, f, torch.full_like(f, _INF))
    order = _stable_argsort(key)               # used first, weight ascending
    w = key.gather(1, order)
    rank = torch.arange(n, dtype=torch.int64, device=dev)[None, :]
    leaf_tag = (rank < m[:, None]).to(torch.int64)

    zeros_n = torch.zeros((G, n), dtype=torch.int64, device=dev)
    lw = torch.cat([w, torch.full((G, n), _INF, dtype=torch.int64,
                                  device=dev)], 1)
    lt = torch.cat([leaf_tag, zeros_n], 1)
    A = [torch.cumsum(lt, 1)]                  # per-level leaf-count prefixes
    merged_t = torch.cat([leaf_tag, zeros_n], 1)
    for _ in range(L - 1):
        pk = torch.clamp(lw[:, 0::2] + lw[:, 1::2], max=_INF)   # packages
        merged_w = torch.cat([w, pk], 1)
        # leaves first on weight ties
        k2, idx = torch.sort(merged_w * 2 + (1 - merged_t), dim=1,
                             stable=True)
        lt = merged_t.gather(1, idx)
        lw = k2 >> 1
        A.append(torch.cumsum(lt, 1))

    # backward taken-prefix counts; a_l = leaves among the first n_l items
    nl = torch.clamp(2 * m - 2, min=0)
    lengths_sorted = torch.zeros((G, n), dtype=torch.int64, device=dev)
    for lv in range(L - 1, -1, -1):
        at = A[lv].gather(1, torch.clamp(nl - 1, min=0)[:, None])[:, 0]
        al = torch.where(nl > 0, at, torch.zeros_like(at))
        lengths_sorted += (rank < al[:, None]).to(torch.int64)
        nl = 2 * (nl - al)

    leaf_len = torch.where(rank < m[:, None], lengths_sorted,
                           torch.zeros_like(lengths_sorted))
    return _scatter_back(order, _degenerate(leaf_len, rank, m))


def canonical_codes(lengths: torch.Tensor, max_bits: int):
    """Canonical codes for (G, n) lengths: (codes_msb, codes_lsb_rev), int64.

    codes_msb follow RFC 1951 §3.2.2; codes_lsb_rev are bit-reversed within
    their length for LSB-first emission (cf. deflator.c:1083-1136)."""
    l = lengths.to(torch.int64)
    G, n = l.shape
    dev = l.device
    bl_count = torch.zeros((G, max_bits + 1), dtype=torch.int64, device=dev)
    bl_count.scatter_add_(1, l, (l > 0).to(torch.int64))
    bl_count[:, 0].fill_(0)

    first = torch.zeros((G, max_bits + 2), dtype=torch.int64, device=dev)
    code = torch.zeros(G, dtype=torch.int64, device=dev)
    for b in range(1, max_bits + 1):
        code = (code + bl_count[:, b - 1]) << 1
        first[:, b] = code

    key = torch.where(l > 0, l, torch.full_like(l, _INF))
    order = _stable_argsort(key)               # by length asc, index asc
    l_sorted = key.gather(1, order).contiguous()
    group_start = torch.searchsorted(l_sorted, l_sorted, right=False)
    rank = torch.arange(n, dtype=torch.int64, device=dev)[None, :] - group_start
    codes_sorted = first.gather(1, torch.clamp(l_sorted, 0, max_bits)) + rank
    codes = _scatter_back(order, codes_sorted)
    codes = torch.where(l > 0, codes, torch.zeros_like(codes))

    rev = torch.zeros_like(codes)
    for b in range(max_bits):
        bit = (codes >> b) & 1
        out_pos = l - 1 - b
        rev = rev | torch.where(out_pos >= 0,
                                bit << torch.clamp(out_pos, min=0),
                                torch.zeros_like(bit))
    return codes, rev


def build_codes(freqs: torch.Tensor, max_bits: int):
    """Batched: freqs (G, n) -> (lengths, codes_msb, codes_rev), each (G, n)."""
    lengths = code_lengths(freqs, max_bits)
    codes, rev = canonical_codes(lengths, max_bits)
    return lengths, codes, rev
