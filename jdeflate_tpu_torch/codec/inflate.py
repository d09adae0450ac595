"""Block-parallel DEFLATE decoder on a CUDA device (or the CPU).

Given an index of block bit offsets, every Huffman batch decodes on the
device through one of three branches, chosen per batch by what the index
holds for its blocks:

  * "win" (32-bit window anchors: free from the encoder, recovered by the
    native indexer for foreign streams): the window walk (ops/walk.py, one
    lane per 32 stream bits) and the token expansion, ops/expand2.py by
    default or the v5 engine ops/expand5.py when JDT_EXPAND=5;
  * "anchored" (symbol anchors, every 64th symbol's bit offset): exact
    64-symbol walks between anchors (ops/decode.py::anchored_walk), then
    the v1 match expansion (ops/expand.py) when every block outputs at most
    64 KiB on a CUDA device, else the plain assemble_output;
  * "dense" (neither): a speculative decode at every bit position and
    segmented orbits (ops/decode.py), then assemble_output.

A 32 KiB halo chains the batches like the reference's ring window
(inflator.c:616-675). Stored blocks are host copies. Port of
jdeflate_tpu/codec/inflate.py.

The sequential correctness referee for arbitrary streams is
stream.host_inflate, and the native inflator re-decodes from the first
batch whose checks fail.
"""
from __future__ import annotations

import collections
import os

import numpy as np
import torch

from .. import trace
from ..formats import constants as C
from ..ops import decode as dk
from ..ops import expand as ex
from ..ops import expand2 as ex2
from ..ops import expand5 as ex5
from ..ops import walk as wk
from ..stream import host_inflate as hi
from ..stream import native
from ..utils import device as _device
from ..utils import errors
from . import program

HALO = C.WINDOW_SIZE

# Dispatch log: every RawInflater.decompress appends one (kind, produced,
# err) tuple per batch it ran ("stored"/"win"/"anchored"/"dense"). Callers
# clear() it before the operation they want to observe; decompress only
# appends, and the log keeps the newest STATS_KEEP entries.
STATS_KEEP = 1 << 16
STATS_LOG: collections.deque = collections.deque(maxlen=STATS_KEEP)


def card_bytes(stats: list) -> tuple[int, int]:
    """(bytes of device batches, bytes of stored copies) of one decompress,
    from its last_stats: the batches up to the first that errs; the native
    decoder produced the rest."""
    card = host = 0
    for k, p, e in stats:
        if e:
            break
        if k == "stored":
            host += p
        else:
            card += p
    return card, host

SEG_BITS = 64   # strided-speculation segment width (== record slots per walk)


def _bucket(n: int, base: int) -> int:
    b = base
    while b < n:
        b *= 2
    return b


def roll_window(win: torch.Tensor, chunk: torch.Tensor) -> torch.Tensor:
    """New 32 KiB window = last HALO bytes of (win ++ chunk), on the device
    so batches chain without a host readback: a stored chunk's roll (a
    decode batch rolls its window inside its program, _next_window)."""
    return torch.cat([win, chunk])[-HALO:]


def _next_window(halo, out, produced, out_cap: int) -> torch.Tensor:
    """The next batch's 32 KiB window: the last HALO bytes of
    (halo ++ out[:produced]), produced clamped into [0, out_cap] (the
    reference's roll_window)."""
    cat = torch.cat([halo, out[:out_cap]])
    p0 = torch.clamp(produced, 0, out_cap)
    return cat[p0 + torch.arange(HALO, device=cat.device)]


def _slice_words(words_full: torch.Tensor, word_lo: torch.Tensor,
                 wwords: int) -> torch.Tensor:
    """The batch's wwords-word window of the once-uploaded stream (int32
    words), cut on the device: word_lo is a 0-d device tensor, clamped
    into the stream like the reference's dynamic slice."""
    hi = max(words_full.shape[0] - wwords, 0)
    lo = torch.clamp(word_lo.to(torch.int64), 0, hi)
    return words_full[lo + torch.arange(wwords, device=words_full.device)]


def _u32(words: torch.Tensor) -> torch.Tensor:
    """int32 words as int64 u32 values (the legacy decode's word type)."""
    return words.to(torch.int64) & 0xFFFFFFFF


def _meta_len(npe: int, ne: int) -> int:
    """Length of a windowed batch's meta row (_win_meta's layout)."""
    return 2 + 2 * npe + npe * wk.PE_LANES + ne * 320


def _walk_args(words, meta, npe: int, ne: int, wwords: int):
    """Unpack one batch's meta row into the arguments of ops/walk.py::
    walk_checked (the first eight are walk_windows_ref's).

    words: the batch's word window, (wwords,) int32 (_slice_words).
    meta: [word_lo, hist, pe_word0(npe), pe_tab(npe), alanes(npe*PE),
           ll(ne*288), dl(ne*32)] as one (M,) i32 tensor; pe_word0 and the
           anchors are relative to the window.
    Returns (words, seg_word0, pe_tab, start_rel (npe*PE,), t1, t2a, t2b,
    t2c, pe_word0, hist), all views or results on meta's device. Each
    pseudo-entry's segment start clamps into the window (ROADMAP C5), as
    the reference's dynamic slice of its (PE + 8)-word segment does."""
    PE = wk.PE_LANES
    hist = meta[1]
    o = 2
    pe_word0 = meta[o:o + npe]
    o += npe
    pe_tab = meta[o:o + npe]
    o += npe
    alanes = meta[o:o + npe * PE].reshape(npe, PE)
    o += npe * PE
    ll = meta[o:o + ne * 288].reshape(ne, 288)
    o += ne * 288
    dl = meta[o:o + ne * 32].reshape(ne, 32)
    t1, t2a, t2b, t2c = wk.build_entry_tables(ll, dl)
    seg_word0 = wk.segment_starts(pe_word0, wwords).to(torch.int32)
    lanebit = (torch.clamp(pe_word0, min=0)[:, None]
               + torch.arange(PE, dtype=torch.int32,
                              device=meta.device)[None, :]) * 32
    start_rel = torch.where(alanes >= 0, alanes - lanebit,
                            torch.full_like(alanes, -1)).to(torch.int32)
    return (words, seg_word0, pe_tab, start_rel.reshape(-1), t1, t2a,
            t2b, t2c, pe_word0, hist)


def _walk_inputs(words_full, meta, npe: int, ne: int, wwords: int):
    """_walk_args of one batch from the whole stream's words: its window is
    cut at meta[0] first."""
    return _walk_args(_slice_words(words_full, meta[0], wwords), meta, npe, ne,
                      wwords)


def _decode_from_meta(words, meta, halo, npe: int, ne: int, out_cap: int,
                      wwords: int, engine: int = 2):
    """Decode one windowed batch from its word window ((wwords,) int32) and
    meta row. Returns (out (out_cap,) u8, produced, err, next_halo), all on
    the device; nothing is read back. The walk checks its exit chain and
    far offsets (ops/walk.py::walk_checked, in the kernel's epilogue on the
    card) and hands its lane offsets on. engine 5 expands through
    ops/expand5.py, any other value through ops/expand2.py."""
    tok_lm, _, outlen, laneoff, err_w = wk.walk_checked(
        *_walk_args(words, meta, npe, ne, wwords))
    if engine == 5:
        out, produced, kerr = ex5.expand_tokens(tok_lm, outlen, halo,
                                                out_cap, laneoff)
        aerr = kerr + (produced > out_cap).to(kerr.dtype)
    else:
        out, produced, aerr = ex2.expand_tokens(tok_lm, outlen, halo,
                                                out_cap, laneoff)
    return out, produced, err_w[0] + aerr, _next_window(halo, out, produced,
                                                        out_cap)


def _pe(produced, err) -> torch.Tensor:
    """(produced, err) as one (2,) int64 tensor: one copy into the
    decode's readback buffer."""
    return torch.stack([produced.to(torch.int64).reshape(()),
                        err.to(torch.int64).reshape(())])


def _windows_program(words, meta, halo, npe: int, ne: int, out_cap: int,
                     wwords: int, engine: int):
    """The windowed batch as a captured program: (out, (produced, err),
    next_halo)."""
    out, produced, err, nwin = _decode_from_meta(words, meta, halo, npe, ne,
                                                 out_cap, wwords, engine)
    return out, _pe(produced, err), nwin


def _windows_batch(words_full, metas, row, halo, npe: int, ne: int,
                   out_cap: int, wwords: int, engine: int):
    """Cut the batch's meta row and word window on the device (one gather
    each, the size of the batch), then run its program: the program's key
    holds only the batch's buckets, never the stream's length. A device
    `row` is read back first (indexing by a 0-d tensor reads it anyway).
    Returns (out, (produced, err), next_halo)."""
    if isinstance(row, torch.Tensor):
        row = int(_device.to_host(row))
    meta = metas[:, :_meta_len(npe, ne)][row]
    words = _slice_words(words_full, meta[0], wwords)
    return program.run(_windows_program, (words, meta, halo),
                       (npe, ne, out_cap, wwords, engine))


def decode_batch_windows_stacked(words_full, metas, row, halo,
                                 npe: int, ne: int, out_cap: int,
                                 wwords: int, engine: int = 2):
    """Row `row` (a 0-d device tensor, or an int) of the (B, M) stacked
    metadata, decoded from the once-uploaded stream's words as a captured
    program on a card. Returns (out (out_cap,) u8, produced, err,
    next_halo)."""
    out, pe, nwin = _windows_batch(words_full, metas, row, halo, npe, ne,
                                   out_cap, wwords, engine)
    return out, pe[0], pe[1], nwin


def _expand1_inputs(o_len, o_lit, o_dist, halo, out_cap: int,
                    first_slots, nblocks: int):
    """The v1 match expansion's inputs from token slots (the first half of
    the reference's _assemble_pallas). Literals: one scatter into the
    buffer behind the halo, with a drop slot. Matches: compacted to stream
    order by a stable sort on the slot index (every non-match carries key
    S, so the blocks' match ranges are the reference's). first_slots:
    (nblocks+1,) slot index of each block's first lane (lanes are
    block-contiguous).

    Returns (buf, (m_off, m_d, m_len, ranges), produced, err); err counts
    tokens reaching past HALO + out_cap."""
    dev = o_len.device
    i64 = torch.int64
    S = o_len.shape[0]
    o_len = o_len.to(i64)
    o_dist = o_dist.to(i64)
    off = HALO + torch.cumsum(o_len, 0) - o_len
    produced = o_len.sum()
    N = ((HALO + out_cap + ex.REGION) // 128 + 2) * 128
    buf = torch.zeros(N + 1, dtype=torch.uint8, device=dev)
    buf[:HALO] = halo
    is_tok = o_len > 0
    is_lit = is_tok & (o_dist == 0)
    buf = buf.scatter_(0, dk.drop_index(is_lit, off, N),
                       o_lit.to(torch.uint8))[:N]

    is_m = o_dist > 0
    slot = torch.arange(S, dtype=i64, device=dev)
    skey, order = torch.sort(torch.where(is_m, slot, torch.full_like(slot, S)),
                             stable=True)
    i32 = torch.int32
    fs = first_slots.to(i64)
    t0s = torch.searchsorted(skey, fs)
    out_ss = torch.where(fs >= S, HALO + produced, off[fs.clamp(0, S - 1)])
    ranges = torch.stack([t0s[:-1], t0s[1:], out_ss[:-1],
                          torch.zeros(nblocks, dtype=i64, device=dev)],
                         1).to(i32).contiguous()
    mats = (off[order].to(i32), o_dist[order].to(i32),
            o_len[order].to(i32), ranges)
    err = (is_tok & (off + o_len > HALO + out_cap)).sum()
    return buf, mats, produced, err


def _assemble_kernel(o_len, o_lit, o_dist, halo, out_cap: int,
                     first_slots, nblocks: int):
    """Token slots -> output bytes through the v1 match expansion
    (ops/expand.py), block by block; port of the reference's
    _assemble_pallas. Returns (out (out_cap,) u8, produced, err)."""
    buf, mats, produced, err = _expand1_inputs(
        o_len, o_lit, o_dist, halo, out_cap, first_slots, nblocks)
    buf = ex.expand_matches(buf, *mats)
    return buf[HALO:HALO + out_cap], produced, err


def _tables(ll, dl):
    return (dk.build_tables_batch(ll, *dk.litlen_attrs()),
            dk.build_tables_batch(dl, *dk.dist_attrs()))


def _anchored_slots(words, tb, starts, ends, ll, dl):
    """The anchored walks' token slots (len, lit, dist; flat) and err."""
    ltab, dtab = _tables(ll, dl)
    outlen, lit, dist, werr = dk.anchored_walk(words, ltab, dtab, tb,
                                               starts, ends)
    return (outlen.reshape(-1), lit.reshape(-1), dist.reshape(-1)), werr


def anchored_expand1_inputs(words, tb, starts, ends, ll, dl, halo,
                            nblocks: int, out_cap: int, first_slots):
    """The v1 match expansion's inputs (buf, mats, produced) of one
    anchored batch, from decode_batch_anchored's arguments, computed op by
    op: what a harness holds the expansion kernel to (a replayed program
    runs no Python, so nothing inside it can hand them out)."""
    slots, _ = _anchored_slots(words, tb, starts, ends, ll, dl)
    buf, mats, produced, _ = _expand1_inputs(*slots, halo, out_cap,
                                             first_slots, nblocks)
    return buf, mats, produced


def decode_batch_anchored(words, tb, starts, ends, ll, dl, halo,
                          lanes: int, nblocks: int, out_cap: int,
                          use_kernel: bool = False, first_slots=None):
    """Exact anchored decode: every lane walks 64 symbols from a known
    symbol anchor (no speculation, no dense f). words: the batch's int64
    word window; tb/starts/ends: (lanes,) table base, start and end anchor
    bits (window-local). Returns (out (out_cap,) u8, produced, err,
    next_halo)."""
    slots, werr = _anchored_slots(words, tb, starts, ends, ll, dl)
    if use_kernel:
        out, produced, aerr = _assemble_kernel(*slots, halo, out_cap,
                                               first_slots, nblocks)
    else:
        out, produced, aerr = dk.assemble_output(*slots, halo, out_cap)
    return out, produced, werr + aerr, _next_window(halo, out, produced,
                                                    out_cap)


def _anchored_program(words, tb, starts, ends, ll, dl, halo, first_slots,
                      lanes: int, nblocks: int, out_cap: int,
                      use_kernel: bool):
    """The anchored batch as a captured program, from its int32 word
    window: (out, (produced, err), next_halo)."""
    out, produced, err, nwin = decode_batch_anchored(
        _u32(words), tb, starts, ends, ll, dl, halo, lanes, nblocks,
        out_cap, use_kernel, first_slots)
    return out, _pe(produced, err), nwin


def decode_batch(words, bit_lo, block_starts, sym_starts, block_ends,
                 ll, dl, halo, nbits: int, nblocks: int, nseg: int,
                 out_cap: int):
    """Decode `nblocks` Huffman blocks spanning local bits [0, nbits): a
    speculative decode at every bit position, then the symbol positions by
    segmented orbits. words: the batch's int64 word window; bit_lo: its bit
    of local position 0 (a 0-d int64 tensor, or an int).
    block_starts/sym_starts/block_ends: (B,) local header, first-symbol and
    end bits (dummy blocks use nbits). nseg: per-block segment-grid length.
    Returns (out (out_cap,) u8, produced, err, next_halo): the reference's
    decode_batch and, in the same program, its roll_window."""
    dev = words.device
    ltab, dtab = _tables(ll, dl)
    p = torch.arange(nbits, dtype=torch.int64, device=dev)
    bid = torch.clamp(torch.searchsorted(block_starts.to(torch.int64), p,
                                         right=True) - 1, 0, nblocks - 1)
    f, outlen, lit, dist, flags, eobf = dk.wavefront_decode(
        words, bit_lo, nbits, bid, ltab, dtab)
    slots, oerr = dk.segmented_orbits(f, eobf, sym_starts, block_ends,
                                      nbits, nseg, SEG_BITS)
    out, produced, aerr = dk.assemble_output(outlen[slots], lit[slots],
                                             dist[slots], halo, out_cap)
    return (out, produced, oerr + flags[slots].sum() + aerr,
            _next_window(halo, out, produced, out_cap))


def _dense_program(words, bit_lo, block_starts, sym_starts, block_ends, ll,
                   dl, halo, nbits: int, nblocks: int, nseg: int,
                   out_cap: int):
    """The dense batch as a captured program, from its int32 word window:
    (out, (produced, err), next_halo)."""
    out, produced, err, nwin = decode_batch(
        _u32(words), bit_lo, block_starts, sym_starts, block_ends, ll, dl,
        halo, nbits, nblocks, nseg, out_cap)
    return out, _pe(produced, err), nwin


def _host_pack(parts) -> tuple:
    """Ints and int arrays back to back in one int32 host array, and each
    part's (offset, shape): a batch's inputs travel in one upload."""
    flat, spans, o = [], [], 0
    for p in parts:
        a = np.asarray(p, np.int32)
        flat.append(a.reshape(-1))
        spans.append((o, a.shape))
        o += a.size
    return np.concatenate(flat), spans


def _views(flat: torch.Tensor, spans) -> list:
    """The parts of a _host_pack array once it is on the device, as
    views."""
    return [flat[o:o + int(np.prod(sh, dtype=np.int64))].view(sh)
            for o, sh in spans]


def _win_abs_from_deltas(index, recs):
    """FEXTRA-embedded indexes carry window anchors as 6-bit deltas on the
    grid anchored at each block's symbol start (headers.pack_index)."""
    win_abs = []
    for k, rec in enumerate(recs):
        wd = index["win_deltas"][k]
        if wd is None or rec.btype == 0:
            win_abs.append(None)
            continue
        grid0 = rec.sym_bit_offset & ~31
        pos_w = grid0 + 32 * np.arange(len(wd), dtype=np.int64)
        win_abs.append(np.where(np.asarray(wd) == 63, np.int64(-1),
                                pos_w + wd))
    return win_abs


class RawInflater:
    """Decode a raw DEFLATE stream on `device`, given (or recovering) an
    index."""

    def __init__(self, max_batch_bits: int = 1 << 23,
                 max_batch_blocks: int = 64, max_batch_out: int = 1 << 22,
                 device="cuda"):
        self.max_batch_bits = max_batch_bits
        self.max_batch_blocks = max_batch_blocks
        self.max_batch_out = max_batch_out
        self.device = _device.resolve(device)
        # per-call dispatch record (see STATS_LOG)
        self.last_stats: list = []
        # when True, decompress keeps in last_calls the device arguments of
        # every windowed batch, as (words_full, metas, row, win, npe, nb, oc,
        # wwords) with row a 0-d device tensor (decode_batch_windows_stacked
        # takes them), and the v1 expansion's inputs of every anchored
        # batch that runs it, as (buf, mats, produced), computed op by op
        # beside its program (anchored_expand1_inputs), so a harness can
        # re-run or inspect the exact batch
        self.capture_calls = False
        self.last_calls: list = []

    @trace.request("RawInflater.build_index")
    @trace.span("decode.index")
    def build_index(self, raw: bytes, dictionary: bytes = b"") -> dict:
        """Index any RFC 1951 stream for parallel decode: one sequential
        native pass recording block offsets and the 32-bit window anchors,
        the same index contract the encoder emits. Counts its entries in
        decode.index_entries."""
        if native.available():
            out, recs, endbit = native.inflate(raw, dictionary,
                                               want_index=True)
        else:
            out, recs, endbit = hi.inflate_raw(raw, dictionary)
        trace.count("decode.index_entries", len(recs))
        return {
            "block_bits": [r.bit_offset for r in recs],
            "block_bytes": [r.out_offset for r in recs],
            "sync_points": [],
            "n": len(out),
            "win": [r.win_anchors if r.btype != 0 else None for r in recs],
            "end_bit": endbit,
        }

    @trace.span("decode.plan")
    def _plan(self, raw: bytes, index: dict, dictionary: bytes, W_pad: int):
        """Host side: block headers and batch metadata. Returns (work,
        n_out) with work items ("stored", bytes), ("win", (meta, npe, nb,
        oc, wwords, total_out, b0)), ("anchored", (tb, starts, ends, ll,
        dl, lanes, nb, oc, use_kernel, first_slots, word_lo, wwords,
        total_out, b0)) or ("dense", (bit_local, starts, syms, ends, ll,
        dl, nbits, nb, nseg, oc, word_lo, wwords, total_out, b0))."""
        block_bits = list(index["block_bits"])
        block_bytes = list(index["block_bytes"])
        n_out = index["n"]
        nblk = len(block_bits)
        out_lens = [
            (block_bytes[i + 1] if i + 1 < nblk else n_out) - block_bytes[i]
            for i in range(nblk)]
        if native.available():
            recs = native.parse_block_headers(raw, block_bits)
        else:
            recs = [hi.parse_block_header(raw, b) for b in block_bits]
        if index.get("win") is None and index.get("win_deltas") is not None:
            index = {**index, "win": _win_abs_from_deltas(index, recs)}
        win_lists = index.get("win")

        work = []
        i = 0
        while i < nblk:
            rec = recs[i]
            if rec.btype == 0:
                # one index entry may span several stored sub-blocks (the
                # encoder splits blocks longer than the 16-bit LEN field)
                want = out_lens[i]
                r = rec
                copied = 0
                chunk = bytearray()
                while True:
                    start = r.sym_bit_offset >> 3
                    chunk += raw[start:start + r.out_len]
                    copied += r.out_len
                    if copied >= want:
                        break
                    nxt_bit = r.sym_bit_offset + 8 * r.out_len
                    r = (native.parse_block_header(raw, nxt_bit)
                         if native.available()
                         else hi.parse_block_header(raw, nxt_bit))
                    if r.btype != 0:
                        raise errors.BadBlockError(
                            "index expects stored continuation")
                work.append(("stored", bytes(chunk)))
                i += 1
                continue
            # gather a run of huffman blocks within batch limits
            j = i
            bits_end = block_bits[i]
            total_out = 0
            while (j < nblk and recs[j].btype != 0
                   and j - i < self.max_batch_blocks):
                end_j = block_bits[j + 1] if j + 1 < nblk else len(raw) * 8
                if (end_j - block_bits[i] > self.max_batch_bits
                        or total_out + out_lens[j] > self.max_batch_out) \
                        and j > i:
                    break
                bits_end = end_j
                total_out += out_lens[j]
                j += 1
            run = list(range(i, j))
            b0 = block_bits[i]
            wwords = min(_bucket(((bits_end - b0) >> 5) + 16, 1 << 13), W_pad)
            word_lo = min(b0 >> 5, W_pad - wwords)
            nb = _bucket(len(run), 4)
            oc = _bucket(total_out, 1 << 12)
            ll = np.zeros((nb, 288), np.int32)
            dl = np.zeros((nb, 32), np.int32)
            for t, k in enumerate(run):
                lla = recs[k].litlen_lengths
                ll[t, :len(lla)] = lla
                dla = recs[k].dist_lengths
                dl[t, :len(dla)] = dla
            have_win = win_lists is not None and all(
                win_lists[k] is not None for k in run)
            anchors = index.get("anchors")
            have_anchors = anchors is not None and all(
                anchors[k] is not None for k in run)
            if have_win:
                work.append(("win", self._win_meta(
                    run, win_lists, word_lo, ll, dl, nb, oc, wwords,
                    total_out, b0, min(block_bytes[i] + len(dictionary),
                                       1 << 30))))
            elif have_anchors:
                lane_tb, lane_s, lane_e = [], [], []
                lane_block_start = []
                wbase = word_lo << 5
                for t, k in enumerate(run):
                    lane_block_start.append(len(lane_s))
                    a = [recs[k].sym_bit_offset] + [int(x) for x in anchors[k]]
                    e = a[1:] + [1 << 30]
                    lane_tb += [t * dk.TABLE_SIZE] * len(a)
                    lane_s += [x - wbase for x in a]
                    lane_e += [x - wbase if x != (1 << 30) else x for x in e]
                lanes = _bucket(len(lane_s), 64)
                padn = lanes - len(lane_s)
                tb_a = np.asarray(lane_tb + [0] * padn, np.int32)
                st_a = np.asarray(lane_s + [-1] * padn, np.int32)
                en_a = np.asarray(lane_e + [0] * padn, np.int32)
                # pad blocks own no lanes; their slot range starts at the
                # first pad slot (o_len 0 there)
                lane_block_start += [len(lane_s)] * (nb - len(run))
                first_slots = np.asarray(
                    [ls * dk.ANCHOR_STRIDE for ls in lane_block_start]
                    + [lanes * dk.ANCHOR_STRIDE], np.int32)
                # the reference's routing rule: the v1 expansion stages one
                # block's output (at most 64 KiB) with its window
                use_kernel = (self.device.type == "cuda"
                              and max(out_lens[k] for k in run) <= (1 << 16))
                work.append(("anchored", (tb_a, st_a, en_a, ll, dl, lanes,
                                          nb, oc, use_kernel, first_slots,
                                          word_lo, wwords, total_out, b0)))
            else:
                bit_local = b0 - (word_lo << 5)
                nbits = _bucket(bits_end - b0, 1 << 12)
                max_span = max(
                    (block_bits[k + 1] if k + 1 < nblk else bits_end)
                    - recs[k].sym_bit_offset for k in run)
                nseg = _bucket(max_span // SEG_BITS + 2, 32)
                starts = np.full(nb, nbits, np.int32)
                syms = np.full(nb, nbits, np.int32)
                ends = np.full(nb, nbits, np.int32)
                for t, k in enumerate(run):
                    starts[t] = block_bits[k] - b0
                    syms[t] = recs[k].sym_bit_offset - b0
                    ends[t] = (block_bits[k + 1] if k + 1 < nblk
                               else bits_end) - b0
                work.append(("dense", (bit_local, starts, syms, ends, ll, dl,
                                       nbits, nb, nseg, oc, word_lo, wwords,
                                       total_out, b0)))
            i = j
        return work, n_out

    @staticmethod
    def _win_meta(run, win_lists, word_lo, ll, dl, nb, oc, wwords,
                  total_out, b0, hist):
        """A windowed batch's packed meta row and its work item payload:
        meta = [word_lo, hist, pe_word0(npe), pe_tab(npe), alanes(npe*PE),
        ll(nb*288), dl(nb*32)]."""
        PE = wk.PE_LANES
        pe_word0, pe_tab, al_rows = [], [], []
        for t, k in enumerate(run):
            wa = np.asarray(win_lists[k], np.int64)
            w0 = (int(wa[0]) >> 5) - word_lo
            rel = np.where(wa >= 0, wa - word_lo * 32, -1).astype(np.int32)
            for p in range(0, len(wa), PE):
                ch = rel[p:p + PE]
                pe_word0.append(w0 + p)
                pe_tab.append(t)
                row = np.full(PE, -1, np.int32)
                row[:len(ch)] = ch
                al_rows.append(row)
        npe = _bucket(len(pe_word0), 8)
        pad = npe - len(pe_word0)
        pe_word0 += [0] * pad
        pe_tab += [0] * pad
        al_rows += [np.full(PE, -1, np.int32)] * pad
        meta = np.concatenate([
            np.asarray([word_lo, hist], np.int32),
            np.asarray(pe_word0, np.int32),
            np.asarray(pe_tab, np.int32),
            np.stack(al_rows).reshape(-1),
            ll.reshape(-1), dl.reshape(-1)])
        return meta, npe, nb, oc, wwords, total_out, b0

    @trace.request("RawInflater.decompress")
    @trace.span("decode.inflater")
    def decompress(self, raw: bytes, index=None, dictionary: bytes = b"",
                   expected_size: int | None = None) -> bytes:
        self.last_stats = []
        self.last_calls = []
        if index is None:
            # foreign stream: the native inflator (or the Python referee)
            # decodes in one sequential pass
            with trace.span("decode.native"):
                if native.available():
                    out, _, _ = native.inflate(raw, dictionary)
                else:
                    out, _, _ = hi.inflate_raw(raw, dictionary)
            trace.count("decode.native_bytes", len(out))
            return out
        # the whole stream uploads once; each batch cuts its bucketed word
        # window from it on the device
        W_pad = _bucket((len(raw) >> 2) + 18, 1 << 13)
        work, n_out = self._plan(raw, index, dictionary, W_pad)
        kinds = collections.Counter(kind for kind, _ in work)
        trace.count("decode.win_batches", kinds["win"])
        trace.count("decode.stored_items", kinds["stored"])
        inputs = self._upload(raw, work, dictionary, W_pad)
        plan, res = self._launch(work, inputs)
        out = self._finish(raw, dictionary, plan, res, n_out)
        card, stored = card_bytes(self.last_stats)
        trace.count("decode.card_bytes", card)
        if len(out) > card + stored:
            trace.count("decode.native_bytes", len(out) - card - stored)
        return out

    @trace.span("decode.upload")
    def _upload(self, raw: bytes, work: list, dictionary: bytes,
                W_pad: int) -> dict:
        """Every host-to-device copy of one decompress, each through pinned
        memory without a synchronise: the stream's words, the windowed
        batches' stacked meta rows, each other batch's inputs packed in one
        array, each stored chunk, the first window."""
        dev = self.device
        rawpad = np.zeros(W_pad * 4, np.uint8)
        rawpad[:len(raw)] = np.frombuffer(raw, np.uint8)
        halo0 = np.zeros(HALO, np.uint8)
        d0 = dictionary[-HALO:]
        if d0:
            halo0[HALO - len(d0):] = np.frombuffer(d0, np.uint8)
        up = {"words": _device.upload(rawpad.view(np.int32), dev),
              "win": _device.upload(halo0, dev), "metas": None,
              "items": []}
        wmetas = [w[1][0] for w in work if w[0] == "win"]
        if wmetas:
            M = _bucket(max(len(m) for m in wmetas), 1 << 10)
            stackm = np.zeros((len(wmetas), M), np.int32)
            for k, m in enumerate(wmetas):
                stackm[k, :len(m)] = m
            up["metas"] = _device.upload(stackm, dev)
            up["rows"] = torch.arange(len(wmetas), device=dev)
        for kind, p in work:
            if kind == "stored":
                item = _device.upload(np.frombuffer(p, np.uint8).copy(), dev)
            elif kind == "anchored":
                (tb, st, en, ll, dl, _, _, _, _, first, word_lo,
                 _, _, _) = p
                flat, spans = _host_pack((word_lo, tb, st, en, ll, dl, first))
                item = _views(_device.upload(flat, dev), spans)
            elif kind == "dense":
                (bit_local, starts, syms, ends, ll, dl, _, _, _, _, word_lo,
                 _, _, _) = p
                flat, spans = _host_pack((word_lo, bit_local, starts, syms,
                                          ends, ll, dl))
                item = _views(_device.upload(flat, dev), spans)
            else:
                item = None
            up["items"].append(item)
        return up

    @trace.span("decode.launch")
    def _launch(self, work: list, up: dict):
        """Phase 1: every batch, each device batch one program on a card,
        the window chained on the device; the one device-to-host read is
        each windowed batch's row index (_windows_batch). Returns
        the plan, whose entries are ("stored", bytes) or ("dev", (kind,
        out, total_out, b0)), and the (batches, 2) int64 tensor of each
        device batch's (produced, err)."""
        dev = self.device
        # the expansion engine of the windowed batches, read once per call
        engine = int(os.environ.get("JDT_EXPAND", "2") or 2)
        words_full, metas, win = up["words"], up["metas"], up["win"]
        res = torch.empty((sum(k != "stored" for k, _ in work), 2),
                          dtype=torch.int64, device=dev)
        plan = []
        wrow = di = 0
        for (kind, payload), item in zip(work, up["items"]):
            if kind == "stored":
                plan.append(("stored", payload))
                win = roll_window(win, item)
                continue
            if kind == "win":
                (_, npe, nb2, oc2, ww2, total_out, b0) = payload
                row = up["rows"][wrow]
                if self.capture_calls:
                    self.last_calls.append(
                        (words_full, metas, row, win, npe, nb2, oc2, ww2))
                o, pe, win = _windows_batch(words_full, metas, row, win, npe,
                                            nb2, oc2, ww2, engine)
                wrow += 1
            elif kind == "anchored":
                (_, _, _, _, _, lanes, nb2, oc2, use_kernel, _, _, ww2,
                 total_out, b0) = payload
                word_lo, tb, st, en, ll, dl, first = item
                wds = _slice_words(words_full, word_lo, ww2)
                if self.capture_calls and use_kernel:
                    self.last_calls.append(anchored_expand1_inputs(
                        _u32(wds), tb, st, en, ll, dl, win, nb2, oc2, first))
                o, pe, win = program.run(
                    _anchored_program, (wds, tb, st, en, ll, dl, win, first),
                    (lanes, nb2, oc2, use_kernel))
            else:
                (_, _, _, _, _, _, nbits2, nb2, nseg2, oc2, _, ww2,
                 total_out, b0) = payload
                word_lo, bit_lo, starts, syms, ends, ll, dl = item
                wds = _slice_words(words_full, word_lo, ww2)
                o, pe, win = program.run(
                    _dense_program,
                    (wds, bit_lo, starts, syms, ends, ll, dl, win),
                    (nbits2, nb2, nseg2, oc2))
            res[di].copy_(pe)
            di += 1
            plan.append(("dev", (kind, o, total_out, b0)))
        return plan, res

    @trace.span("decode.finish")
    def _finish(self, raw: bytes, dictionary: bytes, plan: list,
                res: torch.Tensor, n_out: int) -> bytes:
        """Phase 2: read every device batch's (produced, err) back at once,
        copy the verified batches out in one transfer (_fill), and from the
        first batch that failed its checks (corruption, or an index that
        does not fit the stream) re-decode natively."""
        stats_rec = self.last_stats
        pes = _device.to_host(res)
        out = bytearray()
        di = 0
        fill = []                   # (host_offset, device_array, nbytes)
        for kind, p in plan:
            if kind == "stored":
                out += p
                stats_rec.append(("stored", len(p), 0))
                STATS_LOG.append(("stored", len(p), 0))
                continue
            wkind, o, total_out, b0 = p
            pe, ee = int(pes[di][0]), int(pes[di][1])
            di += 1
            stats_rec.append((wkind, pe, ee))
            STATS_LOG.append((wkind, pe, ee))
            if ee or pe != total_out:
                self._fill(out, fill)
                window = (dictionary[-HALO:] + bytes(out))[-HALO:]
                with trace.span("decode.native"):
                    if native.available():
                        rest, _, _ = native.inflate(
                            raw, window, start_bit=b0,
                            out_cap=max(n_out - len(out), 1 << 12))
                    else:
                        # the referee has no mid-stream entry: full re-decode
                        rest, _, _ = hi.inflate_raw(raw, dictionary)
                        out = bytearray()
                out += rest
                if len(out) != n_out:
                    raise errors.BadBlockError(
                        f"decode mismatch: produced={len(out)} "
                        f"expected={n_out}")
                return bytes(out)
            fill.append((len(out), o, pe))
            out += b"\x00" * pe
        self._fill(out, fill)
        return bytes(out)

    @staticmethod
    def _fill(out: bytearray, fill: list) -> None:
        """Copy verified device batches into `out` with ONE device->host
        transfer."""
        if not fill:
            return
        buf = _device.to_host(torch.cat([oa[:nb_] for _, oa, nb_ in fill]))
        pos = 0
        for off, _, nb_ in fill:
            out[off:off + nb_] = buf[pos:pos + nb_].tobytes()
            pos += nb_
        fill.clear()
