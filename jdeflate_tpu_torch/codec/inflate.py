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

import os

import numpy as np
import torch

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

HALO = C.WINDOW_SIZE

# Dispatch log: every RawInflater.decompress appends one (kind, produced,
# err) tuple per batch it ran ("stored"/"win"/"anchored"/"dense"). Callers
# clear() it before the operation they want to observe; decompress only
# appends.
STATS_LOG: list = []


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
    so batches chain without a host readback."""
    return torch.cat([win, chunk])[-HALO:]


def _next_window(halo, out, produced, out_cap: int) -> torch.Tensor:
    """The next batch's 32 KiB window: the last HALO bytes of
    (halo ++ out[:produced]), produced clamped into [0, out_cap]."""
    cat = torch.cat([halo, out[:out_cap]])
    p0 = torch.clamp(produced, 0, out_cap)
    return cat[p0 + torch.arange(HALO, device=cat.device)]


def _slice_words(words_full: torch.Tensor, word_lo: int, wwords: int):
    """The batch's bucketed word window of the once-uploaded stream, as
    int64 u32 words; the start clamps into the stream like a dynamic
    slice."""
    lo = min(max(word_lo, 0), max(words_full.shape[0] - wwords, 0))
    return words_full[lo:lo + wwords].to(torch.int64) & 0xFFFFFFFF


def _walk_inputs(words_full, meta, npe: int, ne: int, wwords: int):
    """Unpack one batch's meta row into the arguments of ops/walk.py::
    walk_checked (the first eight are walk_windows_ref's).

    meta: [word_lo, hist, pe_word0(npe), pe_tab(npe), alanes(npe*PE),
           ll(ne*288), dl(ne*32)] as one (M,) i32 tensor.
    Returns (words_full, seg_word0, pe_tab, start_rel (npe*PE,), t1, t2a,
    t2b, t2c, pe_word0, hist), all views or results on meta's device.
    """
    PE = wk.PE_LANES
    word_lo = meta[0]
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
    seg_word0 = wk.segment_starts(pe_word0, word_lo, wwords).to(torch.int32)
    lanebit = (torch.clamp(pe_word0, min=0)[:, None]
               + torch.arange(PE, dtype=torch.int32,
                              device=meta.device)[None, :]) * 32
    start_rel = torch.where(alanes >= 0, alanes - lanebit,
                            torch.full_like(alanes, -1)).to(torch.int32)
    return (words_full, seg_word0, pe_tab, start_rel.reshape(-1), t1, t2a,
            t2b, t2c, pe_word0, hist)


def _decode_from_meta(words_full, meta, halo, npe: int, ne: int,
                      out_cap: int, wwords: int, engine: int = 2):
    """Decode one windowed batch. Returns (out (out_cap,) u8, produced, err,
    next_halo), all on the device; nothing is read back. The walk checks
    its exit chain and far offsets (ops/walk.py::walk_checked, in the
    kernel's epilogue on the card) and hands its lane offsets on. engine 5
    expands through ops/expand5.py, any other value through
    ops/expand2.py."""
    tok_lm, _, outlen, laneoff, err_w = wk.walk_checked(
        *_walk_inputs(words_full, meta, npe, ne, wwords))
    if engine == 5:
        out, produced, kerr = ex5.expand_tokens(tok_lm, outlen, halo,
                                                out_cap, laneoff)
        aerr = kerr + (produced > out_cap).to(kerr.dtype)
    else:
        out, produced, aerr = ex2.expand_tokens(tok_lm, outlen, halo,
                                                out_cap, laneoff)
    return out, produced, err_w[0] + aerr, _next_window(halo, out, produced,
                                                        out_cap)


def decode_batch_windows_stacked(words_full, metas, row: int, halo,
                                 npe: int, ne: int, out_cap: int,
                                 wwords: int, engine: int = 2):
    """_decode_from_meta over row `row` of the (B, M) stacked metadata: the
    whole stream's batch metadata uploads in one transfer."""
    return _decode_from_meta(words_full, metas[row], halo, npe, ne, out_cap,
                             wwords, engine)


def _expand1_inputs(o_len, o_lit, o_dist, halo, out_cap: int,
                    first_slots, nblocks: int):
    """The v1 match expansion's inputs from token slots (the first half of
    the reference's _assemble_pallas). Literals: one scatter into the
    buffer behind the halo. Matches: compacted to stream order by a stable
    sort on the slot index (every non-match carries key S, so the blocks'
    match ranges are the reference's). first_slots: (nblocks+1,) slot index
    of each block's first lane (lanes are block-contiguous).

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
    buf = torch.zeros(N, dtype=torch.uint8, device=dev)
    buf[:HALO] = halo
    is_tok = o_len > 0
    is_lit = is_tok & (o_dist == 0)
    put = is_lit & (off < N)
    buf[off[put]] = o_lit[put].to(torch.uint8)

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
                     first_slots, nblocks: int, capture=None):
    """Token slots -> output bytes through the v1 match expansion
    (ops/expand.py), block by block; port of the reference's
    _assemble_pallas. Returns (out (out_cap,) u8, produced, err). A list
    passed as `capture` gets the expansion's inputs, (buf, mats,
    produced), with buf copied before the in-place expansion."""
    buf, mats, produced, err = _expand1_inputs(
        o_len, o_lit, o_dist, halo, out_cap, first_slots, nblocks)
    if capture is not None:
        capture.append((buf.clone(), mats, produced))
    buf = ex.expand_matches(buf, *mats)
    return buf[HALO:HALO + out_cap], produced, err


def _tables(ll, dl):
    return (dk.build_tables_batch(ll, *dk.litlen_attrs()),
            dk.build_tables_batch(dl, *dk.dist_attrs()))


def decode_batch_anchored(words, tb, starts, ends, ll, dl, halo,
                          lanes: int, nblocks: int, out_cap: int,
                          use_kernel: bool = False, first_slots=None,
                          capture=None):
    """Exact anchored decode: every lane walks 64 symbols from a known
    symbol anchor (no speculation, no dense f). words: the batch's int64
    word window; tb/starts/ends: (lanes,) table base, start and end anchor
    bits (window-local). capture: see _assemble_kernel. Returns (out
    (out_cap,) u8, produced, err, next_halo)."""
    ltab, dtab = _tables(ll, dl)
    outlen, lit, dist, werr = dk.anchored_walk(words, ltab, dtab, tb,
                                               starts, ends)
    slots = (outlen.reshape(-1), lit.reshape(-1), dist.reshape(-1))
    if use_kernel:
        out, produced, aerr = _assemble_kernel(*slots, halo, out_cap,
                                               first_slots, nblocks, capture)
    else:
        out, produced, aerr = dk.assemble_output(*slots, halo, out_cap)
    return out, produced, werr + aerr, _next_window(halo, out, produced,
                                                    out_cap)


def decode_batch(words, bit_lo: int, block_starts, sym_starts, block_ends,
                 ll, dl, halo, nbits: int, nblocks: int, nseg: int,
                 out_cap: int):
    """Decode `nblocks` Huffman blocks spanning local bits [0, nbits): a
    speculative decode at every bit position, then the symbol positions by
    segmented orbits. words: the batch's int64 word window; bit_lo: its bit
    of local position 0. block_starts/sym_starts/block_ends: (B,) local
    header, first-symbol and end bits (dummy blocks use nbits). nseg:
    per-block segment-grid length. Returns (out (out_cap,) u8, produced,
    err)."""
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
    return out, produced, oerr + flags[slots].sum() + aerr


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
        # wwords), and the v1 expansion's inputs of every anchored batch
        # that runs it, as (buf, mats, produced), so a harness can re-run or
        # inspect the exact batch
        self.capture_calls = False
        self.last_calls: list = []

    def build_index(self, raw: bytes, dictionary: bytes = b"") -> dict:
        """Index any RFC 1951 stream for parallel decode: one sequential
        native pass recording block offsets and the 32-bit window anchors,
        the same index contract the encoder emits."""
        if native.available():
            out, recs, endbit = native.inflate(raw, dictionary,
                                               want_index=True)
        else:
            out, recs, endbit = hi.inflate_raw(raw, dictionary)
        return {
            "block_bits": [r.bit_offset for r in recs],
            "block_bytes": [r.out_offset for r in recs],
            "sync_points": [],
            "n": len(out),
            "win": [r.win_anchors if r.btype != 0 else None for r in recs],
            "end_bit": endbit,
        }

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

    def decompress(self, raw: bytes, index=None, dictionary: bytes = b"",
                   expected_size: int | None = None) -> bytes:
        dev = self.device
        self.last_stats = stats_rec = []
        self.last_calls = []
        if index is None:
            # foreign stream: the native inflator (or the Python referee)
            # decodes in one sequential pass
            if native.available():
                out, _, _ = native.inflate(raw, dictionary)
            else:
                out, _, _ = hi.inflate_raw(raw, dictionary)
            return out

        # the whole stream uploads once; each batch reads its bucketed word
        # window from it
        W_pad = _bucket((len(raw) >> 2) + 18, 1 << 13)
        work, n_out = self._plan(raw, index, dictionary, W_pad)
        rawpad = np.zeros(W_pad * 4, np.uint8)
        rawpad[:len(raw)] = np.frombuffer(raw, np.uint8)
        words_full = torch.from_numpy(rawpad.view(np.int32)).to(dev)

        # Phase 1 runs every batch with a device-chained window and no
        # device->host read; phase 2 reads (produced, err) back once and
        # re-decodes natively from the first failed batch (corruption, or an
        # index that does not fit the stream).
        halo0 = np.zeros(HALO, np.uint8)
        d0 = dictionary[-HALO:]
        if d0:
            halo0[HALO - len(d0):] = np.frombuffer(d0, np.uint8)
        wmetas = [w[1][0] for w in work if w[0] == "win"]
        metas_dev = None
        if wmetas:
            M = _bucket(max(len(m) for m in wmetas), 1 << 10)
            stackm = np.zeros((len(wmetas), M), np.int32)
            for k2, m in enumerate(wmetas):
                stackm[k2, :len(m)] = m
            metas_dev = torch.from_numpy(stackm).to(dev)
        win = torch.from_numpy(halo0).to(dev)
        # the expansion engine of the windowed batches, read once per call
        engine = int(os.environ.get("JDT_EXPAND", "2") or 2)

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        plan = []
        wrow = 0
        for kind, payload in work:
            if kind == "stored":
                plan.append(("stored", payload))
                chunk = torch.from_numpy(np.frombuffer(payload, np.uint8).copy())
                win = roll_window(win, chunk.to(dev))
                continue
            if kind == "win":
                (meta, npe, nb2, oc2, ww2, total_out, b0) = payload
                if self.capture_calls:
                    self.last_calls.append(
                        (words_full, metas_dev, wrow, win, npe, nb2, oc2, ww2))
                o, produced, err, win = decode_batch_windows_stacked(
                    words_full, metas_dev, wrow, win, npe, nb2, oc2, ww2,
                    engine)
                wrow += 1
            elif kind == "anchored":
                (tb_a, st_a, en_a, ll2, dl2, lanes, nb2, oc2, use_kernel,
                 first_slots, word_lo2, ww2, total_out, b0) = payload
                wds = _slice_words(words_full, word_lo2, ww2)
                o, produced, err, win = decode_batch_anchored(
                    wds, up(tb_a), up(st_a), up(en_a), up(ll2), up(dl2), win,
                    lanes, nb2, oc2, use_kernel, up(first_slots),
                    self.last_calls if self.capture_calls else None)
            else:
                (bit_local2, starts2, syms2, ends2, ll2, dl2, nbits2, nb2,
                 nseg2, oc2, word_lo2, ww2, total_out, b0) = payload
                wds = _slice_words(words_full, word_lo2, ww2)
                o, produced, err = decode_batch(
                    wds, bit_local2, up(starts2), up(syms2), up(ends2),
                    up(ll2), up(dl2), win, nbits2, nb2, nseg2, oc2)
                win = _next_window(win, o, produced, oc2)
            plan.append(("dev", (o, produced, err, total_out, b0)))

        dev_batches = [p for kind, p in plan if kind == "dev"]
        metas = (torch.stack([torch.stack((p[1].long(), p[2].long()))
                              for p in dev_batches]).cpu().numpy()
                 if dev_batches else np.zeros((0, 2), np.int64))
        kinds = iter([k for k, _ in work if k != "stored"])
        out = bytearray()
        di = 0
        fill = []                   # (host_offset, device_array, nbytes)
        for kind, p in plan:
            if kind == "stored":
                out += p
                stats_rec.append(("stored", len(p), 0))
                STATS_LOG.append(("stored", len(p), 0))
                continue
            o, produced, err, total_out, b0 = p
            pe, ee = int(metas[di][0]), int(metas[di][1])
            di += 1
            wkind = next(kinds)
            stats_rec.append((wkind, pe, ee))
            STATS_LOG.append((wkind, pe, ee))
            if ee or pe != total_out:
                self._fill(out, fill)
                window = (dictionary[-HALO:] + bytes(out))[-HALO:]
                if native.available():
                    rest, _, _ = native.inflate(
                        raw, window, start_bit=b0,
                        out_cap=max(n_out - len(out), 1 << 12))
                    out += rest
                else:
                    # the referee has no mid-stream entry: full re-decode
                    full, _, _ = hi.inflate_raw(raw, dictionary)
                    out = bytearray(full)
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
        buf = torch.cat([oa[:nb_] for _, oa, nb_ in fill]).cpu().numpy()
        pos = 0
        for off, _, nb_ in fill:
            out[off:off + nb_] = buf[pos:pos + nb_].tobytes()
            pos += nb_
        fill.clear()
