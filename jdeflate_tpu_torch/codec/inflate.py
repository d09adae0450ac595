"""Window-parallel DEFLATE decoder on a CUDA device (or the CPU).

Given an index of block bit offsets and 32-bit window anchors (free from
the encoder; recovered by the native indexer for foreign streams), every
Huffman batch decodes on the device in two kernels: the window walk
(ops/walk.py, one lane per 32 stream bits) and the token expansion
(ops/expand2.py) behind a 32 KiB halo that chains batches like the
reference's ring window (inflator.c:616-675). Stored blocks are host
copies. Port of the "win" and "stored" paths of
jdeflate_tpu/codec/inflate.py; its "anchored" and "dense" branches serve
indexes without window anchors and are not ported.

The sequential correctness referee for arbitrary streams is
stream.host_inflate, and the native inflator re-decodes from the first
batch whose checks fail.
"""
from __future__ import annotations

import numpy as np
import torch

from ..formats import constants as C
from ..ops import expand2 as ex2
from ..ops import walk as wk
from ..stream import host_inflate as hi
from ..stream import native
from ..utils import device as _device
from ..utils import errors

HALO = C.WINDOW_SIZE

# Dispatch log: every RawInflater.decompress appends one (kind, produced,
# err) tuple per batch it ran ("stored"/"win"). Callers clear() it before
# the operation they want to observe; decompress only appends.
STATS_LOG: list = []


def _bucket(n: int, base: int) -> int:
    b = base
    while b < n:
        b *= 2
    return b


def roll_window(win: torch.Tensor, chunk: torch.Tensor) -> torch.Tensor:
    """New 32 KiB window = last HALO bytes of (win ++ chunk), on the device
    so batches chain without a host readback."""
    return torch.cat([win, chunk])[-HALO:]


def _walk_inputs(words_full, meta, npe: int, ne: int):
    """Unpack one batch's meta row into the walk's inputs.

    meta: [word_lo, hist, pe_word0(npe), pe_tab(npe), alanes(npe*PE),
           ll(ne*288), dl(ne*32)] as one (M,) i32 tensor.
    Returns (walk args, pe_tab, start_rel (npe, PE), lanebit, hist).
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
    seg_word0 = wk.segment_starts(pe_word0, word_lo).to(torch.int32)
    lanebit = (torch.clamp(pe_word0, min=0)[:, None]
               + torch.arange(PE, dtype=torch.int32,
                              device=meta.device)[None, :]) * 32
    start_rel = torch.where(alanes >= 0, alanes - lanebit,
                            torch.full_like(alanes, -1)).to(torch.int32)
    args = (words_full, seg_word0, pe_tab.contiguous(),
            start_rel.reshape(-1), t1, t2a, t2b, t2c)
    return args, pe_tab, start_rel, lanebit, hist


def _decode_from_meta(words_full, meta, halo, npe: int, ne: int,
                      out_cap: int):
    """Decode one windowed batch. Returns (out (out_cap,) u8, produced, err,
    next_halo), all on the device; nothing is read back."""
    args, pe_tab, start_rel, lanebit, hist = _walk_inputs(
        words_full, meta, npe, ne)
    tok_lm, _, _, err_l, posf, eobf = wk.walk_cuda(*args)
    PE = wk.PE_LANES
    err_l = err_l.reshape(npe, PE)
    eobf = eobf.reshape(npe, PE)
    posf = posf.reshape(npe, PE)
    # exit-chain validation: every lane's final bit position must be exactly
    # the next lane's anchor (the structural check corruption cannot dodge)
    BIGV = 1 << 29
    active = start_rel >= 0
    sabs = torch.where(active, lanebit + start_rel,
                       torch.full_like(start_rel, BIGV))
    exit_abs = lanebit + posf
    nxt_in = torch.flip(torch.cummin(torch.flip(sabs, [1]), 1).values, [1])
    big = torch.full((npe, 1), BIGV, dtype=sabs.dtype, device=sabs.device)
    nxt_in = torch.cat([nxt_in[:, 1:], big], 1)
    head = sabs.min(1).values
    same_ent = torch.cat([pe_tab[1:] == pe_tab[:-1],
                          torch.zeros(1, dtype=torch.bool,
                                      device=pe_tab.device)])
    nxt_head = torch.where(same_ent, torch.cat([head[1:], big[0]]), big[:, 0])
    nxt = torch.minimum(nxt_in, nxt_head[:, None])
    chain_bad = active & ~eobf & (exit_abs != nxt)
    err_w = err_l.sum() + chain_bad.sum()

    len2, _, dist2 = ex2.token_slots(tok_lm)
    outlen = len2.sum(1, dtype=torch.int32)
    # far-offset validation (INFLT_EFAROFFSET analog, inflator.c:1233-1237):
    # a match may not reach past the available history
    laneoff = torch.cumsum(outlen, 0) - outlen
    off_in = laneoff[:, None] + torch.cumsum(len2, 1) - len2
    far = (dist2 > 0) & (dist2 > off_in + hist)
    err_w = err_w + far.sum()

    tok_ann = wk.annotate_lit_runs(tok_lm)
    out, produced, aerr = ex2.expand_tokens(tok_ann, outlen, halo, out_cap)
    cat = torch.cat([halo, out])
    p0 = torch.clamp(produced, 0, out_cap)
    nwin = cat[p0 + torch.arange(HALO, device=cat.device)]
    return out, produced, err_w + aerr, nwin


def decode_batch_windows_stacked(words_full, metas, row: int, halo,
                                 npe: int, ne: int, out_cap: int):
    """_decode_from_meta over row `row` of the (B, M) stacked metadata: the
    whole stream's batch metadata uploads in one transfer."""
    return _decode_from_meta(words_full, metas[row], halo, npe, ne, out_cap)


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
        # when True, decompress keeps the device arguments of every windowed
        # batch in last_calls as (words_full, metas, row, win, npe, nb, oc),
        # so a harness can re-run or inspect the exact batch
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
        n_out) with work items ("stored", bytes) or ("win", (meta, npe, nb,
        oc, total_out, b0))."""
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
            if win_lists is None or any(win_lists[k] is None for k in run):
                raise errors.IncorrectUseError(
                    "index has no window anchors for Huffman blocks "
                    f"{run[0]}..{run[-1]}: the anchored and dense decode "
                    "paths are not ported; build the index with "
                    "RawInflater.build_index or the encoder")
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
            PE = wk.PE_LANES
            pe_word0, pe_tab, al_rows = [], [], []
            for t, k in enumerate(run):
                wa = np.asarray(win_lists[k], np.int64)
                w0 = (int(wa[0]) >> 5) - word_lo
                rel = np.where(wa >= 0, wa - word_lo * 32,
                               -1).astype(np.int32)
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
            hist = min(block_bytes[i] + len(dictionary), 1 << 30)
            meta = np.concatenate([
                np.asarray([word_lo, hist], np.int32),
                np.asarray(pe_word0, np.int32),
                np.asarray(pe_tab, np.int32),
                np.stack(al_rows).reshape(-1),
                ll.reshape(-1), dl.reshape(-1)])
            work.append(("win", (meta, npe, nb, oc, total_out, b0)))
            i = j
        return work, n_out

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

        # the whole stream uploads once; each batch's walk reads its words
        # straight from it
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
        plan = []
        wrow = 0
        for kind, payload in work:
            if kind == "stored":
                plan.append(("stored", payload))
                chunk = torch.from_numpy(np.frombuffer(payload, np.uint8).copy())
                win = roll_window(win, chunk.to(dev))
                continue
            (meta, npe, nb2, oc2, total_out, b0) = payload
            if self.capture_calls:
                self.last_calls.append(
                    (words_full, metas_dev, wrow, win, npe, nb2, oc2))
            o, produced, err, win = decode_batch_windows_stacked(
                words_full, metas_dev, wrow, win, npe, nb2, oc2)
            wrow += 1
            plan.append(("dev", (o, produced, err, total_out, b0)))

        dev_batches = [p for kind, p in plan if kind == "dev"]
        metas = (torch.stack([torch.stack((p[1].long(), p[2].long()))
                              for p in dev_batches]).cpu().numpy()
                 if dev_batches else np.zeros((0, 2), np.int64))
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
            stats_rec.append(("win", pe, ee))
            STATS_LOG.append(("win", pe, ee))
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
