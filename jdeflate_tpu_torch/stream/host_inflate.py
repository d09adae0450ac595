"""Sequential host-side DEFLATE decoder: conformance referee and stream indexer.

Plays two roles in the framework (SURVEY.md §2.2, §7):
  1. Conformance decoder for *foreign* streams (any RFC 1951 producer), with
     the reference inflator's full validity matrix: oversubscribed/incomplete
     trees (inflator.c:454-474), bad precode repeats (inflator.c:1081-1094),
     missing EOB (inflator.c:1171-1174), LEN/NLEN mismatch (inflator.c:980-983),
     reserved block type (inflator.c:888-889), too-far offsets
     (inflator.c:1233-1237), truncated input (inflator.c:806-810).
  2. Indexer: records each block's bit offset and output offset so the GPU
     window walk can decode all blocks in parallel (the encoder-side
     index is free; this recovers one for foreign streams).

Pure Python by design here; the native C++ indexer (native/) replaces it on
the hot path.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..formats import constants as C
from ..utils.errors import (BadBlockError, BadCodeError, BadTreeError,
                            FarOffsetError, InputEndError)


@dataclasses.dataclass
class BlockRecord:
    bit_offset: int          # absolute bit position of the block header
    btype: int               # 0 stored, 1 static, 2 dynamic
    bfinal: bool
    out_offset: int          # uncompressed offset at block start
    out_len: int             # bytes produced by this block
    sym_bit_offset: int      # bit position where symbol data starts (1/2) or
                             # byte-aligned data start (0)
    litlen_lengths: np.ndarray | None = None
    dist_lengths: np.ndarray | None = None
    anchors: np.ndarray | None = None    # bit positions of symbols 65,129,...
    win_anchors: np.ndarray | None = None  # per 32-bit window on the grid
    # origin (sym_bit_offset & ~31): bit of the first symbol starting in the
    # window, -1 for windows fully spanned by one symbol (ops/walk.py)


class _BitReader:
    __slots__ = ("data", "pos", "nbits")

    def __init__(self, data: bytes, bit_pos: int = 0):
        self.data = data
        self.pos = bit_pos
        self.nbits = 8 * len(data)

    def read(self, n: int) -> int:
        if self.pos + n > self.nbits:
            raise InputEndError("truncated stream")
        v = 0
        p = self.pos
        for k in range(n):
            byte = self.data[(p + k) >> 3]
            v |= ((byte >> ((p + k) & 7)) & 1) << k
        self.pos += n
        return v

    def align_byte(self):
        self.pos = (self.pos + 7) & ~7


class _Decoder:
    """Canonical Huffman decoder from a length array (bit-serial)."""

    def __init__(self, lengths, allow_incomplete_single=False):
        lengths = np.asarray(lengths, dtype=np.int64)
        used = lengths > 0
        m = int(used.sum())
        self.count = np.bincount(lengths[used], minlength=16)[:16] \
            if m else np.zeros(16, np.int64)
        # validity: Kraft sum (cf. inflator.c:454-474)
        left = 1
        for l in range(1, 16):
            left = (left << 1) - int(self.count[l] if l < len(self.count) else 0)
            if left < 0:
                raise BadTreeError("oversubscribed code")
        if left > 0:
            # incomplete: legal only for single-code distance trees
            if not (allow_incomplete_single and m <= 1):
                raise BadTreeError("incomplete code")
        self.first = np.zeros(17, np.int64)
        self.offset = np.zeros(17, np.int64)
        code = 0
        off = 0
        for l in range(1, 16):
            self.first[l] = code
            self.offset[l] = off
            c = int(self.count[l]) if l < len(self.count) else 0
            code = (code + c) << 1
            off += c
        order = np.argsort(lengths + (~used) * 1000, kind="stable")
        self.syms = order[:m]

    def decode(self, br: _BitReader) -> int:
        code = 0
        for l in range(1, 16):
            code = (code << 1) | br.read(1)
            c = int(self.count[l]) if l < len(self.count) else 0
            if code - self.first[l] < c:
                return int(self.syms[self.offset[l] + code - self.first[l]])
        raise BadCodeError("invalid Huffman code")


def parse_block_header(data: bytes, bit_pos: int) -> BlockRecord:
    """Parse one block header (no symbol decode) at an absolute bit position.

    Used by the device decode path to recover per-block code lengths from an
    index of block bit offsets (the encoder emits such an index for free;
    foreign streams get one from a full host decode or the native indexer).
    out_offset/out_len are left 0 — the caller knows them from its index.
    """
    br = _BitReader(data, bit_pos)
    bfinal = br.read(1)
    btype = br.read(2)
    if btype == 3:
        raise BadBlockError("reserved block type")
    if btype == 0:
        br.align_byte()
        ln = br.read(16)
        nln = br.read(16)
        if ln ^ nln != 0xFFFF:
            raise BadBlockError("LEN/NLEN mismatch")
        return BlockRecord(bit_pos, 0, bool(bfinal), 0, ln, br.pos)
    if btype == 1:
        return BlockRecord(bit_pos, 1, bool(bfinal), 0, 0, br.pos,
                           C.FIXED_LITLEN_LENGTHS.copy(),
                           C.FIXED_DIST_LENGTHS.copy())
    hlit = br.read(5) + 257
    hdist = br.read(5) + 1
    hclen = br.read(4) + 4
    if hlit > 286 or hdist > 30:
        raise BadTreeError("HLIT/HDIST out of range")
    plens = np.zeros(19, np.int64)
    for i in range(hclen):
        plens[C.PRECODE_ORDER[i]] = br.read(3)
    pdec = _Decoder(plens)
    lengths = np.zeros(hlit + hdist, np.int64)
    i = 0
    while i < hlit + hdist:
        s = pdec.decode(br)
        if s < 16:
            lengths[i] = s
            i += 1
        elif s == 16:
            if i == 0:
                raise BadTreeError("repeat with no previous length")
            r = 3 + br.read(2)
            if i + r > hlit + hdist:
                raise BadTreeError("repeat overflows lengths")
            lengths[i:i + r] = lengths[i - 1]
            i += r
        else:
            r = (3 + br.read(3)) if s == 17 else (11 + br.read(7))
            if i + r > hlit + hdist:
                raise BadTreeError("repeat overflows lengths")
            i += r
    if lengths[256] == 0:
        raise BadTreeError("missing EOB code")
    return BlockRecord(bit_pos, 2, bool(bfinal), 0, 0, br.pos,
                       lengths[:hlit], lengths[hlit:])


def inflate_one_block(data: bytes, bit_pos: int, window: bytes = b""):
    """Decode exactly ONE block at bit_pos with the given history window.

    Returns (out_bytes, end_bit, bfinal). Raises InputEndError when the
    buffered input truncates mid-block (the bounded-memory streaming
    substrate; cf. the reference's resumable decode loop,
    src/inflator.c:1329-1518 — suspension here is at block granularity).
    """
    br = _BitReader(data, bit_pos)
    out = bytearray(window[-C.WINDOW_SIZE:])
    base = len(out)
    bfinal = br.read(1)
    btype = br.read(2)
    if btype == 3:
        raise BadBlockError("reserved block type")
    if btype == 0:
        br.align_byte()
        ln = br.read(16)
        nln = br.read(16)
        if ln ^ nln != 0xFFFF:
            raise BadBlockError("LEN/NLEN mismatch")
        if br.pos + 8 * ln > br.nbits:
            raise InputEndError("truncated stored block")
        start = br.pos >> 3
        out += data[start:start + ln]
        br.pos += 8 * ln
        return bytes(out[base:]), br.pos, bool(bfinal)
    rec = parse_block_header(data, bit_pos)
    br.pos = rec.sym_bit_offset
    ldec = _Decoder(rec.litlen_lengths)
    ddec = _Decoder(rec.dist_lengths, allow_incomplete_single=True)
    while True:
        s = ldec.decode(br)
        if s < 256:
            out.append(s)
        elif s == 256:
            break
        else:
            if s > 285:
                raise BadCodeError("invalid length symbol")
            li = s - 257
            length = int(C.LENGTH_BASE[li]) + br.read(int(C.LENGTH_EXTRA[li]))
            d = ddec.decode(br)
            if d > 29:
                raise BadCodeError("invalid distance symbol")
            dist = int(C.DIST_BASE[d]) + br.read(int(C.DIST_EXTRA[d]))
            if dist > len(out):
                raise FarOffsetError(
                    f"distance {dist} beyond history {len(out)}")
            for _ in range(length):
                out.append(out[-dist])
    return bytes(out[base:]), br.pos, bool(bfinal)


def inflate_raw(data: bytes, dictionary: bytes = b"", max_output: int | None = None,
                collect_index: bool = True):
    """Decode a raw DEFLATE stream. Returns (output_bytes, records, end_bit)."""
    br = _BitReader(data)
    out = bytearray(dictionary[-C.WINDOW_SIZE:])
    base = len(out)
    records: list[BlockRecord] = []
    while True:
        hdr_bit = br.pos
        bfinal = br.read(1)
        btype = br.read(2)
        out_start = len(out) - base
        if btype == 3:
            raise BadBlockError("reserved block type")
        if btype == 0:
            br.align_byte()
            ln = br.read(16)
            nln = br.read(16)
            if ln ^ nln != 0xFFFF:
                raise BadBlockError("LEN/NLEN mismatch")
            data_bit = br.pos
            if br.pos + 8 * ln > br.nbits:
                raise InputEndError("truncated stored block")
            start = br.pos >> 3
            out += data[start:start + ln]
            br.pos += 8 * ln
            rec = BlockRecord(hdr_bit, 0, bool(bfinal), out_start, ln, data_bit)
        else:
            if btype == 1:
                ll = C.FIXED_LITLEN_LENGTHS
                dl = C.FIXED_DIST_LENGTHS
                sym_bit = br.pos
            else:
                hlit = br.read(5) + 257
                hdist = br.read(5) + 1
                hclen = br.read(4) + 4
                if hlit > 286 or hdist > 30:
                    raise BadTreeError("HLIT/HDIST out of range")
                plens = np.zeros(19, np.int64)
                for i in range(hclen):
                    plens[C.PRECODE_ORDER[i]] = br.read(3)
                pdec = _Decoder(plens)
                lengths = np.zeros(hlit + hdist, np.int64)
                i = 0
                while i < hlit + hdist:
                    s = pdec.decode(br)
                    if s < 16:
                        lengths[i] = s
                        i += 1
                    elif s == 16:
                        if i == 0:
                            raise BadTreeError("repeat with no previous length")
                        r = 3 + br.read(2)
                        if i + r > hlit + hdist:
                            raise BadTreeError("repeat overflows lengths")
                        lengths[i:i + r] = lengths[i - 1]
                        i += r
                    else:
                        r = (3 + br.read(3)) if s == 17 else (11 + br.read(7))
                        if i + r > hlit + hdist:
                            raise BadTreeError("repeat overflows lengths")
                        i += r
                ll = lengths[:hlit]
                dl = lengths[hlit:]
                if ll[256] == 0:
                    raise BadTreeError("missing EOB code")
                sym_bit = br.pos
            ldec = _Decoder(ll)
            ddec = _Decoder(dl, allow_incomplete_single=True)
            # window-anchor recording for the parallel walk (ops/walk.py):
            # first symbol start in each 32-bit window of the grid anchored
            # at sym_bit & ~31
            org = sym_bit & ~31
            wanch: list[int] = []
            while True:
                if collect_index:
                    w = (br.pos - org) >> 5
                    while len(wanch) <= w:
                        wanch.append(-1)
                    if wanch[w] < 0:
                        wanch[w] = br.pos
                s = ldec.decode(br)
                if s < 256:
                    out.append(s)
                elif s == 256:
                    break
                else:
                    if s > 285:
                        raise BadCodeError("invalid length symbol")
                    li = s - 257
                    length = int(C.LENGTH_BASE[li]) + br.read(int(C.LENGTH_EXTRA[li]))
                    d = ddec.decode(br)
                    if d > 29:
                        raise BadCodeError("invalid distance symbol")
                    dist = int(C.DIST_BASE[d]) + br.read(int(C.DIST_EXTRA[d]))
                    if dist > len(out):
                        raise FarOffsetError(
                            f"distance {dist} beyond history {len(out)}")
                    for _ in range(length):
                        out.append(out[-dist])
                if max_output is not None and len(out) - base > max_output:
                    raise BadBlockError("output limit exceeded")
            rec = BlockRecord(hdr_bit, btype, bool(bfinal), out_start,
                              len(out) - base - out_start, sym_bit,
                              np.asarray(ll), np.asarray(dl),
                              win_anchors=np.asarray(wanch, np.int64))
        if collect_index:
            records.append(rec)
        if bfinal:
            break
    return bytes(out[base:]), records, br.pos
