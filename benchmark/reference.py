"""The plain reference that decides `correct`. It imports nothing of the
program, of JAX or of the JAX package: gzip framing is parsed here by RFC
1952, the DEFLATE body is decoded by Python's zlib (an implementation
independent of the program), CRC-32 and ISIZE are worked out again from the
payload, and the decode index the program derived is checked against the
stream: its sizes and seams by zlib, a sample of its block bit offsets by
the one-block decoder below (RFC 1951, after zlib's puff.c).

The index's output offsets of the sub-blocks inside a batch are not held
exact: the program records a sub-block's start on its chunk seam, where a
match may cross the seam (ROADMAP C7), and its decoder's checks catch that
and re-decode natively. check_index counts such blocks apart, as a reading
that decides nothing.

Every check counts faults; a sound answer counts none, so each limit is 0.
"""
from __future__ import annotations

import zlib

import numpy as np

WINDOW = 32768
_LBASE = (3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31, 35, 43,
          51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258)
_LEXT = (0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4,
         4, 4, 5, 5, 5, 5, 0)
_DBASE = (1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193, 257,
          385, 513, 769, 1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289,
          16385, 24577)
_DEXT = (0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9,
         10, 10, 11, 11, 12, 12, 13, 13)
_CLORDER = (16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15)


class StreamError(ValueError):
    """The stream breaks RFC 1951 or RFC 1952."""


# ---- gzip framing (RFC 1952)

def gzip_header_len(b: bytes) -> int:
    """Length of the gzip member header at the start of b."""
    if len(b) < 10 or b[0] != 0x1F or b[1] != 0x8B or b[2] != 8:
        raise StreamError("not a gzip member (ID1, ID2, CM)")
    flg = b[3]
    if flg & 0xE0:
        raise StreamError("reserved FLG bits set")
    pos = 10
    if flg & 4:                                     # FEXTRA
        if len(b) < pos + 2:
            raise StreamError("truncated FEXTRA")
        pos += 2 + int.from_bytes(b[pos:pos + 2], "little")
    for bit in (8, 16):                             # FNAME, FCOMMENT
        if flg & bit:
            end = b.find(b"\0", pos)
            if end < 0:
                raise StreamError("unterminated FNAME or FCOMMENT")
            pos = end + 1
    if flg & 2:                                     # FHCRC
        if (zlib.crc32(b[:pos]) & 0xFFFF) != int.from_bytes(b[pos:pos + 2],
                                                           "little"):
            raise StreamError("header CRC16 mismatch")
        pos += 2
    if pos > len(b):
        raise StreamError("truncated header")
    return pos


def bytes_differing(got: bytes, want: bytes) -> int:
    """Bytes that differ at the same offset, plus the difference in length."""
    m = min(len(got), len(want))
    a = np.frombuffer(got, np.uint8, m)
    b = np.frombuffer(want, np.uint8, m)
    return int(np.count_nonzero(a != b)) + abs(len(got) - len(want))


# ---- one DEFLATE block (RFC 1951 section 3.2), for the index check

class _Bits:
    def __init__(self, data: bytes, bitpos: int):
        self.data = data
        self.pos = bitpos >> 3
        self.buf = 0
        self.cnt = 0
        if bitpos & 7:
            self.need(bitpos & 7)

    def need(self, n: int) -> int:
        while self.cnt < n:
            if self.pos >= len(self.data):
                raise StreamError("stream ends inside a block")
            self.buf |= self.data[self.pos] << self.cnt
            self.pos += 1
            self.cnt += 8
        v = self.buf & ((1 << n) - 1)
        self.buf >>= n
        self.cnt -= n
        return v

    def bitpos(self) -> int:
        return self.pos * 8 - self.cnt


def _huffman(lengths):
    """(count per length, symbols in canonical order), puff.c's construct."""
    count = [0] * 16
    for n in lengths:
        count[n] += 1
    if count[0] == len(lengths):
        return count, []
    left = 1
    for n in range(1, 16):
        left = (left << 1) - count[n]
        if left < 0:
            raise StreamError("over-subscribed code")
    offs = [0] * 16
    for n in range(1, 15):
        offs[n + 1] = offs[n] + count[n]
    syms = [0] * len(lengths)
    for s, n in enumerate(lengths):
        if n:
            syms[offs[n]] = s
            offs[n] += 1
    return count, syms


def _decode(br: _Bits, h) -> int:
    count, syms = h
    code = first = index = 0
    for n in range(1, 16):
        code |= br.need(1)
        c = count[n]
        if code - c < first:
            return syms[index + (code - first)]
        index += c
        first = (first + c) << 1
        code <<= 1
    raise StreamError("invalid Huffman code")


_FIXED = (_huffman([8] * 144 + [9] * 112 + [7] * 24 + [8] * 8),
          _huffman([5] * 30))


def inflate_block(raw: bytes, bitpos: int, window: bytes):
    """Decode the one block that starts at bit `bitpos` of raw DEFLATE
    data, after `window` bytes of history. Returns (its output, the bit
    after it, BFINAL)."""
    br = _Bits(raw, bitpos)
    final = br.need(1)
    btype = br.need(2)
    out = bytearray(window[-WINDOW:])
    start = len(out)
    if btype == 0:
        br.buf = br.cnt = 0                 # to the byte boundary
        if br.pos + 4 > len(raw):
            raise StreamError("truncated stored block")
        n = int.from_bytes(raw[br.pos:br.pos + 2], "little")
        if n ^ 0xFFFF != int.from_bytes(raw[br.pos + 2:br.pos + 4], "little"):
            raise StreamError("stored block length check")
        br.pos += 4
        if br.pos + n > len(raw):
            raise StreamError("truncated stored block")
        out += raw[br.pos:br.pos + n]
        br.pos += n
        return bytes(out[start:]), br.bitpos(), bool(final)
    if btype == 1:
        lit, dist = _FIXED
    elif btype == 2:
        nlen = br.need(5) + 257
        ndist = br.need(5) + 1
        ncode = br.need(4) + 4
        cl = [0] * 19
        for i in range(ncode):
            cl[_CLORDER[i]] = br.need(3)
        clh = _huffman(cl)
        lengths = []
        while len(lengths) < nlen + ndist:
            sym = _decode(br, clh)
            if sym < 16:
                lengths.append(sym)
            elif sym == 16:
                if not lengths:
                    raise StreamError("repeat with no previous length")
                lengths += [lengths[-1]] * (3 + br.need(2))
            elif sym == 17:
                lengths += [0] * (3 + br.need(3))
            else:
                lengths += [0] * (11 + br.need(7))
        if len(lengths) > nlen + ndist or lengths[256] == 0:
            raise StreamError("bad code lengths")
        lit, dist = _huffman(lengths[:nlen]), _huffman(lengths[nlen:])
    else:
        raise StreamError("block type 3")
    while True:
        sym = _decode(br, lit)
        if sym < 256:
            out.append(sym)
        elif sym == 256:
            return bytes(out[start:]), br.bitpos(), bool(final)
        else:
            sym -= 257
            if sym >= 29:
                raise StreamError("bad length symbol")
            n = _LBASE[sym] + br.need(_LEXT[sym])
            ds = _decode(br, dist)
            if ds >= 30:
                raise StreamError("bad distance symbol")
            d = _DBASE[ds] + br.need(_DEXT[ds])
            if d > len(out):
                raise StreamError("distance too far back")
            for _ in range(n):
                out.append(out[-d])


# ---- the checks

def check_stream(stream: bytes, payload: bytes) -> dict:
    """A gzip member against the payload it should hold: its header by RFC
    1952, its body by zlib's raw inflate (which must end where the trailer
    starts), its trailer against CRC-32 and ISIZE worked out from the
    payload. Returns {"rejected": 0 or 1, "differing": bytes that differ,
    "raw": the body, "seams": {sync byte offset: bytes before it}} (the
    last two only where the body decodes)."""
    try:
        hl = gzip_header_len(stream)
    except StreamError:
        return {"rejected": 1, "differing": len(payload)}
    body = stream[hl:]
    d = zlib.decompressobj(-15)
    try:
        out = d.decompress(body)
    except zlib.error:
        return {"rejected": 1, "differing": len(payload)}
    rest = d.unused_data
    bad = not d.eof or len(rest) != 8
    if not bad:
        crc = int.from_bytes(rest[:4], "little")
        isize = int.from_bytes(rest[4:], "little")
        bad = (crc != zlib.crc32(payload) or crc != zlib.crc32(out)
               or isize != len(payload) & 0xFFFFFFFF)
    return {"rejected": int(bad), "differing": bytes_differing(out, payload),
            "raw": body[:len(body) - len(rest)], "header_len": hl}


def seam_sizes(raw: bytes, seams) -> dict:
    """Bytes of output before each byte offset in `seams`, by zlib's raw
    inflate fed up to each (a sync-flushed seam emits everything before
    it)."""
    d = zlib.decompressobj(-15)
    got, prev, out = {}, 0, 0
    for s in sorted(seams):
        out += len(d.decompress(raw[prev:s]))
        got[s] = out
        prev = s
    return got


def check_index(raw: bytes, index: dict, payload: bytes, rng,
                samples: int = 3) -> tuple[list, int]:
    """A decode index against its raw stream and payload: the sizes (n, one
    window list per block), the offsets rising from 0, every sync seam at
    an entry whose output offset zlib confirms, and `samples` entries drawn
    by rng each decoded from its bit offset, block after block (a stored
    stretch longer than 65,535 bytes is several blocks; a seam follows the
    sync flush's empty blocks), to end exactly at the next entry's bit
    offset, or at the final block for the last entry. Returns (a line for
    each fault, sampled entries whose output length differs from the
    index's: C7)."""
    faults = []
    n = len(payload)
    bits = list(index.get("block_bits", []))
    outs = list(index.get("block_bytes", []))
    if index.get("n") != n:
        faults.append(f"n {index.get('n')} for {n} bytes")
    if len(bits) != len(outs) or len(index.get("win", [])) != len(bits):
        faults.append(f"{len(bits)} bit offsets, {len(outs)} output "
                      f"offsets, {len(index.get('win', []))} window lists")
    if n and not bits:
        faults.append("no entries")
    if faults or not bits:
        return faults, 0
    if outs[0] != 0 or bits[0] != 0:
        faults.append("the first entry is not at 0")
    for name, xs in (("output", outs), ("bit", bits)):
        for k, (a, b) in enumerate(zip(xs, xs[1:])):
            if b <= a:
                faults.append(f"{name} offset of entry {k + 1} does not rise")
    if outs[-1] >= n:
        faults.append("the last entry starts past the payload")
    if faults:
        return faults, 0
    at = dict(zip(bits, outs))
    seams = list(index.get("sync_points", []))
    for s, size in seam_sizes(raw, seams).items():
        if at.get(8 * s) != size:
            faults.append(f"seam at byte {s}: entry output offset "
                          f"{at.get(8 * s)}, zlib {size}")
    c7 = 0
    for i in sorted(set(int(k) for k in rng.integers(0, len(bits),
                                                      samples))):
        end_out = outs[i + 1] if i + 1 < len(outs) else n
        nxt = bits[i + 1] if i + 1 < len(bits) else None
        # a whole window, zeros before the payload's start: the structure
        # of a block does not depend on its history's bytes
        hist = payload[max(outs[i] - WINDOW, 0):outs[i]]
        hist = bytes(WINDOW - len(hist)) + hist
        pos, made, final = bits[i], 0, False
        try:
            while not final and (nxt is None or pos < nxt):
                got, pos, final = inflate_block(raw, pos, hist)
                made += len(got)
                hist = (hist + got)[-WINDOW:]
        except StreamError as e:
            faults.append(f"entry {i} at bit {bits[i]}: {e}")
            continue
        if nxt is not None and pos != nxt:
            faults.append(f"entry {i}: its blocks end at bit {pos}, the "
                          f"next entry starts at {nxt}")
        if nxt is None and not final:
            faults.append(f"entry {i}, the last, ends before a final block")
        c7 += made != end_out - outs[i]
    return faults, c7
