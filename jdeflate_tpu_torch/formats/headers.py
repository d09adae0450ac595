"""RFC 1950 (zlib) / RFC 1952 (gzip) header and trailer handling.

Reference behavior reproduced: format autodetection by first byte
(parsehead, src/zstrm.c:567-624), gzip header parse with
FEXTRA/FNAME/FCOMMENT/FHCRC skipping and minimal 10-byte emission
(parsegziphead/emitgziphead, src/zstrm.c:446-509, 1003-1022), zlib CMF/FLG
parse with FDICT dictid and 0x78-based emission
(parsezlibhead/emitzlibhead, src/zstrm.c:513-565, 1024-1052), and the
CRC32+ISIZE / big-endian adler32 trailers (src/zstrm.c:626-693, 1233-1265).
"""
from __future__ import annotations

import struct

from ..utils import errors

GZIP_MAGIC = b"\x1f\x8b"

FTEXT = 1
FHCRC = 2
FEXTRA = 4
FNAME = 8
FCOMMENT = 16


def detect_format(first_byte: int, accepted: set[str]) -> str:
    """First-byte format heuristic (parsehead, zstrm.c:567-624)."""
    if first_byte == 0x1F and "gzip" in accepted:
        return "gzip"
    if (first_byte & 0x0F) == 0x08 and "zlib" in accepted:
        return "zlib"
    if (first_byte & 0x06) == 0x06:     # BTYPE=11 reserved: cannot be raw
        raise errors.FormatError("unrecognized stream header")
    if "raw" in accepted:
        return "raw"
    raise errors.FormatError("stream format not accepted")


def emit_gzip_header() -> bytes:
    """Minimal header: magic, CM=8, no flags, mtime 0, XFL 0, OS 255."""
    return GZIP_MAGIC + b"\x08\x00\x00\x00\x00\x00\x00\xff"


def parse_gzip_header(data: bytes) -> int:
    """Validate and skip a gzip header; returns its length."""
    if len(data) < 10:
        raise errors.InputEndError("truncated gzip header")
    if data[:2] != GZIP_MAGIC:
        raise errors.FormatError("bad gzip magic")
    if data[2] != 8:
        raise errors.FormatError("unsupported gzip compression method")
    flg = data[3]
    pos = 10
    if flg & FEXTRA:
        if len(data) < pos + 2:
            raise errors.InputEndError("truncated FEXTRA")
        xlen = data[pos] | (data[pos + 1] << 8)
        pos += 2 + xlen
    if flg & FNAME:
        end = data.find(b"\x00", pos)
        if end < 0:
            raise errors.InputEndError("truncated FNAME")
        pos = end + 1
    if flg & FCOMMENT:
        end = data.find(b"\x00", pos)
        if end < 0:
            raise errors.InputEndError("truncated FCOMMENT")
        pos = end + 1
    if flg & FHCRC:
        pos += 2
    if pos > len(data):
        raise errors.InputEndError("truncated gzip header")
    return pos


JD_SUBFIELD = b"JD"      # FEXTRA subfield id for the embedded decode index


def emit_gzip_header_with_extra(extra: bytes) -> bytes:
    """Header with one FEXTRA subfield (RFC 1952 §2.3.1.1). Foreign
    decoders skip FEXTRA, so interop is preserved."""
    sub = JD_SUBFIELD + struct.pack("<H", len(extra)) + extra
    return (GZIP_MAGIC + bytes([8, FEXTRA]) + b"\x00\x00\x00\x00\x00\xff"
            + struct.pack("<H", len(sub)) + sub)


def parse_gzip_extra(data: bytes) -> bytes | None:
    """Extract the JD subfield payload from a gzip header, if present."""
    if len(data) < 10 or data[:2] != GZIP_MAGIC or not (data[3] & FEXTRA):
        return None
    if len(data) < 12:
        return None
    xlen = data[10] | (data[11] << 8)
    pos, end = 12, 12 + xlen
    while pos + 4 <= min(end, len(data)):
        si = data[pos:pos + 2]
        sl = data[pos + 2] | (data[pos + 3] << 8)
        if si == JD_SUBFIELD:
            return bytes(data[pos + 4:pos + 4 + sl])
        pos += 4 + sl
    return None


def pack_index(index: dict) -> bytes:
    """Serialize a parallel-decode index for FEXTRA embedding.

    Layout: magic 'JDI1', n (u64), clen (u64, compressed body bytes),
    nentries (u32), then per entry: bit_offset u64, out_offset u64, nwin
    u32, packed 6-bit window-anchor deltas (63 = empty window; others =
    anchor - window_start in [0, 32)). The decoder reconstructs absolute
    anchors from each block header's symbol start (grid origin =
    sym_start & ~31, ops/walk.py).
    """
    import numpy as np
    out = bytearray(b"JDI1")
    out += struct.pack("<QQI", index["n"], index.get("clen", 0),
                       len(index["block_bits"]))
    wins = index.get("win") or [None] * len(index["block_bits"])
    for bit, byt, wa in zip(index["block_bits"], index["block_bytes"], wins):
        if wa is None:
            out += struct.pack("<QQI", bit, byt, 0)
            continue
        wa = np.asarray(wa, np.int64)
        grid0 = int(wa[0]) & ~31
        deltas = np.where(wa >= 0, wa - (grid0 + 32 * np.arange(len(wa))),
                          63).astype(np.uint8)
        out += struct.pack("<QQI", bit, byt, len(wa))
        bits = np.unpackbits(deltas[:, None], axis=1, count=6,
                             bitorder="little")[:, :6].reshape(-1)
        out += np.packbits(bits, bitorder="little").tobytes()
    return bytes(out)


def unpack_index(blob: bytes) -> dict | None:
    """Inverse of pack_index."""
    import numpy as np
    if len(blob) < 24 or blob[:4] != b"JDI1":
        return None
    n, clen, ne = struct.unpack_from("<QQI", blob, 4)
    pos = 24
    bits_l, bytes_l, wins = [], [], []
    for _ in range(ne):
        bit, byt, nw = struct.unpack_from("<QQI", blob, pos)
        pos += 20
        bits_l.append(bit)
        bytes_l.append(byt)
        if nw == 0:
            wins.append(None)
            continue
        nbytes = (nw * 6 + 7) // 8
        raw = np.frombuffer(blob[pos:pos + nbytes], np.uint8)
        pos += nbytes
        bb = np.unpackbits(raw, bitorder="little")[:nw * 6].reshape(nw, 6)
        deltas = np.packbits(
            np.pad(bb, ((0, 0), (0, 2))), axis=1,
            bitorder="little")[:, 0].astype(np.int64)
        wins.append(deltas)
    return {"n": n, "clen": clen, "block_bits": bits_l,
            "block_bytes": bytes_l, "win_deltas": wins,
            "sync_points": []}


def emit_gzip_trailer(crc: int, isize: int) -> bytes:
    return struct.pack("<II", crc & 0xFFFFFFFF, isize & 0xFFFFFFFF)


def check_gzip_trailer(data: bytes, crc: int, isize: int):
    if len(data) < 8:
        raise errors.InputEndError("truncated gzip trailer")
    want_crc, want_isize = struct.unpack("<II", data[:8])
    if want_crc != (crc & 0xFFFFFFFF):
        raise errors.ChecksumError("gzip CRC32 mismatch")
    if want_isize != (isize & 0xFFFFFFFF):
        raise errors.ChecksumError("gzip ISIZE mismatch")


def emit_zlib_header(level: int, dictid: int | None = None) -> bytes:
    cmf = 0x78                       # CM=8, CINFO=7 (32K window)
    flevel = 0 if level <= 1 else (1 if level <= 5 else (2 if level == 6 else 3))
    flg = (flevel << 6) | (0x20 if dictid is not None else 0)
    rem = (cmf * 256 + flg) % 31
    if rem:
        flg += 31 - rem
    out = bytes([cmf, flg])
    if dictid is not None:
        out += struct.pack(">I", dictid & 0xFFFFFFFF)
    return out


def parse_zlib_header(data: bytes):
    """Returns (header_len, dictid_or_None)."""
    if len(data) < 2:
        raise errors.InputEndError("truncated zlib header")
    cmf, flg = data[0], data[1]
    if (cmf & 0x0F) != 8:
        raise errors.FormatError("unsupported zlib compression method")
    if (cmf >> 4) > 7:
        raise errors.FormatError("zlib window too large")
    if (cmf * 256 + flg) % 31 != 0:
        raise errors.FormatError("bad zlib header check")
    if flg & 0x20:
        if len(data) < 6:
            raise errors.InputEndError("truncated zlib dictid")
        return 6, struct.unpack(">I", data[2:6])[0]
    return 2, None


def emit_zlib_trailer(adler: int) -> bytes:
    return struct.pack(">I", adler & 0xFFFFFFFF)


def check_zlib_trailer(data: bytes, adler: int):
    if len(data) < 4:
        raise errors.InputEndError("truncated zlib trailer")
    (want,) = struct.unpack(">I", data[:4])
    if want != (adler & 0xFFFFFFFF):
        raise errors.ChecksumError("zlib adler32 mismatch")
