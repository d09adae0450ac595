"""Framed compression and decompression: the reference's zstrm without the
incremental ZStream object.

Reproduced from jdeflate_tpu/stream/zstrm.py (reference src/zstrm.c): raw,
zlib and gzip framing of the block-batch encoder (with the FEXTRA index
subfield, RFC 1952 §2.3.1.1, and the zlib FDICT preset dictionary),
first-byte format autodetection against an accepted-format mask (parsehead,
zstrm.c:567-624), gzip multi-member decode (RFC 1952 §2.2) with FEXTRA
self-indexed members, the zlib FDICT preset-dictionary protocol with adler32
id verification (zstrm_setdctnr, zstrm.c:326-390), and trailer checksum
verification (checkgziptail / checkzlibtail, zstrm.c:626-693). Checksums run
on the decode device.
"""
from __future__ import annotations

from ..codec.deflate import RawDeflater
from ..codec.inflate import RawInflater
from ..formats import headers as H
from ..ops import checksum as cs
from . import host_inflate as hi
from . import native
from ..utils import errors

_FORMATS = ("raw", "zlib", "gzip")


def compress(data: bytes, format: str = "gzip", level: int = 6,
             dictionary: bytes | None = None, block_size: int = 1 << 16,
             batch: int = 16, fixed_codes: bool = False,
             embed_index: bool = False, device="cuda") -> bytes:
    """One-shot framed compression on `device`. Returns the framed stream.

    embed_index=True (gzip only) stores the parallel-decode index in a
    FEXTRA subfield so decompress() takes the windowed device path with no
    index handed over; foreign decoders skip the field. It costs about 18%
    of the compressed size (one 6-bit anchor per 32 stream bits), so it is
    opt-in: the index from compress_with_index() is free.
    """
    if format not in _FORMATS:
        raise errors.IncorrectUseError(f"unknown format {format!r}")
    if format == "gzip" and dictionary:
        raise errors.IncorrectUseError("gzip framing has no dictionary field")
    enc = RawDeflater(level=level, block_size=block_size, batch=batch,
                      fixed_codes=fixed_codes, device=device)
    dev = enc.device
    raw, index = enc.compress(data, dictionary=dictionary)
    if format == "raw":
        return raw
    if format == "gzip":
        if embed_index:
            index["clen"] = len(raw)
            hdr = H.emit_gzip_header_with_extra(H.pack_index(index))
        else:
            hdr = H.emit_gzip_header()
        return (hdr + raw + H.emit_gzip_trailer(cs.crc32(data, device=dev),
                                                len(data)))
    dictid = cs.adler32(dictionary, device=dev) if dictionary else None
    return (H.emit_zlib_header(level, dictid) + raw
            + H.emit_zlib_trailer(cs.adler32(data, device=dev)))


def compress_with_index(data: bytes, format: str = "gzip", level: int = 6,
                        dictionary: bytes | None = None,
                        block_size: int = 1 << 16, batch: int = 16,
                        device="cuda"):
    """Like compress() but also returns the parallel-decode index and the
    header length: (stream, index, header_len)."""
    if format not in _FORMATS:
        raise errors.IncorrectUseError(f"unknown format {format!r}")
    enc = RawDeflater(level=level, block_size=block_size, batch=batch,
                      device=device)
    dev = enc.device
    raw, index = enc.compress(data, dictionary=dictionary)
    if format == "raw":
        return raw, index, 0
    if format == "gzip":
        hdr = H.emit_gzip_header()
        out = hdr + raw + H.emit_gzip_trailer(cs.crc32(data, device=dev),
                                              len(data))
    else:
        dictid = cs.adler32(dictionary, device=dev) if dictionary else None
        hdr = H.emit_zlib_header(level, dictid)
        out = hdr + raw + H.emit_zlib_trailer(cs.adler32(data, device=dev))
    return out, index, len(hdr)


def _seq_inflate(body: bytes, dictionary: bytes = b""):
    """Sequential one-pass decode of a raw stream -> (out, end_bit)."""
    if native.available():
        out, _, endbit = native.inflate(body, dictionary)
    else:
        out, _, endbit = hi.inflate_raw(body, dictionary)
    return out, endbit


def decompress(data: bytes, format: str = "auto",
               dictionary: bytes | None = None, verify: bool = True,
               index=None, header_len: int | None = None,
               device="cuda") -> bytes:
    """One-shot framed decompression with checksum verification.

    format: 'auto' accepts any of raw/zlib/gzip by first-byte detection, or
    one of the three. index/header_len: optional parallel-decode index (bit
    offsets relative to the raw deflate body) as returned by
    compress_with_index (of either package) or RawInflater.build_index. gzip inputs
    may hold several members; all are decoded and concatenated, each trailer
    verified. Without an index, a gzip member decodes sequentially on the
    host unless its header carries an embedded (FEXTRA) index.
    """
    accepted = set(_FORMATS) if format == "auto" else {format}
    if format not in _FORMATS + ("auto",):
        raise errors.IncorrectUseError(f"unknown format {format!r}")
    if not data:
        raise errors.InputEndError("empty stream")
    fmt = H.detect_format(data[0], accepted)

    dec = RawInflater(device=device)
    dev = dec.device
    if fmt == "raw":
        return dec.decompress(data, index=index, dictionary=dictionary or b"")

    if fmt == "gzip":
        hl = H.parse_gzip_header(data)
        if index is not None:
            # single member whose index the caller holds
            if header_len not in (None, hl):
                raise errors.IncorrectUseError("index/header mismatch")
            out = dec.decompress(data[hl:], index=index)
            if verify:
                H.check_gzip_trailer(data[-8:], cs.crc32(out, device=dev),
                                     len(out))
            return out
        # multi-member loop; members carrying an embedded FEXTRA index take
        # the windowed device path with no sequential decode
        out = bytearray()
        pos = 0
        while True:
            hl = H.parse_gzip_header(data[pos:])
            body = data[pos + hl:]
            emb = H.unpack_index(
                H.parse_gzip_extra(data[pos:pos + hl + 4]) or b"")
            if emb is not None and emb.get("clen"):
                nbytes = emb["clen"]
                o = dec.decompress(body[:nbytes], index=emb)
            else:
                o, endbit = _seq_inflate(body)
                nbytes = (endbit + 7) // 8
            if verify:
                H.check_gzip_trailer(body[nbytes:nbytes + 8],
                                     cs.crc32(o, device=dev), len(o))
            elif len(body) < nbytes + 8:
                raise errors.InputEndError("truncated gzip trailer")
            out += o
            pos += hl + nbytes + 8
            if pos >= len(data) or data[pos:pos + 2] != b"\x1f\x8b":
                break
        return bytes(out)

    hl, dictid = H.parse_zlib_header(data)
    if dictid is not None:
        if dictionary is None:
            raise errors.MissingDictError("stream requires a preset dictionary")
        if cs.adler32(dictionary, device=dev) != dictid:
            raise errors.BadDictError("dictionary id mismatch")
    body = data[hl:]
    out = dec.decompress(body, index=index, dictionary=dictionary or b"")
    if verify:
        H.check_zlib_trailer(data[-4:], cs.adler32(out, device=dev))
    return out
