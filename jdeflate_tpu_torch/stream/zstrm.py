"""Framed decompression: the decompress side of the reference's zstrm.

Reproduced from jdeflate_tpu/stream/zstrm.py (reference src/zstrm.c):
first-byte format autodetection against an accepted-format mask (parsehead,
zstrm.c:567-624), gzip multi-member decode (RFC 1952 §2.2) with FEXTRA
self-indexed members, the zlib FDICT preset-dictionary protocol with adler32
id verification (zstrm_setdctnr, zstrm.c:326-390), and trailer checksum
verification (checkgziptail / checkzlibtail, zstrm.c:626-693). Checksums run
on the decode device.
"""
from __future__ import annotations

from ..codec.inflate import RawInflater
from ..formats import headers as H
from ..ops import checksum as cs
from . import host_inflate as hi
from . import native
from ..utils import errors

_FORMATS = ("raw", "zlib", "gzip")


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
    offsets relative to the raw deflate body) as returned by the JAX
    package's compress_with_index or RawInflater.build_index. gzip inputs
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
