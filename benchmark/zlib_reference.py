"""The plain reference for a zlib stream (RFC 1950) that another encoder
wrote. It imports nothing of the program, of JAX or of the JAX package:
the two-byte header is parsed here by RFC 1950, the DEFLATE body is decoded
by Python's zlib (raw inflate, wbits=-15), which must end where the 4-byte
trailer starts, and the trailer is held to the Adler-32 worked out again
from the payload. The index the program built for the body is held to it
by reference.check_index, the answers to the payload by
reference.bytes_differing.

Every check counts faults; a sound stream counts none.
"""
from __future__ import annotations

import zlib

from .reference import StreamError, bytes_differing


def zlib_header_len(b: bytes) -> int:
    """Length of the RFC 1950 header at the start of b: CM 8 (deflate),
    CINFO at most 7 (a window of at most 32 KiB), FCHECK making CMF * 256 +
    FLG a multiple of 31, and no FDICT (the streams judged here have no
    preset dictionary)."""
    if len(b) < 2:
        raise StreamError("truncated zlib header")
    cmf, flg = b[0], b[1]
    if cmf & 0x0F != 8:
        raise StreamError("CM is not 8 (deflate)")
    if cmf >> 4 > 7:
        raise StreamError("CINFO above 7")
    if (cmf << 8 | flg) % 31:
        raise StreamError("FCHECK")
    if flg & 0x20:
        raise StreamError("FDICT set: a preset dictionary")
    return 2


def check_stream(stream: bytes, payload: bytes) -> dict:
    """A zlib stream against the payload it should hold. Returns
    {"rejected": 0 or 1, "differing": bytes that differ, "raw": the DEFLATE
    body, "header_len": 2} (the last two only where the body decodes)."""
    try:
        hl = zlib_header_len(stream)
    except StreamError:
        return {"rejected": 1, "differing": len(payload)}
    body = stream[hl:]
    d = zlib.decompressobj(-15)
    try:
        out = d.decompress(body)
    except zlib.error:
        return {"rejected": 1, "differing": len(payload)}
    rest = d.unused_data
    bad = not d.eof or len(rest) != 4
    if not bad:
        adler = int.from_bytes(rest, "big")
        bad = adler != zlib.adler32(payload) or adler != zlib.adler32(out)
    return {"rejected": int(bad), "differing": bytes_differing(out, payload),
            "raw": body[:len(body) - len(rest)], "header_len": hl}
