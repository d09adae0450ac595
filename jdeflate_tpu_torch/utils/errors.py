"""Error taxonomy mirroring the reference's codes (SURVEY.md §2.2).

Reference: INFLT_EBADCODE/EBADTREE/EFAROFFSET/EBADBLOCK/EINPUTEND/EOOM/
EINCORRECTUSE/EBADSTATE (jdeflate/inflator.h:56-66); zstrm adds
EFORMAT/EBADDICT/EMISSINGDICT/ECHECKSUM (jdeflate/zstrm.h). Streams latch
errors and refuse further work (the poisoned 0xDEADBEEF state,
inflator.c:769-781) — here that is `StreamPoisonedError` raised on reuse.
"""
from __future__ import annotations


class JDeflateError(Exception):
    """Base class for all framework errors."""


class BadCodeError(JDeflateError):
    """Invalid Huffman code in the stream (INFLT_EBADCODE)."""


class BadTreeError(JDeflateError):
    """Invalid code-length tree (INFLT_EBADTREE)."""


class FarOffsetError(JDeflateError):
    """Back-reference beyond available history (INFLT_EFAROFFSET)."""


class BadBlockError(JDeflateError):
    """Malformed block (INFLT_EBADBLOCK)."""


class InputEndError(JDeflateError):
    """Truncated input (INFLT_EINPUTEND)."""


class IncorrectUseError(JDeflateError):
    """API misuse (DEFLT/INFLT_EINCORRECTUSE)."""


class StreamPoisonedError(JDeflateError):
    """Stream previously errored and is latched dead (EBADSTATE)."""


class FormatError(JDeflateError):
    """Unrecognized or unaccepted framing format (ZSTRM_EFORMAT)."""


class BadDictError(JDeflateError):
    """Dictionary id mismatch (ZSTRM_EBADDICT)."""


class MissingDictError(JDeflateError):
    """Stream requires a preset dictionary (ZSTRM_EMISSINGDICT)."""


class ChecksumError(JDeflateError):
    """Trailer checksum mismatch (ZSTRM_EBADCHECKSUM)."""
