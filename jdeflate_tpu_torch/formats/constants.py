"""RFC 1951/1950/1952 format constants as numpy arrays.

These mirror the semantic content of the reference's constant tables
(jdeflate: src/deflator.c:2987-3110 fixed code tables, src/deflator.c:2169-2284
length/distance symbol mappers, src/inflator.c:336-373 base+extra tables,
src/inflator.c:1029 precode order) but are generated directly from the RFC 1951
definitions rather than transcribed.

All tables are plain numpy; device code converts them to jnp constants at trace
time so XLA can fold them.
"""
from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Core format parameters (RFC 1951; reference: deflator.c:21-45, inflator.c:22-32)
# ---------------------------------------------------------------------------
WINDOW_BITS = 15
WINDOW_SIZE = 1 << WINDOW_BITS          # 32768: max back-reference distance
MIN_MATCH = 3
MAX_MATCH = 258
MAX_CODE_BITS = 15                      # lit/len + dist code length limit
MAX_PRECODE_BITS = 7                    # code-length ("precode") limit
NUM_LITLEN = 288                        # 0..287 (286/287 never used in dynamic)
NUM_LITLEN_USED = 286
NUM_DIST = 32                           # 30 used + 2 reserved
NUM_DIST_USED = 30
NUM_PRECODE = 19
EOB = 256                               # end-of-block symbol
MAX_STORED = 65535                      # stored-block LEN field limit

# Order in which precode (code-length code) lengths appear in a dynamic header
# (RFC 1951 §3.2.7; reference: deflator.c:1357-1359, inflator.c precode order).
PRECODE_ORDER = np.array(
    [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15],
    dtype=np.int32,
)

# ---------------------------------------------------------------------------
# Length symbols 257..285: base length and number of extra bits (RFC 1951
# §3.2.5; reference: inflator.c:336-353 `lnsinfo`).
# ---------------------------------------------------------------------------
LENGTH_EXTRA = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2,
     3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0],
    dtype=np.int32,
)
LENGTH_BASE = np.zeros(29, dtype=np.int32)
_l = 3
for _i in range(29):
    LENGTH_BASE[_i] = _l
    _l += 1 << LENGTH_EXTRA[_i]
# Symbol 285 is the special case: base 258, 0 extra.
LENGTH_BASE[28] = 258

# length (3..258) -> length symbol (257..285) and extra-bit value.
# Mirrors the semantics of the reference's 256-entry `lsymbols` LUT
# (deflator.c:2245-2284), built from the RFC tables.
LENGTH_TO_SYMBOL = np.zeros(256, dtype=np.int32)   # index by length-3
LENGTH_TO_EXTRA_VAL = np.zeros(256, dtype=np.int32)
for _len in range(3, 259):
    if _len == 258:
        _s = 28
    else:
        _s = int(np.searchsorted(LENGTH_BASE[:28], _len, side="right")) - 1
    LENGTH_TO_SYMBOL[_len - 3] = 257 + _s
    LENGTH_TO_EXTRA_VAL[_len - 3] = _len - LENGTH_BASE[_s]

# ---------------------------------------------------------------------------
# Distance symbols 0..29 (RFC 1951 §3.2.5; reference: inflator.c:356-373
# `dstinfo`).
# ---------------------------------------------------------------------------
DIST_EXTRA = np.array(
    [0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6,
     7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13],
    dtype=np.int32,
)
DIST_BASE = np.zeros(30, dtype=np.int32)
_d = 1
for _i in range(30):
    DIST_BASE[_i] = _d
    _d += 1 << DIST_EXTRA[_i]

# distance (1..32768) -> symbol via the classic two-table fold: distances
# 1..256 index table A by d-1, distances 257..32768 index table B by (d-1)>>7.
# Mirrors the reference's `dsymbols` 256+256 scheme (deflator.c:2169-2243).
DIST_TO_SYMBOL_LO = np.zeros(256, dtype=np.int32)
for _dd in range(1, 257):
    DIST_TO_SYMBOL_LO[_dd - 1] = int(np.searchsorted(DIST_BASE, _dd, side="right")) - 1
DIST_TO_SYMBOL_HI = np.zeros(256, dtype=np.int32)
for _k in range(2, 256):
    _dd = (_k << 7) + 1  # smallest distance mapping to this slot (d>256 => k>=2)
    DIST_TO_SYMBOL_HI[_k] = int(np.searchsorted(DIST_BASE, _dd, side="right")) - 1

# ---------------------------------------------------------------------------
# Fixed (static) Huffman code lengths (RFC 1951 §3.2.6; reference fixed tables
# deflator.c:2987-3110 / inflator.c:1840-2164 are the compiled form of these).
# ---------------------------------------------------------------------------
FIXED_LITLEN_LENGTHS = np.zeros(288, dtype=np.int32)
FIXED_LITLEN_LENGTHS[0:144] = 8
FIXED_LITLEN_LENGTHS[144:256] = 9
FIXED_LITLEN_LENGTHS[256:280] = 7
FIXED_LITLEN_LENGTHS[280:288] = 8
FIXED_DIST_LENGTHS = np.full(32, 5, dtype=np.int32)


def canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """Canonical Huffman codes (MSB-first values) for a length array.

    RFC 1951 §3.2.2 algorithm: counts per length -> first code per length via
    prefix sum -> sequential assignment. (Reference: deflator.c:1188-1285
    `setuptable`.) Returns code values; callers bit-reverse for the LSB-first
    bitstream.
    """
    lengths = np.asarray(lengths, dtype=np.int64)
    max_bits = int(lengths.max()) if lengths.size else 0
    bl_count = np.bincount(lengths, minlength=max_bits + 1)
    bl_count[0] = 0
    next_code = np.zeros(max_bits + 2, dtype=np.int64)
    code = 0
    for bits in range(1, max_bits + 1):
        code = (code + bl_count[bits - 1]) << 1
        next_code[bits] = code
    codes = np.zeros_like(lengths)
    for i in range(len(lengths)):
        l = lengths[i]
        if l > 0:
            codes[i] = next_code[l]
            next_code[l] += 1
    return codes.astype(np.int64)


def reverse_bits(codes: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Bit-reverse each code within its length (reference: deflator.c:1083-1136)."""
    codes = np.asarray(codes, dtype=np.int64)
    out = np.zeros_like(codes)
    for i in range(len(codes)):
        c, l = int(codes[i]), int(lengths[i])
        r = 0
        for _ in range(l):
            r = (r << 1) | (c & 1)
            c >>= 1
        out[i] = r
    return out


# Precompiled fixed-code emission tables (LSB-first, i.e. bit-reversed).
FIXED_LITLEN_CODES = canonical_codes(FIXED_LITLEN_LENGTHS)
FIXED_LITLEN_CODES_REV = reverse_bits(FIXED_LITLEN_CODES, FIXED_LITLEN_LENGTHS)
FIXED_DIST_CODES = canonical_codes(FIXED_DIST_LENGTHS)
FIXED_DIST_CODES_REV = reverse_bits(FIXED_DIST_CODES, FIXED_DIST_LENGTHS)
