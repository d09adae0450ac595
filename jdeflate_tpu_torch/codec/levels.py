"""Compression level configs (a copy of jdeflate_tpu/codec/levels.py).

Mirrors the reference's per-level match-search tuning table
(setparameters, src/deflator.c:241-263): (good, nice, chain) =
L1=(8,4,2) L2=(8,8,8) L3=(8,16,16) L4=(8,32,32) L5=(8,64,128)
L6=(16,16,48) L7=(32,64,128) L8=(64,128,320) L9=(192,256,512);
levels 1-5 parse greedily, 6-9 lazily (compress1/compress2).

`probes` is the batched hash-bucket probe depth, the analog of the
reference's `chain` walk bound (each probe visits the same candidate the
chain walk would, newest first). `_PROBE_CAP` is a module dict that
`get_level` reads at call time, so a caller (the CPU tests) may lower it.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class LevelConfig:
    level: int
    probes: int        # hash-bucket candidates examined per position
    lazy: bool
    good_length: int   # lazy: accept immediately at or above this length
    ext_top: int = 8   # top-T distance passes in exact match extension
    ext_rounds: int = 4   # residual gather-compare rounds (16 bytes each)
    ext_mdiv: int = 16    # residual compaction cap divisor (M = N/ext_mdiv)
    rescue: bool = False  # 3-byte secondary hash (deflator.c:49-70, levels>=6)
    probe_words: int = 8  # co-sorted prefix words (4B each) per candidate
    chunk: int = 8192     # block-splitter granularity (bytes of input)
    tree_both: bool = False  # evaluate PM + two-queue trees, pick cheaper
    split_c0: float = 120.0   # split DP header-cost estimate: constant bits
    split_c1: float = 5.5     # ... + per-distinct-symbol bits


_CHAIN = {1: 2, 2: 8, 3: 16, 4: 32, 5: 128, 6: 48, 7: 128, 8: 320, 9: 512}
_PROBE_CAP = {1: 2, 2: 8, 3: 16, 4: 24, 5: 32, 6: 48, 7: 128, 8: 320, 9: 512}
_EXT_TOP = {1: 8, 2: 8, 3: 8, 4: 8, 5: 8, 6: 8, 7: 8, 8: 16, 9: 16}
_EXT_ROUNDS = {1: 2, 2: 2, 3: 2, 4: 2, 5: 2, 6: 2, 7: 4, 8: 8, 9: 16}
_EXT_MDIV = {1: 64, 2: 64, 3: 64, 4: 64, 5: 64, 6: 64, 7: 32, 8: 16, 9: 16}


def get_level(level: int) -> LevelConfig:
    if not 0 <= level <= 9:
        raise ValueError(f"level must be 0..9, got {level}")
    if level == 0:
        # stored-only (compress0, deflator.c:796-926): no match search
        return LevelConfig(level=0, probes=0, lazy=False, good_length=0)
    # good_length=259: the cost-aware lazy deferral rule alone decides (the
    # reference's early accept at goodlength, deflator.c:2834-2846, has no
    # batched analog)
    return LevelConfig(
        level=level,
        probes=min(_CHAIN[level], _PROBE_CAP[level]),
        lazy=level >= 6,
        good_length=259,
        ext_top=_EXT_TOP[level],
        ext_rounds=_EXT_ROUNDS[level],
        ext_mdiv=_EXT_MDIV[level],
        rescue=level >= 6,
        probe_words=16 if level >= 8 else 8,
        chunk=2048 if level >= 8 else 8192,
        split_c0=140.0 if level >= 8 else 120.0,
        tree_both=level >= 8,
    )
