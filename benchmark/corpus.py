"""The benchmark's payloads: a seeded Silesia-like mix of real text, words,
records with noise, runs and near-random bytes.

The generator is jdeflate_tpu_torch/bench/corpus.py's (itself bench.py's)
with two changes that make it a yardstick: every payload is drawn from a
seed and its own index, and the real text is frozen in data/real_text.txt
(315,242 bytes of C, C++ and Python sources), so every checkout and every
later version of the program sees the same bytes. The timed payloads take
the configuration's content seed, the fresh payload judged after the window
the run's seed (generator.py).
"""
from __future__ import annotations

import functools
import os

import numpy as np

REAL_TEXT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                         "real_text.txt")
WORDS = [b"the ", b"of ", b"and ", b"compression ", b"deflate ",
         b"window ", b"entropy ", b"stream ", b"block ", b"huffman ",
         b"match ", b"distance ", b"symbol ", b"encode ", b"decode \n"]
# segment kinds: 0 synthetic words, 1 records with noise, 2 runs, 3 near
# random, 4 real text
MIX = (0, 1, 2, 3, 4)
TEXT = (0, 4)
KINDS = {"silesia_mix": MIX, "text": TEXT}


@functools.lru_cache(maxsize=1)
def real_text() -> bytes:
    with open(REAL_TEXT, "rb") as f:
        return f.read()


def rng_for(seed: int, index: int) -> np.random.Generator:
    """The generator of payload `index` under `seed` (any whole number,
    negative ones included)."""
    return np.random.default_rng([seed & ((1 << 64) - 1), index])


def make_payload(n: int, seed: int, index: int, kinds=MIX) -> bytes:
    """n bytes of the mix, drawn from (seed, index); segments of a kind
    outside `kinds` are drawn again."""
    rng = rng_for(seed, index)
    real = np.frombuffer(real_text(), np.uint8)
    ref_pos = int(rng.integers(len(real)))
    parts = []
    total = 0
    while total < n:
        kind = int(rng.integers(5))
        if kind not in kinds:
            continue
        if kind == 0:       # synthetic text
            k = int(rng.integers(1 << 16, 1 << 18))
            idx = rng.integers(0, len(WORDS), k // 6)
            seg = b"".join(WORDS[i] for i in idx)[:k]
        elif kind == 1:     # structured records with noise
            rec = rng.integers(0, 256, 96, dtype=np.uint8)
            reps = int(rng.integers(500, 3000))
            m = np.tile(rec, (reps, 1))
            noise = rng.integers(0, 96, reps)
            m[np.arange(reps), noise] = rng.integers(0, 256, reps)
            seg = m.tobytes()
        elif kind == 2:     # runs
            k = int(rng.integers(1 << 15, 1 << 17))
            vals = rng.integers(0, 8, k // 64, dtype=np.uint8)
            seg = np.repeat(vals, 64).tobytes()
        elif kind == 3:     # high entropy
            k = int(rng.integers(1 << 14, 1 << 16))
            seg = rng.integers(0, 256, k, dtype=np.uint8).tobytes()
        else:               # real source text
            k = int(rng.integers(1 << 16, 1 << 18))
            seg = real[np.arange(ref_pos, ref_pos + k) % len(real)].tobytes()
            ref_pos = (ref_pos + k) % len(real)
        parts.append(seg)
        total += len(seg)
    return b"".join(parts)[:n]
