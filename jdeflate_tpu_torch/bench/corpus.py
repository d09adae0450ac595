"""The bench's corpus: a deterministic Silesia-like mix of source text,
words, records with noise, runs and near-random bytes.

A byte-for-byte copy of bench.py's generator (seed 20260817), so that on
the same inputs the port's bench encodes the same bytes as the JAX
package's. Its real-text component is the reference C sources where their
directory is given; without them both benches use the same fallback text.
"""
from __future__ import annotations

import os

import numpy as np

SEED = 20260817
REFERENCE_FILES = ("src/deflator.c", "src/inflator.c", "src/zstrm.c",
                   "jdeflate/deflator.h", "jdeflate/inflator.h",
                   "jdeflate/zstrm.h", "README.md")
FALLBACK = b"static fallback text\n" * 1000
WORDS = [b"the ", b"of ", b"and ", b"compression ", b"deflate ",
         b"window ", b"entropy ", b"stream ", b"block ", b"huffman ",
         b"match ", b"distance ", b"symbol ", b"encode ", b"decode \n"]


def _reference_blob(reference_dir: str | None) -> bytes:
    """The reference's sources concatenated (b"" when none is readable)."""
    if reference_dir is None:
        return b""
    parts = []
    for rel in REFERENCE_FILES:
        try:
            with open(os.path.join(reference_dir, rel), "rb") as f:
                parts.append(f.read())
        except OSError:
            pass
    return b"".join(parts)


def corpus_text(reference_dir: str | None = None) -> str:
    """Which real text make_corpus uses: "reference" or "fallback"."""
    return "reference" if _reference_blob(reference_dir) else "fallback"


def reference_text(n: int, reference_dir: str | None = None) -> bytes:
    """n bytes of the real-text component: the reference's sources, or the
    fallback text where there are none, repeated."""
    blob = _reference_blob(reference_dir) or FALLBACK
    reps = n // len(blob) + 1
    return (blob * reps)[:n]


def make_corpus(n: int, reference_dir: str | None = None) -> bytes:
    """n bytes of the corpus (bench.py::make_corpus)."""
    rng = np.random.default_rng(SEED)
    parts = []
    ref = reference_text(n, reference_dir)
    ref_pos = 0
    total = 0
    while total < n:
        kind = rng.integers(5)
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
        else:               # real source text (C code)
            k = int(rng.integers(1 << 16, 1 << 18))
            seg = ref[ref_pos:ref_pos + k]
            ref_pos = (ref_pos + k) % max(len(ref) - (1 << 18), 1)
        parts.append(seg)
        total += len(seg)
    return b"".join(parts)[:n]
