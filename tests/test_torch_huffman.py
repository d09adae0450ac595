"""Parity of the port's Huffman builders (jdeflate_tpu_torch.ops.huffman) and
bit packer (ops.bitpack) with the JAX package on the CPU: exact equality of
code lengths (package-merge and two-queue), canonical codes, and packed
words, offsets and totals."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jdeflate_tpu.formats import constants as C
from jdeflate_tpu.ops import bitpack as jbp
from jdeflate_tpu.ops import huffman as jhf
from jdeflate_tpu_torch.ops import bitpack as tbp
from jdeflate_tpu_torch.ops import huffman as thf


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small; torch's default thread pool only spins
    against the other test workers' JAX compiles."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _freq_sets(seed):
    """The frequency shapes of tests/test_huffman.py plus random and
    degenerate tables (0, 1 and 2 used symbols) and tied counts."""
    rng = np.random.default_rng(seed)
    out = []
    for n, L in ((286, 15), (30, 15), (19, 7)):
        # Fibonacci weights force the length limit; past 28 terms the rest
        # are 1s, keeping the total under 2^30 as every real block does
        fib = [1, 1]
        while len(fib) < min(n, 28):
            fib.append(fib[-1] + fib[-2])
        fib += [1] * (n - len(fib))
        kinds = [
            rng.integers(0, 100, n),
            (rng.random(n) < 0.1) * rng.integers(1, 10000, n),
            np.zeros(n, np.int64),                       # no symbol
            np.eye(1, n, int(rng.integers(0, n)), dtype=np.int64)[0] * 5,
            np.eye(1, n, 3, dtype=np.int64)[0] * 7 + np.eye(1, n, n - 1,
                                                            dtype=np.int64)[0],
            np.ones(n, np.int64),                        # all tied
            rng.integers(0, 4, n),                       # many ties
            np.asarray(fib[:n], np.int64),               # forces the limit
        ]
        k = int(rng.integers(2, n))
        f = np.zeros(n, np.int64)
        f[:k] = 2 ** rng.integers(0, 14, k)
        kinds.append(f)
        out.append((n, L, np.stack(kinds).astype(np.int32)))
    return out


@pytest.mark.parametrize("seed", range(3))
def test_code_lengths_pm_and_two_queue_match_jax(seed):
    for n, L, freqs in _freq_sets(seed):
        fj = jnp.asarray(freqs)
        ft = torch.from_numpy(freqs)
        want_pm = np.asarray(jax.vmap(lambda f: jhf.code_lengths_pm(f, L))(fj))
        want_q = np.asarray(jax.vmap(lambda f: jhf.code_lengths(f, L))(fj))
        np.testing.assert_array_equal(
            thf.code_lengths_pm(ft, L).numpy(), want_pm, err_msg=f"pm n={n}")
        np.testing.assert_array_equal(
            thf.code_lengths(ft, L).numpy(), want_q, err_msg=f"2q n={n}")


@pytest.mark.parametrize("seed", range(2))
def test_canonical_codes_and_build_codes_match_jax(seed):
    rng = np.random.default_rng(100 + seed)
    lengths = rng.integers(0, 9, (5, 288)).astype(np.int32)
    lengths[0] = C.FIXED_LITLEN_LENGTHS
    lengths[1] = 0
    for L in (15, 7):
        want = jax.vmap(lambda l: jhf.canonical_codes(l, L))(
            jnp.asarray(np.minimum(lengths, L)))
        got = thf.canonical_codes(torch.from_numpy(np.minimum(lengths, L)), L)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    freqs = rng.integers(0, 100, (4, 286)).astype(np.int32)
    want = jhf.build_codes(jnp.asarray(freqs), 15)
    got = thf.build_codes(torch.from_numpy(freqs), 15)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _items(rng, N, max_bits=48, zero_share=0.2):
    nb = rng.integers(0, max_bits + 1, N).astype(np.int32)
    nb[rng.random(N) < zero_share] = 0
    v = rng.integers(0, 1 << 62, N, dtype=np.int64) & ((1 << nb) - 1)
    lo = (v & 0xFFFFFFFF).astype(np.uint32)
    hi = (v >> 32).astype(np.uint32)
    return lo, hi, nb


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


PACK_CASES = ["random48", "byte_items", "word_aligned", "short_buffer"]


@pytest.mark.parametrize("case", PACK_CASES)
def test_pack_matches_jax(case):
    rng = np.random.default_rng(PACK_CASES.index(case))
    if case == "random48":
        lo, hi, nb = _items(rng, 3000)
    elif case == "byte_items":          # s == 0 boundaries throughout
        lo, hi, nb = _items(rng, 2000, 16)
        nb = np.where(nb > 0, 8 * rng.integers(1, 3, nb.shape), 0).astype(
            np.int32)
        lo = (lo & ((1 << nb.astype(np.uint64)) - 1)).astype(np.uint32)
        hi[:] = 0
    elif case == "word_aligned":        # 32- and 48-bit items on word edges
        nb = rng.choice([0, 16, 32, 48], 1500).astype(np.int32)
        v = rng.integers(0, 1 << 62, nb.shape, dtype=np.int64) \
            & ((1 << nb) - 1)
        lo = (v & 0xFFFFFFFF).astype(np.uint32)
        hi = (v >> 32).astype(np.uint32)
    else:                               # words past num_words are dropped
        lo, hi, nb = _items(rng, 500)
    nw = int(nb.sum()) // 32 + 4
    if case == "short_buffer":
        nw = nw // 2
    w, o, t = jbp.pack(jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(nb), nw)
    tw, to, tt = tbp.pack(_t(lo), _t(hi), _t(nb), nw)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(w).astype(np.int64))
    np.testing.assert_array_equal(to.numpy(), np.asarray(o))
    assert int(tt) == int(t)


def test_append_bits_and_combine64_match_jax():
    rng = np.random.default_rng(5)
    N = 4000
    n1 = rng.integers(0, 49, N)
    n1[:64] = np.arange(64) % 49                 # every boundary, 0 and 32
    v1 = rng.integers(0, 1 << 62, N, dtype=np.int64) & ((1 << n1) - 1)
    # second item: fits 64 bits, and 32 bits whenever n1 >= 32
    n2 = np.minimum(rng.integers(0, 33, N), 64 - n1)
    n2 = np.where(n1 >= 32, np.minimum(n2, 32), n2)
    v2 = rng.integers(0, 1 << 62, N, dtype=np.int64) & ((1 << n2) - 1)
    lo1, hi1 = (v1 & 0xFFFFFFFF).astype(np.uint32), (v1 >> 32).astype(
        np.uint32)
    lo2, hi2 = (v2 & 0xFFFFFFFF).astype(np.uint32), (v2 >> 32).astype(
        np.uint32)
    want = jbp.combine64(jnp.asarray(lo1), jnp.asarray(hi1),
                         jnp.asarray(n1, jnp.int32), jnp.asarray(lo2),
                         jnp.asarray(hi2), jnp.asarray(n2, jnp.int32))
    got = tbp.combine64(_t(lo1), _t(hi1), _t(n1), _t(lo2), _t(hi2), _t(n2))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(
            np.int64))
    # append_bits: a value of up to 32 bits at any fill 0..48 (n + nb <= 64)
    nbv = np.minimum(rng.integers(0, 33, N), 64 - n1)
    v = (rng.integers(0, 1 << 32, N, dtype=np.int64)
         & ((1 << nbv) - 1)).astype(np.uint32)
    want = jbp.append_bits(jnp.asarray(lo1), jnp.asarray(hi1),
                           jnp.asarray(n1, jnp.int32), jnp.asarray(v),
                           jnp.asarray(nbv, jnp.int32))
    got = tbp.append_bits(_t(lo1), _t(hi1), _t(n1), _t(v), _t(nbv))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(
            np.int64))
