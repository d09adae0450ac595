"""Parity of the port's match finder and parse (jdeflate_tpu_torch.ops.lz77)
with the JAX package on the CPU: (length, dist) at levels 1, 6 and 9, a
top-k cutoff that falls inside a tie, the lazy/greedy take rule, and the
token marks of the plain match walk against the JAX CPU walk; plus the
match walk's plist contract against a sequential loop. Tolerance: exact
equality (integer-only stages). The CUDA kernel's own check needs a card
(marker `cuda`)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jdeflate_tpu.codec import levels as jlevels
from jdeflate_tpu.ops import lz77 as jlz
from jdeflate_tpu_torch.codec import levels as tlevels
from jdeflate_tpu_torch.ops import lz77 as tlz

# both sides run the same (CPU-capped) probe depths, tests/conftest.py
tlevels._PROBE_CAP.update(jlevels._PROBE_CAP)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small; torch's default thread pool only spins
    against the other test workers' JAX compiles."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

HALO, PAD = 32768, 272


def _ext_rows(corpus, bl, kinds, with_history):
    """(B, HALO + bl + PAD) rows: one block of each kind, with (or without)
    32 KiB of history before it."""
    rows, vfrom = [], []
    for k, kind in enumerate(kinds):
        r = np.zeros(HALO + bl + PAD, np.uint8)
        blob = corpus(kind, HALO + bl)
        if with_history[k]:
            r[:HALO + bl] = np.frombuffer(blob, np.uint8)
            vfrom.append(0)
        else:
            r[HALO:HALO + bl] = np.frombuffer(blob[:bl], np.uint8)
            vfrom.append(HALO)
        rows.append(r)
    return np.stack(rows), np.asarray(vfrom, np.int32)


def _find_both(ext, block_len, vfrom, bl, level):
    cfg = jlevels.get_level(level)
    kw = dict(ext_top=cfg.ext_top, ext_rounds=cfg.ext_rounds,
              rescue=cfg.rescue, probe_words=cfg.probe_words,
              ext_mdiv=cfg.ext_mdiv)
    k = max(cfg.probes, 1)
    assert dataclasses.asdict(tlevels.get_level(level)) == \
        dataclasses.asdict(cfg)
    jl, jd = jlz.find_matches_batch(jnp.asarray(ext), jnp.asarray(block_len),
                                    jnp.asarray(vfrom), HALO, bl, PAD, k,
                                    **kw)
    tl, td = tlz.find_matches_batch(torch.from_numpy(ext),
                                    torch.from_numpy(block_len),
                                    torch.from_numpy(vfrom), HALO, bl, PAD,
                                    k, **kw)
    return (np.asarray(jl), np.asarray(jd)), (tl.numpy(), td.numpy())


@pytest.mark.parametrize("level", [1, 6, 9])
def test_find_matches_matches_jax(corpus, level):
    bl = 2048
    kinds = ["text", "runs", "binary", "zeros", "random"]
    ext, vfrom = _ext_rows(corpus, bl, kinds, [True, False, True, True, False])
    block_len = np.asarray([bl, bl, 1500, bl, bl], np.int32)
    (jl, jd), (tl, td) = _find_both(ext, block_len, vfrom, bl, level)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(td, jd)
    assert (tl > 0).any()


def _periodic_rows(periods, bl, runlen, seed):
    """Random blocks, each holding one periodic run: equal run lengths give
    every period the same count of boundary-capped matches."""
    rng = np.random.default_rng(seed)
    rows = []
    for p in periods:
        r = np.zeros(HALO + bl + PAD, np.uint8)
        blk = rng.integers(0, 256, bl).astype(np.uint8)
        pat = rng.integers(0, 256, p).astype(np.uint8)
        blk[100:100 + runlen] = np.tile(pat, runlen // p + 1)[:runlen]
        r[HALO:HALO + bl] = blk
        rows.append(r)
    return np.stack(rows)


def test_top_k_tie_at_the_cutoff_matches_jax():
    """Nine distances tie for the top count at level 6 (T = 8): lax.top_k
    keeps the eight lowest distances, and the port must keep the same."""
    bl, level = 2048, 6
    cfg = jlevels.get_level(level)
    periods = (5, 7, 9, 11, 13, 17, 19, 23, 29)
    ext = _periodic_rows(periods, bl, 700, seed=3)
    B = len(periods)
    block_len = np.full(B, bl, np.int32)
    vfrom = np.full(B, HALO, np.int32)
    # the stage-1 histogram, rebuilt from the link-rule lengths
    pl, pd = tlz.find_matches_batch(
        torch.from_numpy(ext), torch.from_numpy(block_len),
        torch.from_numpy(vfrom), HALO, bl, PAD, cfg.probes, exact_ext=False,
        ext_top=cfg.ext_top, rescue=cfg.rescue,
        probe_words=cfg.probe_words)
    full_l = torch.zeros(B, HALO + bl, dtype=torch.int64)
    full_d = torch.zeros_like(full_l)
    full_l[:, HALO:], full_d[:, HALO:] = pl, pd
    stuck = (full_l > 0) & (full_l % 16 == 0) & (full_l < 258)
    dws = torch.where(stuck, full_d, 0).reshape(-1)[::4]
    hist = torch.bincount(dws, minlength=HALO + 1)
    hist[0] = 0
    top = sorted(hist.tolist(), reverse=True)
    assert top[cfg.ext_top - 1] == top[cfg.ext_top] > 0, top[:10]
    (jl, jd), (tl, td) = _find_both(ext, block_len, vfrom, bl, level)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(td, jd)


def _random_matches(rng, B, bl, block_len):
    length = rng.integers(3, 40, (B, bl))
    length[rng.random((B, bl)) < 0.6] = 0
    length[:, ::97] = 258
    pos = np.arange(bl)[None, :]
    length = np.minimum(length, block_len[:, None] - pos)
    length = np.where(length >= 3, length, 0)
    dist = np.where(length > 0, rng.integers(1, 32769, (B, bl)), 0)
    return length.astype(np.int32), dist.astype(np.int32)


@pytest.mark.parametrize("lazy", [False, True])
def test_parse_take_and_token_marks_match_jax(lazy):
    rng = np.random.default_rng(7 + lazy)
    B, bl = 3, 4096
    block_len = np.asarray([bl, 3001, 17], np.int32)
    length, dist = _random_matches(rng, B, bl, block_len)
    jt = np.asarray(jlz.parse_take(jnp.asarray(length), jnp.asarray(dist),
                                   jnp.asarray(block_len), lazy, 259))
    tt = tlz.parse_take(torch.from_numpy(length).long(),
                        torch.from_numpy(dist).long(),
                        torch.from_numpy(block_len), lazy, 259)
    np.testing.assert_array_equal(tt.numpy(), jt)
    want = jlz.token_marks_batch(jnp.asarray(length), jnp.asarray(jt),
                                 jnp.asarray(block_len), bl)
    got = tlz.token_marks_batch(torch.from_numpy(length).long(), tt,
                                torch.from_numpy(block_len), bl)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _plist_loop(take, length, block_len, bl):
    """The plist contract by its definition: the sequential cursor from 0."""
    B = take.shape[0]
    out = np.zeros((B, tlz.WALK_CAP), np.int64)
    for b in range(B):
        p, k = 0, 1
        while p < block_len[b]:
            if take[b, p]:
                out[b, k] = p | (int(length[b, p]) << 17)
                k += 1
                p += int(length[b, p])
            else:
                p += 1
        out[b, 0] = k
    return out


@pytest.mark.parametrize("seed", range(3))
def test_match_walk_ref_plist_contract(seed):
    """Random take/length, short blocks, and matches that end exactly at
    the block end: the plain walk's plist equals the sequential loop, and
    its token marks equal the JAX CPU walk's."""
    rng = np.random.default_rng(seed)
    B, bl = 4, 2048
    block_len = np.asarray([bl, 1024, 1, 1999], np.int32)
    length, _ = _random_matches(rng, B, bl, block_len)
    # a match ending exactly at each block's end
    for b in range(B):
        if block_len[b] >= 8:
            length[b, block_len[b] - 5] = 5
    take = length >= 3
    pos = np.arange(bl)[None, :]
    take &= pos < block_len[:, None]
    lt = torch.from_numpy(length).long()
    tk = torch.from_numpy(take)
    blt = torch.from_numpy(block_len)
    cn, ln = tlz.walk_inputs(lt, tk, blt, bl)
    assert cn.shape[1] % 128 == 0 and cn.shape[1] > bl
    plist = tlz.match_walk_ref(cn, ln, blt, bl)
    assert plist.dtype == torch.int32
    np.testing.assert_array_equal(plist.numpy(), _plist_loop(
        take, length, block_len, bl))
    want = jlz.token_marks_batch(jnp.asarray(length), jnp.asarray(take),
                                 jnp.asarray(block_len), bl)
    got = tlz.token_marks_batch(lt, tk, blt, bl)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_orbit_and_parse_batch_match_jax():
    rng = np.random.default_rng(11)
    B, bl = 2, 1024
    block_len = np.asarray([bl, 700], np.int32)
    length, dist = _random_matches(rng, B, bl, block_len)
    jn, jt = jlz.parse_batch(jnp.asarray(length), jnp.asarray(dist),
                             jnp.asarray(block_len), bl, True, 259)
    tn, tt = tlz.parse_batch(torch.from_numpy(length).long(),
                             torch.from_numpy(dist).long(),
                             torch.from_numpy(block_len), bl, True, 259)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tlz.orbit_batch(tn, B, bl).numpy(),
                                  np.asarray(jlz.orbit_batch(jn, B, bl)))


@pytest.mark.cuda
def test_match_walk_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(5)
    B, bl = 16, 1 << 16
    block_len = np.full(B, bl, np.int32)
    block_len[-1] = 12345
    length, _ = _random_matches(rng, B, bl, block_len)
    take = torch.from_numpy(length >= 4).cuda()
    lt = torch.from_numpy(length).long().cuda()
    blt = torch.from_numpy(block_len).cuda()
    cn, ln = tlz.walk_inputs(lt, take, blt, bl)
    n0 = tlz.match_walk.launches
    got = tlz.match_walk(cn, ln, blt, bl)
    torch.cuda.synchronize()
    assert tlz.match_walk.launches == n0 + 1
    assert torch.equal(got, tlz.match_walk_ref(cn, ln, blt, bl))
