"""Parity of the port's v5 expansion engine (jdeflate_tpu_torch.ops.expand5)
with the JAX package's ops/expand5.py on the CPU.

The JAX side runs its real Pallas seed and resolve kernels under
pltpu.force_tpu_interpret_mode(); the port runs its plain pipeline (what its
wrappers take for a CPU tensor). The geometries are those of
tests/test_expand5.py, plus two that overflow the reference's error limits:
a region whose candidate slots overflow the seed kernel's window, and more
than SPILL_K spilling lanes. Every case has the same lane count and out_cap,
so the interpret-mode kernels compile once. Tolerance: exact equality of
bytes, produced and err (bytes only where err == 0: the port's kernels have
no window, so the bytes an erring batch discards may differ). The CUDA
kernels' own checks against the plain versions need a card (marker
`cuda`)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from jdeflate_tpu.ops import expand5 as jex5
from jdeflate_tpu_torch.ops import expand5 as tex5

TOK_LIT = 1 << 30
TOK_MATCH = 2 << 30
L = 8192                  # lanes of every case
CAP = 1 << 14             # out_cap of every case
PHASE_DISTS = (1, 2, 3, 5, 7, 31, 63, 64, 127, 128, 129, 251, 255, 256, 257)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tensors here are small; torch's default thread pool only spins
    against the other test workers' JAX compiles."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mk_lit(sym):
    return TOK_LIT | sym


def mk_match(length, dist):
    return TOK_MATCH | length | ((dist - 1) << 9)


def referee(tok, halo):
    """Byte-serial expansion of the lanes' tokens."""
    out = bytearray()
    for lane in tok:
        for t in lane:
            k = (int(t) >> 30) & 3
            if k == 0:
                break
            if k == 1:
                out.append(int(t) & 0xFF)
            else:
                d = ((int(t) >> 9) & 0x7FFF) + 1
                for _ in range(int(t) & 0x1FF):
                    p = len(out) - d
                    out.append(out[p] if p >= 0 else int(halo[p]))
    return bytes(out)


def _random_soup():
    rng = np.random.default_rng(7)
    lanes = [[mk_lit(int(rng.integers(256))) for _ in range(8)]]
    total = 8
    while total < CAP - 1200:
        lane = []
        for _ in range(int(rng.integers(1, 5))):
            if rng.random() < 0.5:
                lane.append(mk_lit(int(rng.integers(256))))
                total += 1
            else:
                ln = int(rng.integers(3, 259))
                d = int(rng.integers(1, min(total, 32768) + 1))
                lane.append(mk_match(ln, d))
                total += ln
        lanes.append(lane)
    return lanes


def _case(name):
    """(lanes of tokens, halo) of one geometry."""
    halo = np.zeros(tex5.HALO, np.uint8)
    if name == "rle_dist1":
        return [[mk_lit(7), mk_match(258, 1), mk_match(100, 1)]], halo
    if name == "overlap_2_3":
        return [[mk_lit(1), mk_lit(2), mk_match(9, 2), mk_match(10, 3)]], halo
    if name == "copy_of_copy":
        lanes = [[mk_lit((3 * i) & 0xFF) for i in range(16)]]
        return lanes + [[mk_match(16, 16)] for _ in range(12)], halo
    if name == "halo_edge":
        halo = (np.arange(tex5.HALO) % 251).astype(np.uint8)
        return [[mk_match(50, 32768), mk_match(20, 32000), mk_lit(9)]], halo
    if name == "sparse_lanes":
        return [[mk_lit(5)], [], [mk_match(30, 1)], [], [],
                [mk_lit(1), mk_lit(2), mk_match(200, 2)]], halo
    if name == "steps_crossed":
        # 258-byte matches crossing the 2 KiB resolve steps, chained
        lanes = [[mk_lit((i * 7) & 0xFF) for i in range(32)]]
        return lanes + [[mk_match(258, 31), mk_match(258, 257)]
                        for _ in range(30)], halo
    if name == "phase_mod":
        lanes = [[mk_lit((32 * j + i) & 0xFF) for i in range(32)]
                 for j in range(9)]
        return lanes + [[mk_match(258, d)] for d in PHASE_DISTS], halo
    if name == "random_soup":
        return _random_soup(), halo
    if name == "seed_window_overflow":
        # one literal per lane: 8 fast-slice slots per output byte, so a
        # 4 KiB region's slots span four CANDW blocks
        return [[mk_lit(i & 0xFF)] for i in range(L)], halo
    if name == "spill_overflow":
        # 200 lanes of 10 literals: more than SPILL_K lanes spill
        return [[mk_lit((i + c) & 0xFF) for c in range(10)]
                for i in range(200)], halo
    raise ValueError(name)


def _laneoff(outlen):
    """(L,) i64 exclusive scan of the lanes' output bytes."""
    return torch.from_numpy(np.cumsum(outlen, dtype=np.int64) - outlen)


def _pack(lanes):
    tok = np.zeros((L, 32), np.uint32)
    outlen = np.zeros(L, np.int32)
    for i, ln in enumerate(lanes):
        tok[i, :len(ln)] = ln
        outlen[i] = sum(1 if (t >> 30) == 1 else t & 0x1FF for t in ln)
    return tok, outlen


# one jitted program: the reference pipeline runs eager XLA ops between its
# two kernels, and an eager op dispatched while an interpret-mode kernel's
# callbacks still run can deadlock the CPU client
_jexpand5 = jax.jit(jex5.expand_tokens, static_argnames=("out_cap",))


def _jax_expand5(tok, outlen, halo):
    with pltpu.force_tpu_interpret_mode():
        out, prod, err = _jexpand5(
            jnp.asarray(tok), jnp.asarray(outlen), jnp.asarray(halo), CAP)
        return np.asarray(out), int(prod), int(err)


CASES = {"rle_dist1": 0, "overlap_2_3": 0, "copy_of_copy": 0,
         "halo_edge": 0, "sparse_lanes": 0, "steps_crossed": 0,
         "phase_mod": 0, "random_soup": 0, "seed_window_overflow": 2,
         "spill_overflow": 200}


@pytest.mark.parametrize("name", list(CASES))
def test_pipeline_matches_jax_kernels(name):
    lanes, halo = _case(name)
    tok, outlen = _pack(lanes)
    ref = referee(tok, halo)
    assert len(ref) <= CAP
    jout, jprod, jerr = _jax_expand5(tok, outlen, halo)
    out, prod, err = tex5.expand_tokens(
        torch.from_numpy(tok.view(np.int32)), torch.from_numpy(outlen),
        torch.from_numpy(halo), CAP, _laneoff(outlen))
    assert int(prod) == jprod == len(ref)
    assert int(err) == jerr == CASES[name]
    if jerr == 0:
        np.testing.assert_array_equal(out.numpy(), jout)
        assert bytes(out.numpy()[:len(ref)]) == ref
    # the full-slot plain pipeline ignores the reference's limits: its
    # bytes are right in every case
    rout, rprod = tex5.expand_tokens_ref(
        torch.from_numpy(tok.view(np.int32)), torch.from_numpy(outlen),
        torch.from_numpy(halo), CAP)
    assert int(rprod) == len(ref)
    assert bytes(rout.numpy()[:len(ref)]) == ref


def test_seed_window_err_matches_jax():
    """seed_window_err against the reference's count, on the overflow case
    and on a soup, and the plain seed placement against the reference's
    scatter."""
    for name in ("seed_window_overflow", "random_soup", "spill_overflow"):
        lanes, _ = _case(name)
        tok, outlen = _pack(lanes)
        joff, jseed = jex5.slot_attrs16(jnp.asarray(tok), jnp.asarray(outlen))
        off, seed = tex5.slot_attrs16(torch.from_numpy(tok.view(np.int32)),
                                      torch.from_numpy(outlen))
        np.testing.assert_array_equal(off.numpy(), np.asarray(joff))
        np.testing.assert_array_equal(seed.numpy(), np.asarray(jseed))
        with pltpu.force_tpu_interpret_mode():
            _, jerr = jex5.seed_scatter_mm(joff, jseed, CAP)
        assert int(tex5.seed_window_err(off, seed, CAP)) == int(jerr)
        # the seed plane's plain entry gives the same slot arrays
        S16, off2, seed2 = tex5.seed_plane(
            torch.from_numpy(tok.view(np.int32)), _laneoff(outlen), CAP)
        assert torch.equal(off2, off) and torch.equal(seed2, seed)
        want = np.zeros(CAP + 1, np.int64)
        np.maximum.at(want, np.where((seed.numpy() != 0)
                                     & (off.numpy() < CAP),
                                     off.numpy(), CAP), seed.numpy())
        np.testing.assert_array_equal(S16.numpy(), want[:CAP])


def test_phase_mod_exactness():
    """plan_fields' integer remainder equals the reference's f32
    floor-divide and corrections for every phase 0..511 at the distances of
    the reference's phase test, and at the largest ones."""
    dists = np.asarray(PHASE_DISTS + (511, 512, 4095, 32767, 32768))
    phase = np.arange(512)
    d, ph = np.meshgrid(dists, phase, indexing="ij")
    P = ((1 << 25) | (d - 1) | (ph << 15)).reshape(-1).astype(np.int32)
    n = P.shape[0]
    want = jex5.plan_fields(jnp.asarray(P), n)
    got = tex5.plan_fields(torch.from_numpy(P), n)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_spill_pass_and_plan_seeds_match_jax():
    """The 16-bit fast slice plus the spill pass place the same plan seeds
    as slot_attrs over every slot, on lanes that spill, with d = 32768
    matches; and each stage equals the reference's."""
    rng = np.random.default_rng(3)
    n_l, cap = 64, 1 << 13
    tok = np.zeros((n_l, 32), np.uint32)
    outlen = np.zeros(n_l, np.int32)
    total = 0
    for i in range(n_l):
        s = 0
        for c in range(int(rng.integers(1, 14))):
            if total + s < 4 or rng.random() < 0.7:
                tok[i, c] = mk_lit(int(rng.integers(0, 256)))
                s += 1
            else:
                d = int(rng.integers(1, min(total + s, 32768) + 1))
                if rng.random() < 0.05:
                    d = min(32768, total + s)
                ln = int(rng.integers(3, 40))
                tok[i, c] = mk_match(ln, d)
                s += ln
        outlen[i] = s
        total += s
    tt, to = torch.from_numpy(tok.view(np.int32)), torch.from_numpy(outlen)
    tj, oj = jnp.asarray(tok), jnp.asarray(outlen)
    off_all, seed_all = tex5.slot_attrs(tt, to)
    joff_all, jseed_all = jex5.slot_attrs(tj, oj)
    np.testing.assert_array_equal(off_all.numpy(), np.asarray(joff_all))
    np.testing.assert_array_equal(seed_all.numpy(), np.asarray(jseed_all))
    S_all = tex5.seed_scatter_ref(off_all, seed_all, cap)
    np.testing.assert_array_equal(
        S_all.numpy(), np.asarray(jex5.seed_scatter_ref(joff_all, jseed_all,
                                                        cap)))
    off, seed = tex5.slot_attrs16(tt, to)
    S16, off2, seed2 = tex5.seed_plane(tt, _laneoff(outlen), cap)
    assert torch.equal(off2, off) and torch.equal(seed2, seed)
    assert torch.equal(S16, tex5.seed_scatter_ref(off, seed, cap))
    assert int(tex5.seed_window_err(off, seed, cap)) == 0
    S16f, err = tex5.spill_pass(tt, _laneoff(outlen), S16, cap)
    jS16f, jerr = jex5.spill_pass(tj, oj, jnp.asarray(S16.numpy()), cap)
    np.testing.assert_array_equal(S16f.numpy(), np.asarray(jS16f))
    assert int(err) == int(jerr) == 0
    plan = tex5.seed16_to_plan(S16f)
    np.testing.assert_array_equal(plan.numpy(), S_all.numpy())
    np.testing.assert_array_equal(
        tex5.propagate(plan).numpy(),
        np.asarray(jex5.propagate(jnp.asarray(plan.numpy()))))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["random_soup", "halo_edge",
                                  "seed_window_overflow"])
def test_kernels_match_plain_on_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    lanes, halo = _case(name)
    tok, outlen = _pack(lanes)
    tt = torch.from_numpy(tok.view(np.int32)).cuda()
    lo = _laneoff(outlen).cuda()
    S16, off, seed = tex5.seed_plane(tt, lo, CAP)
    for g, w in zip((S16, off, seed), tex5.seed_plane_ref(tt, lo, CAP)):
        assert torch.equal(g, w)
    P = tex5.propagate(tex5.seed16_to_plan(S16)).contiguous()
    hc = torch.from_numpy(halo).cuda()
    out, err = tex5.resolve(P, hc, CAP)
    torch.cuda.synchronize()
    assert int(err) == 0
    assert torch.equal(out, tex5.resolve_ref(P, hc, CAP))
