"""Edge cases of the port's token expansion (ops/expand2.py) and LZ77 match
walk (ops/lz77.py), from the seeded generators chip_smoke.adversarial_tokens
and chip_smoke.adversarial_walks: runs of d = 1 matches, d = 32768 reaching
the first halo byte, overlapping copies with d in 1..8, chains of matches
across many tile seams, literal-only lanes and lanes that end early, an
out_cap equal to and below the bytes produced; block lengths 0, 1, bl - 1
and bl, no candidates, length-3 matches everywhere, a match ending exactly
at block_len.

On the CPU the plain versions are held to the JAX package: expand_tokens_ref
to codec/inflate.py::_assemble_output, match_walk_ref and token_marks_batch
to the JAX token_marks_batch and to the sequential parse loop. The tests
marked `cuda` hold the CUDA kernels to the plain versions on the same
inputs. Tolerance: exact equality of bytes, produced counts, err flags and
match lists."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from jdeflate_tpu.codec import inflate as jinf
from jdeflate_tpu.ops import lz77 as jlz
from jdeflate_tpu_torch.ops import expand2 as tex
from jdeflate_tpu_torch.ops import lz77 as tlz
from jdeflate_tpu_torch.ops import walk as twalk

TOKENS = chip_smoke.adversarial_tokens(seed=3)
WALKS = chip_smoke.adversarial_walks(seed=3)
TOKEN_NAMES = [c[0] for c in TOKENS]
WALK_NAMES = [c[0] for c in WALKS]

_jassemble = jax.jit(jinf._assemble_output, static_argnames=("out_cap",))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tensors here are small; torch's default thread pool only spins
    against the other test workers' JAX compiles."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(cases, name):
    return next(c[1:] for c in cases if c[0] == name)


def _tensors(name):
    tok, outlen, halo, oc = _case(TOKENS, name)
    return (torch.from_numpy(tok), torch.from_numpy(outlen),
            torch.from_numpy(halo), oc)


def _jax_slots(tok):
    t = tok.view(np.uint32)
    kind = t >> 30
    o_len = np.where(kind == 1, 1, np.where(kind == 2, t & 0x1FF, 0))
    o_dist = np.where(kind == 2, ((t >> 9) & 0x7FFF) + 1, 0)
    o_lit = np.where(kind == 1, t & 0xFF, 0)
    return [jnp.asarray(x.reshape(-1).astype(np.int32))
            for x in (o_len, o_lit, o_dist)]


@functools.lru_cache(maxsize=None)
def _walk_inputs(name):
    length, take, block_len = _case(WALKS, name)
    bl = length.shape[1]
    lt, tk = torch.from_numpy(length).long(), torch.from_numpy(take)
    blt = torch.from_numpy(block_len)
    cn, ln = tlz.walk_inputs(lt, tk, blt, bl)
    return lt, tk, blt, cn, ln, bl


def _plist_loop(take, length, block_len, bl):
    """The plist contract by its definition: the sequential cursor from 0."""
    out = np.zeros((take.shape[0], tlz.WALK_CAP), np.int64)
    for b in range(take.shape[0]):
        p, k = 0, 1
        while p < block_len[b]:
            if take[b, p]:
                out[b, k] = p | (max(int(length[b, p]), 1) << 17)
                k += 1
                p += max(int(length[b, p]), 1)
            else:
                p += 1
        out[b, 0] = k
    return out


def test_generators_cover_the_edges():
    """The cases the kernels are held on really have their edges."""
    names = set(TOKEN_NAMES)
    assert {"d1_runs", "d32768_halo", "overlap_d1_8", "chains_near",
            "chains_far", "all_literal", "lanes_end_early", "cap_exact",
            "cap_short"} <= names
    for name, tok, outlen, _, oc in TOKENS:
        t = tok.view(np.uint32)
        produced = int(outlen.sum())
        assert produced > 4 * tex.TILE or name == "all_literal", name
        if name == "cap_exact":
            assert oc == produced
        elif name == "cap_short":
            assert oc < produced
        if name == "all_literal":
            assert ((t >> 30) == 1).all()
        if name == "lanes_end_early":
            n = ((t >> 30) != 0).sum(1)
            assert (n == 0).any() and ((n > 0) & (n < 32)).any()
    d = _case(TOKENS, "overlap_d1_8")[0].view(np.uint32)
    m = (d >> 30) == 2
    dist = ((d >> 9) & 0x7FFF) + 1
    assert set(dist[m].tolist()) == set(range(1, 9))
    assert ((d & 0x1FF) > dist)[m].all()
    first = _case(TOKENS, "d32768_halo")[0].view(np.uint32)[0, 0]
    assert first >> 30 == 2 and ((first >> 9) & 0x7FFF) + 1 == 32768
    edges = _case(WALKS, "block_len_edges")[2]
    bl = _case(WALKS, "block_len_edges")[0].shape[1]
    assert edges.tolist() == [0, 1, bl - 1, bl]
    assert not _case(WALKS, "no_candidates")[1].any()


@pytest.mark.parametrize("name", TOKEN_NAMES)
def test_expand_ref_matches_jax_assemble(name):
    """expand_tokens_ref (and the wrapper on a CPU tensor) equals the JAX
    _assemble_output: bytes, produced and err; annotated literal runs give
    the same bytes."""
    tok, outlen, halo, oc = _tensors(name)
    jout, jprod, jerr = _jassemble(*_jax_slots(tok.numpy()),
                                   jnp.asarray(halo.numpy()), out_cap=oc)
    for t in (tok, twalk.annotate_lit_runs(tok)):
        out, prod, err = tex.expand_tokens_ref(t, outlen, halo, oc)
        assert int(prod) == int(jprod) == int(outlen.sum())
        assert int(err) == int(jerr)
        np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    assert (int(jerr) > 0) == (name == "cap_short")
    out, prod, err = tex.expand_tokens(tok, outlen, halo, oc)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))


@pytest.mark.parametrize("name", WALK_NAMES)
def test_match_walk_ref_matches_jax_and_loop(name):
    """match_walk_ref equals the sequential parse loop, and the port's
    token_marks_batch equals the JAX one."""
    lt, tk, blt, cn, ln, bl = _walk_inputs(name)
    length, take, block_len = _case(WALKS, name)
    plist = tlz.match_walk_ref(cn, ln, blt, bl)
    np.testing.assert_array_equal(plist.numpy(),
                                  _plist_loop(take, length, block_len, bl))
    if name == "len3_everywhere":
        assert int(plist[:, 0].max()) - 1 > 0.95 * (bl // 3)
    want = jlz.token_marks_batch(jnp.asarray(length), jnp.asarray(take),
                                 jnp.asarray(block_len), bl)
    got = tlz.token_marks_batch(lt, tk, blt, bl)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("name", TOKEN_NAMES)
def test_expand_kernel_matches_plain_on_card(name):
    _need_card()
    tok, outlen, halo, oc = (x.cuda() if torch.is_tensor(x) else x
                             for x in _tensors(name))
    n0 = tex.expand_tokens.launches
    outs = [tex.expand_tokens(tok, outlen, halo, oc) for _ in range(3)]
    torch.cuda.synchronize()
    assert tex.expand_tokens.launches == n0 + 3
    rout, rprod, rerr = tex.expand_tokens_ref(tok, outlen, halo, oc)
    k = min(int(rprod), oc)
    for out, prod, err in outs:
        assert int(prod) == int(rprod)
        assert bool(err) == bool(rerr) == (name == "cap_short")
        assert torch.equal(out[:k], rout[:k])


@pytest.mark.cuda
@pytest.mark.parametrize("name", WALK_NAMES)
def test_match_walk_kernel_matches_plain_on_card_edges(name):
    _need_card()
    _, _, blt, cn, ln, bl = _walk_inputs(name)
    cn, ln, blt = cn.cuda(), ln.cuda(), blt.to(torch.int32).cuda()
    n0 = tlz.match_walk.launches
    got = tlz.match_walk(cn, ln, blt, bl)
    torch.cuda.synchronize()
    assert tlz.match_walk.launches == n0 + 1
    assert torch.equal(got, tlz.match_walk_ref(cn, ln, blt, bl))
