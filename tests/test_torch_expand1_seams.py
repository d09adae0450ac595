"""Edge cases of the port's v1 match expansion (ops/expand.py, kernel B6
csrc/expand1.cu) across the ordered-tile resolve's 16 KiB tile seams and
the anchored decode's 64 KiB block seams, from the seeded generators
chip_smoke.adversarial_slots and chip_smoke.adversarial_match_lists.

On the CPU the port's plain path is held to the JAX package:
codec/inflate.py::_assemble_kernel against the JAX _assemble_pallas running
its Pallas kernel under pltpu.force_tpu_interpret_mode() (every case has
one shape, so the kernel compiles once), and expand_matches_ref against the
contract by its definition, every block's matches copied in order (the
list edges: matches outside every range, empty and overlapping ranges,
d <= 0, len <= 0, off outside the buffer, a match running past its end,
sources before byte 0). The tests marked `cuda` hold the kernel to the
plain version on the same inputs. Tolerance: exact equality of bytes,
produced and err."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import chip_smoke
from jdeflate_tpu.codec import inflate as jinf
from jdeflate_tpu_torch.codec import inflate as tinf
from jdeflate_tpu_torch.ops import _cuda
from jdeflate_tpu_torch.ops import expand as tex

HALO = 32768
TILE = _cuda.TILE
SLOTS = chip_smoke.adversarial_slots(seed=3)
LISTS = chip_smoke.adversarial_match_lists(seed=3)
SLOT_NAMES = [c[0] for c in SLOTS]
LIST_NAMES = [c[0] for c in LISTS]

_jassemble = jax.jit(jinf._assemble_pallas,
                     static_argnames=("out_cap", "nblocks"))


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


def _matches(o_len, o_dist):
    """(output offset, d, len) of every match slot, in slot order."""
    off = np.cumsum(o_len) - o_len
    m = o_dist > 0
    return off[m], o_dist[m], o_len[m]


def _copy_in_order(buf, m_off, m_d, m_len, ranges):
    """The contract by its definition: for each block in order, for each of
    its matches in order, byte i copies byte off - d + i % d when both lie
    in [0, n); d <= 0 or len <= 0 copies nothing."""
    out = bytearray(buf.tobytes())
    n, T = len(out), len(m_off)
    off, d, ln = m_off.tolist(), m_d.tolist(), m_len.tolist()
    for t0, t1, _, _ in ranges.tolist():
        t0 = min(max(t0, 0), T)
        for t in range(t0, min(max(t1, t0), T)):
            if d[t] <= 0:
                continue
            for i in range(max(ln[t], 0)):
                dst, src = off[t] + i, off[t] - d[t] + i % d[t]
                if 0 <= dst < n and 0 <= src < n:
                    out[dst] = out[src]
    return np.frombuffer(bytes(out), np.uint8)


def test_slot_generator_covers_the_edges():
    """One shape for every case; blocks of at most 64 KiB with an empty
    block; and each case really has its edge."""
    shapes = {(c[1].shape, c[5], c[6].shape) for c in SLOTS}
    assert len(shapes) == 1
    for name, o_len, _, o_dist, _, cap, first in SLOTS:
        outs = [int(o_len[a:b].sum()) for a, b in zip(first[:-1], first[1:])]
        assert max(outs) <= 1 << 16 and outs[1] == 0 and first[1] == first[2]
        assert int(o_len.sum()) <= cap
        off, d, ln = _matches(o_len, o_dist)
        if name != "ranges_edges":
            assert int(o_len.sum()) > 6 * TILE, name
        if name == "chains_tile_seams":
            assert ((off - d) // TILE < off // TILE).sum() > 100
        if name == "d1_d3_runs":
            for dist in (1, 3):
                run = off[(d == dist) & (ln == 258)]
                assert run.max() - run.min() > 2 * TILE, dist
        if name == "d32768_halo":
            assert ((d == 32768) & (off < HALO)).sum() > 100
        if name == "block_seams_258":
            for mark in range(1 << 16, int(o_len.sum()), 1 << 16):
                assert ((ln == 258) & (off < mark) & (off + 258 > mark)).any()
            slot_off = np.cumsum(o_len) - o_len
            for b in (2, 3):
                nz = np.flatnonzero(o_len[first[b]:first[b + 1]]) + first[b]
                prev = np.flatnonzero(o_len[:first[b]])[-1]
                assert o_len[prev] == 258 and o_dist[prev] > 0
                head = nz[0]
                assert o_len[head] == 258 and (slot_off[head] - o_dist[head]
                                               < slot_off[prev] + 258)
        if name == "ranges_edges":
            assert first[0] > 0 and (o_dist[:first[0]] > 0).any()
            blk = slice(first[0], first[1])
            assert (o_len[blk] > 0).sum() > 1000 and not (o_dist[blk]
                                                          > 0).any()


def test_match_list_generator_covers_the_edges():
    for name, buf, m_off, m_d, m_len, ranges in LISTS:
        n = buf.shape[0]
        assert n % 4 != 0
        T = m_off.shape[0]
        if name == "outside_and_empty_ranges":
            covered = np.zeros(T, bool)
            for t0, t1, _, _ in ranges:
                covered[max(t0, 0):max(min(t1, T), 0)] = True
            assert (~covered).sum() > 10
            assert (ranges[:, 0] == ranges[:, 1]).any()
            assert (ranges[:, 1] > T).any()
        if name == "overlapping_ranges":
            assert ranges[1, 0] < ranges[0, 1]
        if name == "bad_fields":
            assert (m_d <= 0).any() and (m_len <= 0).any()
            assert (m_off < 0).any() and (m_off >= n).any()
            assert ((m_off < n) & (m_off + m_len > n) & (m_d > 0)).any()
            assert (m_d > HALO + 511).any()
        if name == "source_before_zero":
            assert ((m_d > m_off) & (m_off >= 0)).sum() > 5


@pytest.mark.parametrize("name", SLOT_NAMES)
def test_assemble_kernel_matches_pallas_across_seams(name):
    """_assemble_kernel (its plain expansion on the CPU) against the
    reference's _assemble_pallas running its Pallas kernel in interpret
    mode: bytes, produced and err."""
    o_len, o_lit, o_dist, halo, cap, first = _case(SLOTS, name)
    nb = first.shape[0] - 1
    with pltpu.force_tpu_interpret_mode():
        jo, jp, je = _jassemble(jnp.asarray(o_len), jnp.asarray(o_lit),
                                jnp.asarray(o_dist), jnp.asarray(halo),
                                out_cap=cap, first_slots=jnp.asarray(first),
                                nblocks=nb)
        jo = np.asarray(jo)
    to, tp, te = tinf._assemble_kernel(
        *(torch.from_numpy(x) for x in (o_len, o_lit, o_dist, halo)), cap,
        torch.from_numpy(first), nb)
    assert int(tp) == int(jp) == int(o_len.sum())
    assert int(te) == int(je) == 0
    np.testing.assert_array_equal(to.numpy(), jo)


@pytest.mark.parametrize("name", LIST_NAMES)
def test_expand_matches_ref_is_the_in_order_copy(name):
    """expand_matches_ref, and the wrapper on a CPU tensor, give the bytes of
    the in-order copy on every list edge."""
    buf, m_off, m_d, m_len, ranges = _case(LISTS, name)
    want = _copy_in_order(buf, m_off, m_d, m_len, ranges)
    args = [torch.from_numpy(x) for x in (buf, m_off, m_d, m_len, ranges)]
    np.testing.assert_array_equal(tex.expand_matches_ref(*args).numpy(), want)
    np.testing.assert_array_equal(tex.expand_matches(*args).numpy(), want)
    assert (want != buf).sum() > 1000


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("name", SLOT_NAMES)
def test_expand1_kernel_matches_plain_on_card_across_seams(name):
    """The kernel path of _assemble_kernel on the card against the plain
    one; expanding the expanded buffer again changes nothing."""
    _need_card()
    o_len, o_lit, o_dist, halo, cap, first = _case(SLOTS, name)
    nb = first.shape[0] - 1
    args = [torch.from_numpy(x) for x in (o_len, o_lit, o_dist, halo)]
    n0 = tex.expand_matches.launches
    ko, kp, ke = tinf._assemble_kernel(*(a.cuda() for a in args), cap,
                                       torch.from_numpy(first).cuda(), nb)
    torch.cuda.synchronize()
    assert tex.expand_matches.launches == n0 + 1
    ro, rp, re_ = tinf._assemble_kernel(*args, cap, torch.from_numpy(first),
                                        nb)
    assert int(kp) == int(rp) and int(ke) == int(re_) == 0
    assert torch.equal(ko.cpu(), ro)
    # the expansion's inputs, as _assemble_kernel builds them
    buf, mats, _, _ = tinf._expand1_inputs(*(a.cuda() for a in args), cap,
                                           torch.from_numpy(first).cuda(),
                                           nb)
    done = tex.expand_matches(buf.clone(), *mats)
    assert torch.equal(tex.expand_matches(done.clone(), *mats), done)


@pytest.mark.cuda
@pytest.mark.parametrize("name", LIST_NAMES)
def test_expand1_kernel_matches_plain_on_card_list_edges(name):
    _need_card()
    args = [torch.from_numpy(x).cuda() for x in _case(LISTS, name)]
    got = tex.expand_matches(args[0].clone(), *args[1:])
    torch.cuda.synchronize()
    assert torch.equal(got, tex.expand_matches_ref(*args))
