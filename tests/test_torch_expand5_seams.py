"""Edge cases of the port's v5 resolve (ops/expand5.py::resolve, kernel B5
csrc/expand5resolve.cu) across the ordered-tile resolve's 16 KiB tile
seams, from the seeded generator chip_smoke.adversarial_plans: plans of
128 KiB (eight tiles) with chains of matches across the seams, runs of
d = 1 and d = 3 over many tiles, d = 32768 sources into the halo, an
invalid tail past the bytes produced, and exactly the capacity produced.

On the CPU the port's plain resolve is held to the JAX resolve_tpu running
its Pallas kernel under pltpu.force_tpu_interpret_mode() (one jitted
program; every plan has one shape, so it compiles once), err included, and
the bytes produced to a byte-serial expansion of the plan's tokens. The
tests marked `cuda` hold the kernel to the plain version on the same
plans. Tolerance: exact equality of every byte and of err."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import chip_smoke
from jdeflate_tpu.ops import expand5 as jex5
from jdeflate_tpu_torch.ops import _cuda
from jdeflate_tpu_torch.ops import expand5 as tex5

CAP = 1 << 17
NAMES = ["chains_tile_seams", "d1_d3_runs", "d32768_halo", "invalid_tail",
         "exact_cap"]

_jresolve = jax.jit(jex5.resolve_tpu, static_argnames=("out_cap",))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tensors here are small; torch's default thread pool only spins
    against the other test workers' JAX compiles."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _plans():
    """The generator's cases by name (built on first use, not while the
    test module is imported)."""
    return {c[0]: c[1:] for c in chip_smoke.adversarial_plans(seed=3,
                                                              cap=CAP)}


def _serial(tok, halo):
    """Byte-serial expansion of the lanes' tokens behind the halo."""
    out = bytearray()
    for t in tok.view(np.uint32).reshape(-1).tolist():
        if t >> 30 == 1:
            out.append(t & 0xFF)
        elif t >> 30 == 2:
            d = ((t >> 9) & 0x7FFF) + 1
            for _ in range(t & 0x1FF):
                p = len(out) - d
                out.append(out[p] if p >= 0 else int(halo[p]))
    return bytes(out)


def test_plan_generator_covers_the_edges():
    plans = _plans()
    assert list(plans) == NAMES
    for name, (tok, outlen, P, _) in plans.items():
        assert P.shape == (CAP,)
        t = tok.view(np.uint32)
        m = (t >> 30) == 2
        d = ((t >> 9) & 0x7FFF) + 1
        produced = int(outlen.sum())
        assert produced == CAP if name == "exact_cap" else produced < CAP
        valid = (P & tex5.V_VALID) != 0
        if name == "invalid_tail":
            assert produced < CAP // 2 and not valid[produced + 512:].any()
        if name == "d1_d3_runs":
            for dist in (1, 3):
                assert (m & (d == dist)).sum() * 258 > 3 * _cuda.TILE
        if name == "d32768_halo":
            assert (m & (d == 32768)).sum() >= 100
        if name == "chains_tile_seams":
            assert produced > 6 * _cuda.TILE and (m & (d > 8192)).sum() > 100


@pytest.mark.parametrize("name", NAMES)
def test_resolve_matches_jax_kernel_across_seams(name):
    """The port's resolve (resolve_ref on the CPU) against the reference's
    resolve_tpu in interpret mode, err included; the bytes produced equal
    the byte-serial expansion."""
    tok, outlen, P, halo = _plans()[name]
    with pltpu.force_tpu_interpret_mode():
        jo, je = _jresolve(jnp.asarray(P.reshape(-1, 128)),
                           jnp.asarray(halo), out_cap=CAP)
        jo, je = np.asarray(jo), int(je)
    out, err = tex5.resolve(torch.from_numpy(P), torch.from_numpy(halo), CAP)
    assert int(err) == je == 0
    np.testing.assert_array_equal(out.numpy(), jo)
    produced = int(outlen.sum())
    assert bytes(out.numpy()[:produced]) == _serial(tok, halo)


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
def test_resolve_kernel_matches_plain_on_card_across_seams(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, _, P, halo = _plans()[name]
    Pc, hc = torch.from_numpy(P).cuda(), torch.from_numpy(halo).cuda()
    n0 = tex5.resolve.launches
    out, err = tex5.resolve(Pc, hc, CAP)
    torch.cuda.synchronize()
    assert tex5.resolve.launches == n0 + 1 and int(err) == 0
    assert torch.equal(out, tex5.resolve_ref(Pc, hc, CAP))
    # P is only read
    assert torch.equal(Pc.cpu(), torch.from_numpy(P))
