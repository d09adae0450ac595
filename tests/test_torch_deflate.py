"""Parity of the port's encoder (jdeflate_tpu_torch.codec.deflate) with the
JAX package on the CPU, stage by stage: every `stage=` tap of encode_batch
at level 6 on two 16 KiB blocks (so the split DP runs). Plus the capture
hook and the device rule of RawDeflater. Whole streams are in
test_torch_deflate_streams.py. Tolerance: exact equality everywhere (the
float32 split DP included: no case here flips a split)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jdeflate_tpu.codec import deflate as JD
from jdeflate_tpu.codec import levels as jlevels
from jdeflate_tpu_torch.codec import deflate as TD
from jdeflate_tpu_torch.codec import levels as tlevels

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


# ---- encode_batch, stage by stage ----

STAGES = ["match", "walk", "freqs", "split", "entropy", "codes", "items",
          "stored", "pack", "offsets", ""]


@pytest.fixture(scope="module")
def stage_input():
    """Two 16 KiB blocks at level 6 (two 8 KiB split chunks each), the
    second one short and final."""
    rng = np.random.default_rng(21)
    words = [b"entropy ", b"window ", b"match ", b"block ", b"stream\n"]
    text = b"".join(words[i] for i in rng.integers(0, 5, 2000))[:9000]
    rec = rng.integers(0, 256, 48, dtype=np.uint8)
    recs = np.tile(rec, 200)
    recs[rng.integers(0, recs.size, 300)] = rng.integers(0, 256, 300)
    data = (text + recs.tobytes()[:8000]
            + rng.integers(0, 256, 3000, dtype=np.uint8).tobytes()
            + bytes(4000) + text[:3000])
    bl, batch, level = 16384, 2, 6
    buf = np.zeros(JD.HALO + bl * batch + JD.PAD, np.uint8)
    buf[JD.HALO:JD.HALO + len(data)] = np.frombuffer(data, np.uint8)
    nw = JD.words_bound(bl, batch, jlevels.get_level(level).chunk)
    return buf, len(data), (bl, batch, level, nw)


@pytest.mark.parametrize("stage", STAGES)
def test_encode_batch_stage_matches_jax(stage_input, stage):
    buf, n, (bl, batch, level, nw) = stage_input
    want = JD.encode_batch_impl(jnp.asarray(buf), jnp.int32(0), jnp.int32(n),
                                jnp.int32(0), jnp.int32(1), bl, batch, level,
                                nw, stage=stage)
    got = TD.encode_batch(torch.from_numpy(buf), 0, n, 0, 1, bl, batch, level,
                          nw, stage=stage)
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(
            g.numpy().astype(np.int64), np.asarray(w).astype(np.int64),
            err_msg=f"{stage or 'full'} output {k}")
    if stage == "split":
        assert got[0].shape == (batch, 2)


def test_capture_calls_replays_a_batch(corpus):
    data = corpus("text", 3 * 4096)
    tenc = TD.RawDeflater(level=6, block_size=4096, batch=2, device="cpu")
    tenc.capture_calls = True
    raw, _ = tenc.compress(data)
    assert len(tenc.last_calls) == 2
    out = TD.encode_batch(*tenc.last_calls[0], *tenc.call_statics)
    total = int(out[1])
    words = out[0][:(total + 7) // 8 // 4 + 1].numpy().astype("<u4")
    assert words.view(np.uint8)[:total // 8].tobytes() == raw[:total // 8]


def test_deflater_needs_a_device_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import jdeflate_tpu_torch as jdt
    from jdeflate_tpu_torch.utils import errors
    with pytest.raises(errors.IncorrectUseError):
        TD.RawDeflater(level=6)
    with pytest.raises(errors.IncorrectUseError):
        jdt.compress(b"abc")
    with pytest.raises(errors.IncorrectUseError):
        jdt.compress_with_index(b"abc")
    with pytest.raises(ValueError):
        TD.RawDeflater(level=6, block_size=1001, device="cpu")
