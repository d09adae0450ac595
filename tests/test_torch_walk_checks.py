"""Parity of the window walk's checks and of the v5 seed plane with the JAX
package on the CPU.

ops/walk.py::walk_checked_ref (what walk_checked takes for a CPU tensor) is
the window walk followed by the checks the reference's windowed decode runs
right after it (jdeflate_tpu/codec/inflate.py::_decode_batch_windows_impl):
each lane's output bytes, their exclusive scan over the batch, and err =
lane errors + broken exit-chain links + matches reaching past the history.
The JAX side runs _decode_from_meta (use_pallas=False) eagerly with its
assembly stage replaced by a stub that keeps the token slot lengths and
adds no err, so the err it returns is the checks' alone. Cases: zlib
streams at levels 1, 6 and 9 (every batch), a tampered anchor, the segment
clamp of ROADMAP C5, matches reaching past the history (a preset
dictionary left out of the decode), and chip_smoke.adversarial_windows'
changes to one batch. ops/expand5.py::seed_plane_ref is held to
slot_attrs16 + seed_scatter_ref and to the JAX seed_scatter_mm in interpret
mode. The match lists the anchored decode builds satisfy the v1
expansion's precondition (ROADMAP C9). Inputs come from
tests/conftest.py::make_corpus with seeded numpy generators. Tolerance:
exact equality. The kernels' checks against their plain versions, the
decode without eager checks and the decode on a second card (ROADMAP C10)
need cards (marker `cuda`)."""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import chip_smoke
from conftest import make_corpus
from jdeflate_tpu.codec import inflate as jinf
from jdeflate_tpu.ops import expand5 as jex5
from jdeflate_tpu_torch.codec import inflate as tinf
from jdeflate_tpu_torch.ops import expand as tex
from jdeflate_tpu_torch.ops import expand5 as tex5
from jdeflate_tpu_torch.ops import walk as twalk

# small batches, so a 256 KiB stream spans several halo-chained batches
BATCH = dict(max_batch_bits=1 << 18, max_batch_blocks=8,
             max_batch_out=1 << 16)
ADVERSARIAL = ("hist_0", "hist_2p30", "tree_relabel", "empty_pe",
               "anchor_shift", "late_anchors", "negative_pe_word0",
               "segment_clamp")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tensors here are small; torch's default thread pool only spins
    against the other test workers' JAX compiles."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mixed(seed, n=1 << 18):
    rng = np.random.default_rng(seed)
    q = n // 4
    return b"".join(make_corpus(rng, k, m) for k, m in (
        ("text", q), ("binary", q), ("runs", q), ("random", q // 4),
        ("text", q - q // 4)))


def _zlib_raw(data, level, zdict=None):
    co = (zlib.compressobj(level, zlib.DEFLATED, -15, zdict=zdict) if zdict
          else zlib.compressobj(level, zlib.DEFLATED, -15))
    return co.compress(data) + co.flush()


def _batches(raw, index=None, dictionary=b"", dev="cpu", batch=BATCH):
    """The windowed batches of the port's decode of raw, as captured device
    arguments (words_full, metas, row, halo, npe, nb, out_cap, wwords)."""
    td = tinf.RawInflater(device=dev, **batch)
    td.capture_calls = True
    if index is None:
        index = td.build_index(raw, dictionary)
    td.decompress(raw, index=index, dictionary=dictionary)
    return td.last_calls


@pytest.fixture
def jax_checks(monkeypatch):
    """f(words_full, meta, halo, npe, ne, out_cap, wwords) -> (err, outlen,
    laneoff) of the reference's windowed decode with its assembly stubbed
    out: err is its walk checks' sum, outlen the sum of its token slot
    lengths per lane, laneoff their exclusive scan."""
    kept = {}

    def stub(o_len, o_lit, o_dist, halo, out_cap):
        kept["o_len"] = np.asarray(o_len)
        return (jnp.zeros(out_cap, jnp.uint8), jnp.sum(o_len),
                jnp.zeros((), jnp.int32))

    monkeypatch.setattr(jinf, "_assemble_output", stub)

    def run(words_full, meta, halo, npe, ne, out_cap, wwords):
        _, _, err, _ = jinf._decode_from_meta(
            jnp.asarray(words_full.numpy().view(np.uint32)),
            jnp.asarray(np.asarray(meta)), jnp.asarray(halo.numpy()), npe,
            ne, out_cap, wwords)
        outlen = kept["o_len"].reshape(npe * twalk.PE_LANES, -1).sum(1)
        return int(err), outlen, np.cumsum(outlen) - outlen

    return run


def _held(jax_checks, words_full, meta, halo, npe, ne, out_cap, wwords):
    """walk_checked (its plain version) against the reference's checks on
    one batch; returns the err."""
    args = tinf._walk_inputs(words_full, torch.as_tensor(meta), npe, ne,
                             wwords)
    tok, meta_w, outlen, laneoff, err = twalk.walk_checked(*args)
    jerr, joutlen, jlaneoff = jax_checks(words_full, meta, halo, npe, ne,
                                         out_cap, wwords)
    assert err.shape == (1,) and err.dtype == torch.int32
    assert laneoff.dtype == torch.int64
    assert int(err) == jerr
    np.testing.assert_array_equal(outlen.numpy(), joutlen)
    np.testing.assert_array_equal(laneoff.numpy(), jlaneoff)
    # the walk's own contract is unchanged: tokens and meta as before
    t, ol, cnt, e, pos, eob = twalk.walk_windows_ref(*args[:8])
    assert torch.equal(tok, t)
    assert torch.equal(meta_w, twalk.pack_meta(ol, cnt, e, pos, eob))
    assert torch.equal(outlen, ol)
    return jerr


@pytest.mark.parametrize("level", [1, 6, 9])
def test_walk_checks_match_jax(jax_checks, level):
    data = _mixed(level)
    calls = _batches(_zlib_raw(data, level))
    assert len(calls) >= 2
    for wf, metas, row, halo, npe, nb, oc, ww in calls:
        assert _held(jax_checks, wf, metas[row], halo, npe, nb, oc, ww) == 0


def test_walk_checks_tampered_anchor_match_jax(jax_checks):
    raw = _zlib_raw(_mixed(11), 6)
    index = tinf.RawInflater(device="cpu").build_index(raw)
    k = max(range(len(index["win"])),
            key=lambda i: -1 if index["win"][i] is None
            else len(index["win"][i]))
    win = [None if w is None else np.array(w) for w in index["win"]]
    valid = np.nonzero(win[k] >= 0)[0]
    win[k][valid[len(valid) // 2]] += 1
    errs = [_held(jax_checks, wf, metas[row], halo, npe, nb, oc, ww)
            for wf, metas, row, halo, npe, nb, oc, ww in
            _batches(raw, {**index, "win": win})]
    assert any(errs)


def test_walk_checks_segment_clamp_match_jax(jax_checks):
    """ROADMAP C5: the input of tests/test_torch_inflate.py::
    test_segment_clamp_matches_reference; its first batch errs on both
    sides."""
    rng = np.random.default_rng(1)
    words = [b"the ", b"quick ", b"brown ", b"fox ", b"jumps \n"]
    data = (b"".join(words[i] for i in rng.integers(0, 5, 60000))[:200000]
            + rng.integers(0, 256, 50000, dtype=np.uint8).tobytes()
            + bytes(30000))
    wf, metas, row, halo, npe, nb, oc, ww = _batches(_zlib_raw(data, 9),
                                                     batch={})[0]
    assert chip_smoke.clamps_segment((wf, metas, row, halo, npe, nb, oc, ww))
    assert _held(jax_checks, wf, metas[row], halo, npe, nb, oc, ww) > 0


def test_walk_checks_far_offsets_match_jax(jax_checks):
    """A stream compressed against a preset dictionary: its first matches
    reach into the dictionary, so with the dictionary's length taken out of
    hist only the far-offset check fires (err 0 with it)."""
    rng = np.random.default_rng(21)
    zdict = make_corpus(rng, "text", 16000)
    data = zdict[2000:12000] + make_corpus(rng, "binary", 40000)
    raw = _zlib_raw(data, 6, zdict)
    wf, metas, row, halo, npe, nb, oc, ww = _batches(raw,
                                                     dictionary=zdict)[0]
    meta = metas[row].numpy().copy()
    assert _held(jax_checks, wf, meta, halo, npe, nb, oc, ww) == 0
    meta[1] -= len(zdict)
    assert _held(jax_checks, wf, meta, halo, npe, nb, oc, ww) > 0


def _base_call(dev="cpu"):
    """The second windowed batch of a level-6 text stream (hist > 0, several
    pseudo-entries): the batch chip_smoke.adversarial_windows changes."""
    data = make_corpus(np.random.default_rng(31), "text", 1 << 18)
    return _batches(_zlib_raw(data, 6), dev=dev)[1]


@pytest.fixture(scope="module")
def base_batch():
    wf, metas, row, halo, npe, nb, oc, ww = _base_call()
    assert int(metas[row][1]) > 0 and npe >= 4
    return wf, metas[row].numpy(), halo, npe, nb, oc, ww


def test_adversarial_windows_cover_the_edges(base_batch):
    wf, meta, halo, npe, nb, oc, ww = base_batch
    cases = chip_smoke.adversarial_windows(meta, npe, nb, seed=3)
    assert tuple(c[0] for c in cases) == ADVERSARIAL
    for name, m, ne in cases:
        if name == "tree_relabel":
            assert ne > nb
        else:
            assert ne == nb and not np.array_equal(m, meta), name
    late = dict((c[0], c[1]) for c in cases)["late_anchors"]
    o_a = 2 + 2 * npe
    al = late[o_a:o_a + npe * twalk.PE_LANES].reshape(npe, -1)
    lanebit = (np.maximum(late[2:2 + npe], 0)[:, None]
               + np.arange(twalk.PE_LANES)[None, :]) * 32
    rel = np.where(al >= 0, al - lanebit, -1)
    assert ((rel >= 32) & (rel < 64)).any()


@pytest.mark.parametrize("name", ADVERSARIAL)
def test_walk_checks_adversarial_windows_match_jax(jax_checks, base_batch,
                                                   name):
    wf, meta, halo, npe, nb, oc, ww = base_batch
    base = _held(jax_checks, wf, meta, halo, npe, nb, oc, ww)
    m, ne = next((m, ne) for n, m, ne in
                 chip_smoke.adversarial_windows(meta, npe, nb, seed=3)
                 if n == name)
    err = _held(jax_checks, wf, m, halo, npe, ne, oc, ww)
    # every change but a longer history breaks a check
    assert (err == base) == (name == "hist_2p30"), (name, err, base)


def _seed_interpret(off, seed, cap):
    with pltpu.force_tpu_interpret_mode():
        S16, err = jex5.seed_scatter_mm(jnp.asarray(off.numpy()),
                                        jnp.asarray(seed.numpy()), cap)
        return np.asarray(S16).reshape(-1), int(err)


def test_seed_plane_matches_slot_attrs_and_jax():
    """seed_plane on a CPU tensor (seed_plane_ref) on the walk's tokens and
    lane offsets of every batch of a stream: the slot arrays equal
    slot_attrs16 (the reference's too), the plane equals seed_scatter_ref
    of them and the JAX seed kernel's plane in interpret mode, where its
    window holds (err 0; else its err is seed_window_err)."""
    data = _mixed(41, 1 << 17)
    held = 0
    for wf, metas, row, halo, npe, nb, oc, ww in _batches(
            _zlib_raw(data, 6)):
        args = tinf._walk_inputs(wf, metas[row], npe, nb, ww)
        tok, _, outlen, laneoff, _ = twalk.walk_checked(*args)
        S16, off, seed = tex5.seed_plane(tok, laneoff, oc)
        roff, rseed = tex5.slot_attrs16(tok, outlen)
        assert torch.equal(off, roff) and torch.equal(seed, rseed)
        joff, jseed = jex5.slot_attrs16(
            jnp.asarray(tok.numpy().view(np.uint32)),
            jnp.asarray(outlen.numpy()))
        np.testing.assert_array_equal(off.numpy(), np.asarray(joff))
        np.testing.assert_array_equal(seed.numpy(), np.asarray(jseed))
        assert torch.equal(S16, tex5.seed_scatter_ref(off, seed, oc))
        assert int((S16 != 0).sum()) == int((seed != 0).sum())
        jS16, jerr = _seed_interpret(off, seed, oc)
        assert jerr == int(tex5.seed_window_err(off, seed, oc))
        if jerr == 0:
            np.testing.assert_array_equal(S16.numpy(), jS16)
            held += 1
    assert held >= 1


def test_expand1_match_lists_are_disjoint_and_increasing():
    """ROADMAP C9 guard: the v1 expansion (B6) is exact only on match lists
    whose expanded matches write disjoint byte ranges at increasing
    offsets. Every list codec/inflate.py::_expand1_inputs builds on the
    anchored test corpus (the input of tests/test_torch_legacy_decode.py,
    every batch, levels 1 and 6) has that shape."""
    checked = 0
    for level in (1, 6):
        raw = _zlib_raw(_mixed(51 + level, 1 << 17), level)
        index = tinf.RawInflater(device="cpu").build_index(raw)
        index = {**{k: v for k, v in index.items() if k != "win"},
                 "anchors": chip_smoke.symbol_anchors(raw, index, "cpu")}
        td = tinf.RawInflater(device="cpu", **BATCH)
        W_pad = tinf._bucket((len(raw) >> 2) + 18, 1 << 13)
        work, _ = td._plan(raw, index, b"", W_pad)
        rawpad = np.zeros(W_pad * 4, np.uint8)
        rawpad[:len(raw)] = np.frombuffer(raw, np.uint8)
        halo = torch.zeros(tinf.HALO, dtype=torch.uint8)
        for kind, item in work:
            if kind != "anchored":
                continue
            (tb, st, en, ll, dl, lanes, nb, oc, _, first, word_lo, ww,
             total, _) = item
            words = rawpad.view(np.uint32)[word_lo:word_lo + ww]
            t = torch.from_numpy
            args = (t(words.astype(np.int64)), t(tb), t(st), t(en), t(ll),
                    t(dl), halo)
            _, produced, err, _ = tinf.decode_batch_anchored(
                *args, lanes, nb, oc, True, t(first))
            assert int(err) == 0 and int(produced) == total
            buf, (m_off, m_d, m_len, ranges), _ = \
                tinf.anchored_expand1_inputs(*args, nb, oc, t(first))
            n = buf.shape[0]
            idx = torch.cat([torch.arange(int(a), int(b))
                             for a, b in ranges[:, :2].tolist()])
            off, d, ln = (x[idx].long() for x in (m_off, m_d, m_len))
            ok = (d > 0) & (ln > 0) & (off >= 0) & (off < n)
            off, ln = off[ok], ln[ok]
            assert off.numel() > 100
            assert bool((off[1:] >= off[:-1] + ln[:-1]).all())
            checked += 1
    assert checked >= 2


# ---- on the card -----------------------------------------------------------

def _need_card(n=1):
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA device(s)")


@pytest.mark.cuda
def test_walk_kernel_checks_match_plain_on_card():
    _need_card()
    wf, metas, row, halo, npe, nb, oc, ww = _base_call("cuda")
    metas_c = [(metas[row], nb)] + [
        (torch.from_numpy(m).cuda(), ne) for _, m, ne in
        chip_smoke.adversarial_windows(metas[row].cpu().numpy(), npe, nb)]
    for meta, ne in metas_c:
        args = tinf._walk_inputs(wf, meta, npe, ne, ww)
        got = twalk.walk_checked(*args)
        want = twalk.walk_checked_ref(*args)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.cuda
def test_seed_plane_kernel_matches_plain_on_card():
    _need_card()
    for wf, metas, row, halo, npe, nb, oc, ww in _batches(
            _zlib_raw(_mixed(41, 1 << 17), 6), dev="cuda"):
        args = tinf._walk_inputs(wf, metas[row], npe, nb, ww)
        tok, _, _, laneoff, _ = twalk.walk_checked(*args)
        for cap in (oc, oc // 3):
            got = tex5.seed_plane(tok, laneoff, cap)
            want = tex5.seed_plane_ref(tok, laneoff, cap)
            for g, w in zip(got, want):
                assert torch.equal(g, w)
    for _, tok, outlen, P, _ in chip_smoke.adversarial_plans(seed=3):
        tok = torch.from_numpy(tok).cuda()
        laneoff = torch.from_numpy(np.cumsum(outlen, dtype=np.int64)
                                   - outlen).cuda()
        got = tex5.seed_plane(tok, laneoff, P.shape[0])
        want = tex5.seed_plane_ref(tok, laneoff, P.shape[0])
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.cuda
def test_decode_on_card_runs_no_eager_checks(monkeypatch):
    """On the card the walk's checks run in the kernel's epilogue and the
    seed plane is the kernel's: a decode with engine 2 calls no cumsum or
    cummin, and the v5 engine no slot_attrs16 or seed_plane_ref."""
    _need_card()
    data = _mixed(61)
    raw = _zlib_raw(data, 6)
    dec = tinf.RawInflater(device="cuda", **BATCH)
    index = dec.build_index(raw)

    def refuse(*a, **k):
        raise AssertionError("an eager check ran on the card")

    with monkeypatch.context() as m:
        m.setattr(torch, "cumsum", refuse)
        m.setattr(torch, "cummin", refuse)
        assert dec.decompress(raw, index=index) == data
    monkeypatch.setenv("JDT_EXPAND", "5")
    monkeypatch.setattr(tex5, "slot_attrs16", refuse)
    monkeypatch.setattr(tex5, "seed_plane_ref", refuse)
    assert dec.decompress(raw, index=index) == data


@pytest.mark.cuda
def test_decode_on_second_card(monkeypatch):
    """ROADMAP C10: the shared resolve's launcher sets its shared-memory
    attribute for each device, so B2 (engine 2), B5 (v5) and B6 (the v1
    expansion) launch on cuda:1 after cuda:0 in one process."""
    _need_card(2)
    data = _mixed(71)
    raw = _zlib_raw(data, 6)
    index = tinf.RawInflater(device="cpu").build_index(raw)
    for engine in ("2", "5"):
        monkeypatch.setenv("JDT_EXPAND", engine)
        for dev in ("cuda:0", "cuda:1"):
            dec = tinf.RawInflater(device=dev, **BATCH)
            assert dec.decompress(raw, index=index) == data
            if engine == "2":
                assert all(e == 0 for _, _, e in dec.last_stats)
    buf = torch.zeros(1 << 16, dtype=torch.uint8)
    buf[:3] = torch.tensor([1, 2, 3], dtype=torch.uint8)
    mats = [torch.tensor(x, dtype=torch.int32) for x in
            ([3], [3], [600], [[0, 1, 0, 0]])]
    want = tex.expand_matches_ref(buf, *mats)
    for dev in ("cuda:0", "cuda:1"):
        got = tex.expand_matches(buf.to(dev), *(x.to(dev) for x in mats))
        torch.cuda.synchronize(dev)
        assert torch.equal(got.cpu(), want)
