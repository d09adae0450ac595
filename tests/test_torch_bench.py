"""The port's bench (jdeflate_tpu_torch.bench) on the CPU: its corpus
byte-equal to bench.py's, one run at 64 KiB with small config rows (one
JSON line with bench.py's keys and the port's three, every row without an
error), its rows held to the JAX package (the compressed size at levels 1,
6 and 9 against jdeflate_tpu's RawDeflater, the foreign stream's dispatch
counts against jdeflate_tpu's RawInflater), the capture helper's replay,
the device-time and kernel-table helpers, and the bench's imports.
Tolerance: exact equality of bytes, sizes and counts. A cuda-marked case
runs the bench on the card at 1 MiB and skips without one."""
import contextlib
import io
import json
import os
import subprocess
import sys

import pytest
import torch

import bench as jbench
from jdeflate_tpu.codec import deflate as jdef
from jdeflate_tpu.codec import inflate as jinf
from jdeflate_tpu.codec import levels as jlevels
from jdeflate_tpu_torch.bench import __main__ as tb
from jdeflate_tpu_torch.bench import capture, corpus, kernels, scaling
from jdeflate_tpu_torch.codec import inflate as tinf
from jdeflate_tpu_torch.codec import levels as tlevels
from jdeflate_tpu_torch.codec.deflate import RawDeflater
from jdeflate_tpu_torch.ops import expand2 as tex2
from jdeflate_tpu_torch.utils import errors

# both sides run the same (CPU-capped) probe depths, tests/conftest.py (C4)
tlevels._PROBE_CAP.update(jlevels._PROBE_CAP)

# one block size and batch for the file, so each JAX encoder level compiles
# once; every row takes the same 64 KiB
N = 64 << 10
BL, BATCH = 1 << 14, 4
ROWS = dict(corpus_bytes=N, level1_bytes=N, level9_bytes=N, framed_bytes=N,
            foreign_bytes=N, sharded_bytes=N, block_size=BL, batch=BATCH)
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "decode_device_GBps",
              "encode_device_GBps", "size_vs_jdeflate"}
ADDED_KEYS = {"size_vs_zlib6", "decode_card_share", "card"}
ROW_NAMES = {"level1_buffer", "level9_ratio", "framed_zstrm", "foreign_zlib",
             "sharded_members"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small; torch's default thread pool only spins
    against the other test workers' JAX compiles."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cpu_run(tmp_path_factory, _one_torch_thread):
    """One bench run on the CPU: (its stdout, the returned line, the
    details file)."""
    path = str(tmp_path_factory.mktemp("bench") / "details.json")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        line = tb.run(device="cpu", skip_extra=False, level=6,
                      details_path=path, **ROWS)
    with open(path) as f:
        details = json.load(f)
    return buf.getvalue(), line, details


@pytest.mark.parametrize("n", [64 << 10, 1 << 20])
def test_corpus_equals_bench_py(n):
    got = corpus.make_corpus(n)
    assert len(got) == n
    assert got == jbench.make_corpus(n)


def test_corpus_text_reference_and_fallback(tmp_path):
    assert corpus.corpus_text(None) == "fallback"
    assert corpus.corpus_text(str(tmp_path)) == "fallback"
    assert corpus.reference_text(100) == corpus.FALLBACK[:100]
    (tmp_path / "README.md").write_bytes(b"reference words\n")
    assert corpus.corpus_text(str(tmp_path)) == "reference"
    assert corpus.reference_text(40, str(tmp_path)) == (
        b"reference words\n" * 3)[:40]
    # the first real-text segment starts within the first MiB
    assert corpus.make_corpus(1 << 20, str(tmp_path)) != corpus.make_corpus(
        1 << 20)


def test_run_prints_one_line_and_every_row(cpu_run):
    out, line, details = cpu_run
    lines = out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == line
    assert set(line) == BENCH_KEYS | ADDED_KEYS
    assert line["metric"] == "decode_GBps_level6_silesia_like"
    assert line["value"] > 0 and line["unit"] == "GB/s"
    assert line["vs_baseline"] == line["value"] / 2.0
    assert line["size_vs_jdeflate"] is None and line["card"] is None
    # no device on the CPU: no device time is written under a device name
    assert line["decode_device_GBps"] is None
    assert line["encode_device_GBps"] is None
    assert details["roundtrip_exact"] is True
    assert details["backend"] == "cpu" and details["corpus_text"] == "fallback"
    assert details["corpus_bytes"] == N
    assert 0 < line["decode_card_share"] <= 1
    assert (details["decode_card_bytes"] + details["decode_stored_bytes"]
            + details["decode_native_bytes"]) == N
    configs = details["configs"]
    assert set(configs) == ROW_NAMES
    for name, row in configs.items():
        assert "error" not in row, (name, row)
        checks = [v for k, v in row.items()
                  if k == "roundtrip" or k.endswith("_ok")]
        assert checks and all(v is True for v in checks), (name, row)
    walls = configs["sharded_members"]["wall_s_by_ranks"]
    assert set(walls) == {"1", "2", "4", "8"}
    # the widest mesh, eight ranks, takes one block a shard
    assert configs["sharded_members"]["n_members"] == N // scaling.BLOCK


@pytest.mark.parametrize("level", [1, 6, 9])
def test_row_size_matches_jax(cpu_run, level):
    _, _, details = cpu_run
    if level == 1:
        src = corpus.make_corpus(4 * N)[:N]
        got = details["configs"]["level1_buffer"]["compressed"]
    elif level == 9:
        src = corpus.make_corpus(N)
        got = details["configs"]["level9_ratio"]["compressed"]
    else:
        src = corpus.make_corpus(N)
        got = details["compressed_bytes"]
    raw, _ = jdef.RawDeflater(level=level, block_size=BL,
                              batch=BATCH).compress(src)
    assert got == len(raw)


def test_foreign_dispatches_match_jax(cpu_run):
    _, _, details = cpu_run
    row = details["configs"]["foreign_zlib"]
    fraw = tb.zlib_raw(corpus.make_corpus(N), 6)
    assert row["compressed"] == len(fraw)
    dec = jinf.RawInflater(**tb.DEC_KW)
    dec.decompress(fraw, index=dec.build_index(fraw))
    kinds = [k for k, _, _ in dec.last_stats]
    assert row["device_dispatches"] == kinds.count("win") > 0
    assert row["dispatch_errs"] == int(sum(e for _, _, e in dec.last_stats))


def test_foreign_row_at_full_size_errs_where_jax_does():
    """The foreign row at its default 4 MiB of the 8 MiB corpus: the third
    windowed batch's last pseudo-entry clamps its word segment (ROADMAP
    C5), so it errs and the native decoder takes over, in both packages."""
    data = corpus.make_corpus(8 << 20)[:4 << 20]
    row = tb._foreign_row(data, tinf.RawInflater(device="cpu", **tb.DEC_KW))
    assert row["roundtrip"] is True
    fraw = tb.zlib_raw(data, 6)
    dec = jinf.RawInflater(**tb.DEC_KW)
    dec.decompress(fraw, index=dec.build_index(fraw))
    kinds = [k for k, _, _ in dec.last_stats]
    errs = int(sum(e for _, _, e in dec.last_stats))
    assert (row["device_dispatches"], row["dispatch_errs"]) == (
        kinds.count("win"), errs)
    assert errs > 0 and 0 < row["card_share"] < 1


@pytest.fixture(scope="module")
def captured(_one_torch_thread):
    data = corpus.make_corpus(N)
    enc = RawDeflater(level=6, block_size=BL, batch=BATCH, device="cpu")
    dec = tinf.RawInflater(device="cpu", **tb.DEC_KW)
    inputs = capture.variants(data)
    return inputs, capture.capture_decode_sets(enc, dec, inputs)


def test_capture_replays_its_batch(captured):
    inputs, (calls, enc_calls, statics) = captured
    assert len(calls) == len(enc_calls) == len(inputs) == 2
    assert statics == (BL, BATCH, 6, statics[3], False)
    for v, call in zip(inputs, calls):
        out, produced, err, _ = tinf.decode_batch_windows_stacked(*call)
        n = int(produced)
        assert int(err) == 0 and 0 < n <= call[6]
        assert out[:n].numpy().tobytes() == v[:n]
        # the rebuilt walk inputs and tokens expand to the same bytes
        wi = capture.walk_inputs_from_call(call)
        tok, outlen, lo = capture.tok_lm_from_walk(wi)
        o2, p2, e2 = tex2.expand_tokens(tok, outlen, wi["halo"], wi["oc"],
                                        lo)
        assert int(p2) == n and int(e2) == 0
        assert torch.equal(o2[:n], out[:n])


def test_device_times_and_kernel_table(captured):
    """The helpers run on any device; on the CPU they have no device time
    (dev_ms None)."""
    inputs, (calls, enc_calls, statics) = captured
    dt = tb._device_times(calls, enc_calls, statics, iters=2)
    assert dt["decode_device_batch_out"] == calls[0][6]
    assert dt["encode_device_batch_in"] == BL * BATCH
    assert dt["decode_device_ms"] > 0 and dt["encode_device_ms"] > 0
    assert dt["decode_dev_ms"] is None and dt["encode_dev_ms"] is None
    table = kernels.kernel_table(inputs, calls, enc_calls, statics, iters=2)
    assert set(table) == {"decode_walk", "decode_expand_v3",
                          "decode_expand_v5", "crc32", "adler32"} | {
        "encode_" + (s or "full") for s in kernels.ENCODE_STAGES}
    for name, e in table.items():
        assert "error" not in e, (name, e)
        assert e["ms"] > 0 and e["GBps"] > 0 and e["dev_ms"] is None
        assert ("delta_ms" in e) == name.startswith("encode_")
        assert "delta_dev_ms" not in e


def test_cycled_timing_needs_two_sets_of_one_shape():
    from jdeflate_tpu_torch.bench import devtime
    a, b = torch.zeros(4), torch.zeros(5)
    with pytest.raises(ValueError):
        devtime.measure_cycled([(a,)], torch.sum)
    with pytest.raises(ValueError):
        devtime.measure_cycled([(a,), (b,)], torch.sum)
    r = devtime.measure([(a,), (a + 1,)], torch.sum, iters=2)
    assert r["ms"] >= 0 and r["dev_ms"] is None


def test_ranks_round_robin_over_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cpu = torch.device("cpu")
    assert scaling.mesh_of(4, torch.device("cuda")) == tuple(
        torch.device("cuda", k) for k in (0, 1, 0, 1))
    assert scaling.mesh_of(2, cpu) == (cpu, cpu)


def test_run_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(errors.IncorrectUseError):
        tb.run(corpus_bytes=N)
    with pytest.raises(errors.IncorrectUseError):
        scaling.probe(b"x")


def test_bench_imports_no_jax():
    code = ("import sys\n"
            "import jdeflate_tpu_torch.bench\n"
            "import jdeflate_tpu_torch.bench.__main__\n"
            "import jdeflate_tpu_torch.bench.scaling\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'jdeflate_tpu' or "
            "m.startswith('jdeflate_tpu.') or m in ('bench', 'devtime', "
            "'decode_capture', 'scaling_probe')]\n"
            "print(bad)\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], cwd=repo,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


@pytest.mark.cuda
def test_bench_on_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    path = str(tmp_path / "details.json")
    mb = 1 << 20
    line = tb.run(device="cuda", corpus_bytes=mb, level=6, skip_extra=False,
                  level1_bytes=mb, level9_bytes=mb, framed_bytes=mb,
                  foreign_bytes=mb, sharded_bytes=mb, details_path=path)
    with open(path) as f:
        details = json.load(f)
    assert set(line) == BENCH_KEYS | ADDED_KEYS
    assert line["value"] > 0 and details["roundtrip_exact"] is True
    assert line["card"] and details["backend"] == "cuda"
    assert line["decode_device_GBps"] > 0 and details["decode_dev_ms"] > 0
    for name, e in details["kernel_table"].items():
        assert "error" not in e and e["dev_ms"] > 0, (name, e)
        assert ("delta_dev_ms" in e) == name.startswith("encode_")
    for name, row in details["configs"].items():
        assert "error" not in row, (name, row)
        assert all(v is True for k, v in row.items()
                   if k == "roundtrip" or k.endswith("_ok")), (name, row)
