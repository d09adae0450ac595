"""The port's bench (the counterpart of bench.py): encode and decode GB/s
of the level-6 round trip on one card, the size against zlib, the device
times of one decode batch and one encode segment, a per-kernel table, and
the five BASELINE config rows. Prints ONE JSON line:

    python3 -m jdeflate_tpu_torch.bench

Headline: decode GB/s at level 6 on the Silesia-like corpus of corpus.py
(RawDeflater(level, 1 << 16, 16) and RawInflater(1 << 25, 256, 1 << 23),
one warm pass, then best of 3; 0 when the output differs). vs_baseline
divides it by BASELINE's 2 GB/s target. decode_card_share is the part of
that decode's output the card produced: the index puts sub-block starts on
chunk seams that a match may cross (ROADMAP C7), so from the first
windowed batch whose output disagrees the native decoder does the rest.

Settings: BENCH_CORPUS_MB (8), BENCH_LEVEL (6), BENCH_SKIP_EXTRA=1 (the
headline only), BENCH_PROFILE=1 (a torch.profiler Chrome trace of one
timed pass into .profile/ at the repository root), BENCH_REFERENCE_DIR
(the directory of the reference C sources for the corpus's real text;
without it the fallback text, as bench.py has it where the sources are
missing). Details go to jdeflate_tpu_torch/_build/bench_details.json.
size_vs_jdeflate stays null: bench.py builds its size oracle from the
reference's C sources, which are not in the repository; size_vs_zlib<L>
compares with Python's zlib at the same level.
"""
from __future__ import annotations

import contextlib
import gzip
import json
import os
import subprocess
import sys
import time
import zlib

import torch

from ..codec import deflate as De
from ..codec import inflate as I
from ..codec.deflate import RawDeflater
from ..codec.inflate import RawInflater
from ..stream import zstrm
from ..utils import device as _device
from . import capture, corpus, devtime, kernels, scaling

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(_PKG)
DETAILS = os.path.join(_PKG, "_build", "bench_details.json")
PROFILE_DIR = os.path.join(REPO, ".profile")
XFER_BYTES = 4 << 20
BASELINE_GBPS = 2.0           # BASELINE.json's target, not a measurement
# the headline's codec settings (bench.py)
BLOCK, BATCH = 1 << 16, 16
DEC_KW = dict(max_batch_bits=1 << 25, max_batch_blocks=256,
              max_batch_out=1 << 23)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    lines = r.stdout.strip().splitlines()
    return lines[0] if r.returncode == 0 and lines else None


def zlib_raw(data: bytes, level: int) -> bytes:
    """data as a raw DEFLATE stream from Python's zlib at `level`."""
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    return co.compress(data) + co.flush()


def _device_times(calls, enc_calls, statics, iters: int = 4) -> dict:
    """decode_device_ms per decode batch (the captured first windowed batch
    of each input, through decode_batch_windows_stacked: the cut of its
    word window and meta row, then its program's replay, as the decode
    runs it) and
    encode_device_ms per encode segment (launch_batch, the encode program
    as RawDeflater runs it, on the captured first segment): the span per
    call from CUDA events; dev_ms beside each is its kernels' own time."""
    engine = int(os.environ.get("JDT_EXPAND", "2") or 2)
    d = devtime.measure(
        calls, lambda *c: I.decode_batch_windows_stacked(*c, engine), iters)
    e = devtime.measure(enc_calls, lambda *a: De.launch_batch(*a, *statics),
                        iters)
    oc = int(calls[0][6])
    seg = statics[0] * statics[1]
    return {
        "decode_device_ms": d["ms"],
        "decode_dev_ms": d["dev_ms"],
        "decode_device_batch_out": oc,
        "decode_device_GBps": oc / (d["ms"] / 1e3) / 1e9,
        "encode_device_ms": e["ms"],
        "encode_dev_ms": e["dev_ms"],
        "encode_device_batch_in": seg,
        "encode_device_GBps": seg / (e["ms"] / 1e3) / 1e9,
    }


def _transfer(dev: torch.device, n: int, clen: int, dec_s: float,
              details: dict) -> dict:
    """The card's host-to-device and device-to-host copy rates for
    XFER_BYTES of pageable memory (as the decoder uploads), and the decode
    wall set against device time plus the transfer of the corpus."""
    host = torch.ones(XFER_BYTES, dtype=torch.uint8)
    host.to(dev)                                    # warm the path
    devtime.sync(dev)
    t0 = time.perf_counter()
    host.to(dev)
    devtime.sync(dev)
    h2d = XFER_BYTES / max(time.perf_counter() - t0, 1e-9)
    on_dev = (torch.arange(XFER_BYTES, dtype=torch.int32, device=dev)
              + 7).to(torch.uint8)
    on_dev.cpu()
    devtime.sync(dev)
    t0 = time.perf_counter()
    on_dev.cpu()
    d2h = XFER_BYTES / max(time.perf_counter() - t0, 1e-9)
    xfer_s = n / d2h + clen / h2d
    acct = {"h2d_MBps": h2d / 1e6, "d2h_MBps": d2h / 1e6,
            "transfer_est_s": xfer_s, "wall_s": dec_s}
    if "decode_device_ms" in details:
        dev_s = (details["decode_device_ms"] / 1e3
                 * -(-n // details["decode_device_batch_out"]))
        acct["device_sum_s"] = dev_s
        acct["wall_over_device_plus_transfer"] = (
            (dev_s + xfer_s) / dec_s if dec_s else None)
    return acct


def _level_row(data: bytes, level: int, dec, dev, bl: int, batch: int):
    """configs[0] and [3]: encode `data` at `level` (warm, then timed), the
    round trip through the headline's decoder, the size against zlib."""
    enc = RawDeflater(level=level, block_size=bl, batch=batch, device=dev)
    raw, idx = enc.compress(data)
    ok = dec.decompress(raw, index=idx) == data        # warm decode too
    t0 = time.perf_counter()
    raw, idx = enc.compress(data)
    return {"encode_s": time.perf_counter() - t0, "compressed": len(raw),
            "roundtrip": ok and dec.decompress(raw, index=idx) == data,
            "size_vs_zlib": len(raw) / len(zlib_raw(data, level)),
            "size_vs_jdeflate": None}


def _framed_row(data: bytes, dev, bl: int, batch: int) -> dict:
    """configs[2]: gzip and zlib framing, each trailer's checksum (crc32,
    adler32 on the device) verified by the port and by Python's gzip and
    zlib."""
    t0 = time.perf_counter()
    gz = zstrm.compress(data, format="gzip", level=6, block_size=bl,
                        batch=batch, device=dev)
    okg = zstrm.decompress(gz, device=dev) == data
    zl = zstrm.compress(data, format="zlib", level=6, block_size=bl,
                        batch=batch, device=dev)
    okz = zstrm.decompress(zl, device=dev) == data
    return {"gzip_ok": okg and gzip.decompress(gz) == data,
            "zlib_ok": okz and zlib.decompress(zl) == data,
            "wall_s": time.perf_counter() - t0}


def _foreign_row(data: bytes, dec) -> dict:
    """A zlib level-6 stream through build_index (the native sequential
    pass) and the windowed device decode."""
    fraw = zlib_raw(data, 6)
    t0 = time.perf_counter()
    fidx = dec.build_index(fraw)
    idx_s = time.perf_counter() - t0
    outf = dec.decompress(fraw, index=fidx)             # warm
    okf = outf == data
    t0 = time.perf_counter()
    outf = dec.decompress(fraw, index=fidx)
    dec_f = time.perf_counter() - t0
    kinds = [k for k, _, _ in dec.last_stats]
    card, stored = I.card_bytes(dec.last_stats)
    return {"bytes": len(data), "compressed": len(fraw),
            "roundtrip": okf and outf == data,
            "index_s": idx_s, "index_GBps": len(data) / idx_s / 1e9,
            "decode_s": dec_f, "decode_GBps": len(data) / dec_f / 1e9,
            "end_to_end_GBps": len(data) / (idx_s + dec_f) / 1e9,
            "device_dispatches": kinds.count("win"),
            "dispatch_errs": int(sum(e for _, _, e in dec.last_stats)),
            "card_share": card / len(data)}


@contextlib.contextmanager
def _trace(dev: torch.device):
    """torch.profiler over the block, its Chrome trace written to
    PROFILE_DIR/bench_torch_trace.json."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        yield
    os.makedirs(PROFILE_DIR, exist_ok=True)
    prof.export_chrome_trace(os.path.join(PROFILE_DIR,
                                          "bench_torch_trace.json"))


def _row(fn, *args) -> dict:
    """A config row, or {"error": ...} in its place: one row's failure
    stays visible and the bench goes on."""
    try:
        return fn(*args)
    except Exception as e:
        return {"error": repr(e)}


def run(device="cuda", corpus_bytes: int | None = None,
        level: int | None = None, skip_extra: bool | None = None,
        level1_bytes: int = 1 << 20, level9_bytes: int = 4 << 20,
        framed_bytes: int = 2 << 20, foreign_bytes: int = 4 << 20,
        sharded_bytes: int = 1 << 20, block_size: int = BLOCK,
        batch: int = BATCH, details_path: str = DETAILS,
        reference_dir: str | None = None) -> dict:
    """Run the bench on `device`, print its JSON line and return it.
    Unset corpus_bytes, level and skip_extra come from BENCH_CORPUS_MB,
    BENCH_LEVEL and BENCH_SKIP_EXTRA. The device times, the kernel table
    and the transfer rates are taken on a card only (there is no device on
    the CPU); the config rows run on either."""
    dev = _device.resolve(device)
    if corpus_bytes is None:
        corpus_bytes = int(os.environ.get("BENCH_CORPUS_MB", "8")) << 20
    if level is None:
        level = int(os.environ.get("BENCH_LEVEL", "6"))
    if skip_extra is None:
        skip_extra = os.environ.get("BENCH_SKIP_EXTRA", "") == "1"
    t_start = time.perf_counter()
    card = card_line() if dev.type == "cuda" else None
    n = corpus_bytes
    data = corpus.make_corpus(n, reference_dir)

    enc = RawDeflater(level=level, block_size=block_size, batch=batch,
                      device=dev)
    dec = RawInflater(device=dev, **DEC_KW)

    # warm pass: the run's own shapes, so the timed passes are steady
    raw_w, idx_w = enc.compress(data)
    dec.decompress(raw_w, index=idx_w)

    enc_s = dec_s = float("inf")
    raw = index = out = None
    profiled = os.environ.get("BENCH_PROFILE") == "1"
    for k in range(3):
        with (_trace(dev) if profiled and k == 0
              else contextlib.nullcontext()):
            t0 = time.perf_counter()
            raw, index = enc.compress(data)
            enc_s = min(enc_s, time.perf_counter() - t0)
            t0 = time.perf_counter()
            out = dec.decompress(raw, index=index)
            dec_s = min(dec_s, time.perf_counter() - t0)
    ok = out == data
    card_b, stored_b = I.card_bytes(dec.last_stats)
    z = zlib_raw(data, level)

    details = {
        "corpus_bytes": n,
        "corpus_text": corpus.corpus_text(reference_dir),
        "level": level,
        "block_size": block_size,
        "batch": batch,
        "encode_GBps": n / enc_s / 1e9,
        "decode_GBps": n / dec_s / 1e9,
        "encode_s": enc_s,
        "decode_s": dec_s,
        "compressed_bytes": len(raw),
        "ratio": n / len(raw),
        "roundtrip_exact": ok,
        "backend": dev.type,
        "card": card,
        "decode_batches": [list(s) for s in dec.last_stats],
        "decode_card_bytes": card_b,
        "decode_stored_bytes": stored_b,
        "decode_native_bytes": n - card_b - stored_b,
        "decode_card_share": card_b / n,
        "zlib_bytes": len(z),
        "size_vs_zlib": len(raw) / len(z),
        "size_vs_jdeflate": None,
    }

    if dev.type == "cuda" and not skip_extra:
        try:
            inputs = capture.variants(data)
            calls, enc_calls, statics = capture.capture_decode_sets(
                enc, dec, inputs)
        except Exception as e:
            details["device_time_error"] = repr(e)
        else:
            try:
                details.update(_device_times(calls, enc_calls, statics))
            except Exception as e:
                details["device_time_error"] = repr(e)
            try:
                details["kernel_table"] = kernels.kernel_table(
                    inputs, calls, enc_calls, statics)
            except Exception as e:
                details["kernel_table"] = {"error": repr(e)}
        try:
            details["decode_wall_accounting"] = _transfer(
                dev, n, len(raw), dec_s, details)
        except Exception as e:
            details["transfer_probe_error"] = repr(e)

    # ---- per-config rows (BASELINE.json configs[0..4])
    configs = {}
    if not skip_extra:
        text1 = corpus.make_corpus(4 * level1_bytes,
                                   reference_dir)[:level1_bytes]
        configs["level1_buffer"] = _row(_level_row, text1, 1, dec, dev,
                                        block_size, batch)
        configs["level9_ratio"] = _row(_level_row, data[:level9_bytes], 9,
                                       dec, dev, block_size, batch)
        configs["framed_zstrm"] = _row(_framed_row, data[:framed_bytes], dev,
                                       block_size, batch)
        configs["foreign_zlib"] = _row(_foreign_row, data[:foreign_bytes],
                                       dec)
        configs["sharded_members"] = _row(
            scaling.probe, corpus.make_corpus(sharded_bytes, reference_dir),
            dev)
    details["configs"] = configs
    details["jax_imported"] = any(
        m == "jax" or m.startswith("jax.") or m == "jdeflate_tpu"
        or m.startswith("jdeflate_tpu.") for m in sys.modules)
    details["bench_wall_s"] = time.perf_counter() - t_start

    os.makedirs(os.path.dirname(details_path), exist_ok=True)
    with open(details_path, "w") as f:
        json.dump(details, f, indent=2)

    value = details["decode_GBps"] if ok else 0.0
    line = {
        "metric": "decode_GBps_level%d_silesia_like" % level,
        "value": value,
        "unit": "GB/s",
        "vs_baseline": value / BASELINE_GBPS,
        "decode_device_GBps": details.get("decode_device_GBps"),
        "encode_device_GBps": details.get("encode_device_GBps"),
        "size_vs_jdeflate": None,
        "size_vs_zlib%d" % level: details["size_vs_zlib"],
        "decode_card_share": details["decode_card_share"],
        "card": card,
    }
    print(json.dumps(line), flush=True)
    return line


def main() -> None:
    run(reference_dir=os.environ.get("BENCH_REFERENCE_DIR") or None)


if __name__ == "__main__":
    main()
