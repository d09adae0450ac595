"""The per-kernel table (the port of bench.py::_kernel_table): the decode's
walk (B1) and both expansion engines (B2; B4 + B5), the checksums, and the
encoder's stage budget, each timed on the bench's own batch with the cycled
harness of devtime.py.

Every entry has "ms" (span per call, CUDA events), "dev_ms" (the kernels'
own device time per call, torch.profiler) and "GBps" (bytes over "ms": a
decode batch's output capacity, the checksummed bytes, an encode
segment's input). An encoder stage runs the batch up to its tap, so it
also has "delta_ms" and "delta_dev_ms" over the stage before it: the span
is mostly the host's dispatch of eager ops and varies by tens of ms
between calls, the device time rises stage by stage. A stage that fails
becomes {"error": ...}.
"""
from __future__ import annotations

import torch

from ..codec import deflate as De
from ..ops import checksum as cs
from ..ops import expand2 as ex2
from ..ops import expand5 as ex5
from ..ops import walk as wk
from . import capture, devtime

# encode_batch's stages in order; "" is the whole batch
ENCODE_STAGES = ("match", "walk", "entropy", "stored", "pack", "")


def _entry(input_sets, stage, nbytes: int, iters: int) -> dict:
    try:
        r = devtime.measure(input_sets, stage, iters)
    except Exception as e:      # the row shows it; the table goes on
        return {"error": repr(e)[:200]}
    return {**r, "GBps": nbytes / (r["ms"] / 1e3) / 1e9}


def kernel_table(inputs: list, calls: list, enc_calls: list, statics: tuple,
                 iters: int = 4) -> dict:
    """inputs: the input variants (capture.variants); calls, enc_calls,
    statics: capture.capture_decode_sets of them."""
    wis = [capture.walk_inputs_from_call(c) for c in calls]
    oc = wis[0]["oc"]
    table = {"decode_walk": _entry([w["args"] for w in wis], wk.walk_checked,
                                   oc, iters)}
    esets = [(*capture.tok_lm_from_walk(w), w["halo"]) for w in wis]
    # B2 reads a literal's byte from bits 0:8, so the tokens go in as the
    # walk wrote them (no annotate_lit_runs)
    table["decode_expand_v3"] = _entry(
        esets, lambda tok, outlen, lo, halo: ex2.expand_tokens(
            tok, outlen, halo, oc, lo), oc, iters)
    table["decode_expand_v5"] = _entry(
        esets, lambda tok, outlen, lo, halo: ex5.expand_tokens(
            tok, outlen, halo, oc, lo), oc, iters)

    dev = calls[0][0].device
    carr = [(torch.frombuffer(bytearray(v), dtype=torch.uint8).to(dev),)
            for v in inputs]
    n = len(inputs[0])
    table["crc32"] = _entry(carr, cs.crc32, n, iters)
    table["adler32"] = _entry(carr, cs.adler32, n, iters)

    # the encoder's stage budget on one segment
    seg = statics[0] * statics[1]
    prev = {"ms": 0.0, "dev_ms": 0.0}
    for st in ENCODE_STAGES:
        e = _entry(enc_calls, lambda *a, st=st: De.encode_batch(
            *a, *statics, stage=st), seg, iters)
        for key in ("ms", "dev_ms"):
            if e.get(key) is not None and prev[key] is not None:
                e["delta_" + key] = e[key] - prev[key]
            prev[key] = e.get(key)
        table["encode_" + (st or "full")] = e
    return table
