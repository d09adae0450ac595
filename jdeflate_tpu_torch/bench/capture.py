"""A decode batch's kernel inputs from the codec's own capture hooks (the
port of scripts/decode_capture.py), for timing each stage alone.

RawInflater.capture_calls keeps every windowed batch's device arguments in
last_calls, as the decode hands them to its program (recorded outside the
captured program, which runs no Python on a replay), and
RawDeflater.capture_calls every encode batch's encode_batch arguments (the
static ones in call_statics). From one windowed batch this rebuilds the
walk's arguments (codec/inflate.py::_walk_inputs) and its tokens
(ops/walk.py::walk_checked), op by op.
"""
from __future__ import annotations

from ..codec import inflate as I
from ..ops import walk as wk


def variants(data: bytes) -> list:
    """The corpus and a copy with one bit flipped every 8 KiB: two inputs
    of one length whose batches have one shape and other contents."""
    d2 = bytearray(data)
    for p in range(100, len(d2), 8192):
        d2[p] ^= 1
    return [data, bytes(d2)]


def capture_decode_sets(enc, dec, inputs):
    """Encode and decode each input with capture on. Returns (calls,
    enc_calls, statics): the first windowed decode call of each input,
    (words_full, metas, row, win, npe, nb, oc, wwords); the first encode
    call of each, (data, start, seg_n, dict_len, final_rel); and the
    encoder's static arguments. Raises when an input does not round-trip
    or left no windowed batch. row is a 0-d device tensor:
    codec/inflate.py::decode_batch_windows_stacked takes a call as it
    is."""
    calls, enc_calls = [], []
    enc.capture_calls = dec.capture_calls = True
    try:
        for v in inputs:
            raw, idx = enc.compress(v)
            out = dec.decompress(raw, index=idx)
            if out != v or not dec.last_calls or not enc.last_calls:
                raise RuntimeError("capture failed: no round trip or no "
                                   "windowed batch")
            calls.append(dec.last_calls[0])
            enc_calls.append(enc.last_calls[0])
        statics = enc.call_statics
    finally:
        enc.capture_calls = dec.capture_calls = False
        enc.last_calls = []
        dec.last_calls = []
    return calls, enc_calls, statics


def walk_inputs_from_call(call) -> dict:
    """One captured windowed call -> {"args": walk_checked's arguments,
    "halo": the batch's 32 KiB history, "oc": its output capacity}."""
    words_full, metas, row, win, npe, nb, oc, wwords = call
    return {"args": I._walk_inputs(words_full, metas[row], npe, nb, wwords),
            "halo": win, "oc": oc}


def tok_lm_from_walk(wi: dict):
    """Run the walk on rebuilt inputs -> (tok_lm, outlen, laneoff), the
    expansion engines' inputs."""
    tok, _, outlen, laneoff, _ = wk.walk_checked(*wi["args"])
    return tok, outlen, laneoff

