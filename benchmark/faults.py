"""Faults planted under the timed path, to show that the comparison with
the reference turns `correct` false. The benchmark's own runs plant none;
run.py --fault <name> and tests/test_benchmark_faults.py do.

- control: the reference's guarantee broken after the program's own checks:
  each answer of the entry points (the bytes decompress returns, the member
  compress_with_index returns) has one byte altered.
- altered: one byte altered where it is produced: in the bytes the decode's
  readback assembles (RawInflater._finish), in the raw stream the encode
  assembles (RawDeflater.finish).
- half: half of the work left out: the decode returns the first half of
  its output, the encode compresses the first half of its input.
- stale: a call returns the answer of the call before it.
"""
from __future__ import annotations

import contextlib


def flip(b: bytes) -> bytes:
    """b with its middle byte altered."""
    if not b:
        return b
    k = len(b) // 2
    return b[:k] + bytes([b[k] ^ 0x5A]) + b[k + 1:]


@contextlib.contextmanager
def _patched(pairs):
    """pairs: (owner, name, make) with make(original) -> replacement."""
    saved = []
    try:
        for owner, name, make in pairs:
            orig = getattr(owner, name)
            saved.append((owner, name, orig))
            setattr(owner, name, make(orig))
        yield
    finally:
        for owner, name, orig in reversed(saved):
            setattr(owner, name, orig)


def _classes():
    from jdeflate_tpu_torch.codec.deflate import RawDeflater
    from jdeflate_tpu_torch.codec.inflate import RawInflater
    return RawInflater, RawDeflater


def control(zstrm):
    def dec(orig):
        return lambda *a, **k: flip(orig(*a, **k))

    def enc(orig):
        def call(*a, **k):
            stream, index, hl = orig(*a, **k)
            body = flip(stream[hl:-8])
            return stream[:hl] + body + stream[-8:], index, hl
        return call
    return _patched([(zstrm, "decompress", dec),
                     (zstrm, "compress_with_index", enc)])


def altered(zstrm):
    inf, de = _classes()

    def finish_dec(orig):
        return lambda *a, **k: flip(orig(*a, **k))

    def finish_enc(orig):
        def call(*a, **k):
            raw, index = orig(*a, **k)
            return flip(raw), index
        return call
    return _patched([(inf, "_finish", finish_dec), (de, "finish", finish_enc)])


def half(zstrm):
    inf, de = _classes()

    def finish_dec(orig):
        def call(*a, **k):
            out = orig(*a, **k)
            return out[:len(out) // 2]
        return call

    def launch_enc(orig):
        def call(self, data, *a, **k):
            return orig(self, data[:len(data) // 2], *a, **k)
        return call
    return _patched([(inf, "_finish", finish_dec), (de, "launch", launch_enc)])


def stale(zstrm):
    inf, de = _classes()

    def previous(orig):
        last = []

        def call(*a, **k):
            got = orig(*a, **k)
            last.append(got)
            return last.pop(0) if len(last) > 1 else got
        return call
    return _patched([(inf, "_finish", previous), (de, "finish", previous)])


FAULTS = {"control": control, "altered": altered, "half": half,
          "stale": stale}
