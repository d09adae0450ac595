"""The one general traffic generator: it reads a configuration and a traffic
mix (data files), makes the payloads, and drives the operation the mix
names through the port's public entry points,
jdeflate_tpu_torch.stream.zstrm.compress_with_index and zstrm.decompress.

An operation is a module of its own, operations/<op>.py, found by the mix's
"op": its OPERATION, a subclass of Operation below, and its SPANS, the
port's functions its calls pass through, which the traced run wraps to name
the device's idle time (tracing.py). A new operation is a new file.

The payloads' bytes come from the configuration's content seed, so every
run does the same work; the run's seed sets the cyclic order of the calls
over the payloads (one caller, closed loop), the sample of answers judged,
the index entries the reference decodes, and one fresh payload: one more of
the configuration's sizes and content, drawn from the run's seed, which goes
through the same call once the window has closed and is judged with the
rest, so that every seed also checks bytes of its own. Each call's record
counts what the end-to-end metrics read: the bytes decoded, the bytes
encoded, the bytes of the member made.
"""
from __future__ import annotations

import dataclasses

from . import corpus, reference, spec

# payload indexes the order and the fresh payload are drawn from: no
# payload of the configuration has them
_ORDER_STREAM = 1 << 40
_FRESH_STREAM = 1 << 43


def payload_sizes(config: dict, traffic: dict) -> list:
    p = config["payload"]
    if "sizes" in p:
        return list(p["sizes"].values())
    return [p["size"]] * traffic["pool"]


def make_payloads(config: dict, traffic: dict) -> list:
    """The payloads, drawn from the configuration's content seed: every
    run's seed sees the same work, in its own order."""
    p = config["payload"]
    kinds = corpus.KINDS[p["content"]]
    return [corpus.make_payload(n, p["content_seed"], i, kinds)
            for i, n in enumerate(payload_sizes(config, traffic))]


def fresh_payload(config: dict, traffic: dict, seed: int) -> bytes:
    """One payload of one of the configuration's sizes and of its content,
    both drawn from the run's seed."""
    sizes = payload_sizes(config, traffic)
    rng = corpus.rng_for(seed, _FRESH_STREAM)
    n = sizes[int(rng.integers(len(sizes)))]
    return corpus.make_payload(n, seed, _FRESH_STREAM,
                               corpus.KINDS[config["payload"]["content"]])


def call_order(n: int, seed: int) -> list:
    """A seeded permutation of the n payloads; calls cycle through it."""
    return [int(i) for i in corpus.rng_for(seed, _ORDER_STREAM).permutation(n)]


@dataclasses.dataclass
class Record:
    payload: int
    seconds: float
    decoded: int = 0        # bytes of output decompressed
    encoded: int = 0        # bytes of input compressed
    member: int = 0         # bytes of the gzip member made
    error: str = ""


class Operation:
    """One operation of the traffic over the payloads; `zstrm` is the
    port's module (passed in, so a test or a fault can stand in for it)."""

    def __init__(self, config: dict, traffic: dict, payloads: list, device,
                 zstrm):
        self.cfg = config
        self.traffic = traffic
        self.payloads = payloads
        self.device = device
        self.zstrm = zstrm

    def prepare(self) -> None:
        """Set-up the calls need (made once, counted in set-up)."""

    def add(self, payload: bytes) -> int:
        """Takes one more payload (the fresh one) and makes what its calls
        need; returns its index."""
        self.payloads.append(payload)
        return len(self.payloads) - 1

    def warm_calls(self) -> list:
        """The payloads whose calls warm every shape the traffic uses."""
        return list(range(len(self.payloads)))

    def compress(self, i: int):
        c = self.cfg
        return self.zstrm.compress_with_index(
            self.payloads[i], format=c["format"], level=c["level"],
            block_size=c["block_size"], batch=c["batch"], device=self.device)

    def decompress(self, stream: bytes, index: dict, hl: int) -> bytes:
        return self.zstrm.decompress(stream, format=self.cfg["format"],
                                     index=index, header_len=hl,
                                     device=self.device)

    def call(self, i: int):
        """(answer, Record fields) of one call on payload i."""
        raise NotImplementedError

    def check(self, i: int, answer, rng) -> dict:
        """Fault counts of one answer (reference.py)."""
        raise NotImplementedError

    def check_setup(self, rng) -> dict:
        """Fault counts of what set-up made for the calls."""
        return {}


def member_faults(stream, index, hl, payload, rng, samples) -> dict:
    """Fault counts of one gzip member and its index against the payload."""
    got = reference.check_stream(stream, payload)
    faults = {"streams_rejected": got["rejected"],
              "bytes_differing": got["differing"], "index_faults": 0,
              "c7_blocks": 0, "notes": []}
    if "raw" in got:
        found, c7 = reference.check_index(got["raw"], index, payload, rng,
                                          samples)
        if hl != got["header_len"]:
            found.append(f"header length {hl}, RFC 1952 {got['header_len']}")
        faults["index_faults"] = len(found)
        faults["c7_blocks"] = c7
        faults["notes"] = found
    else:
        faults["index_faults"] = 1
        faults["notes"] = ["the member does not decode: no index check"]
    return faults


def load(op: str):
    """operations/<op>.py: (its Operation subclass, its SPANS)."""
    mod = spec.load_module("operations", op, needs="OPERATION")
    if not (isinstance(mod.OPERATION, type)
            and issubclass(mod.OPERATION, Operation)):
        raise spec.SpecError(f"operations/{op}.py: OPERATION is not an "
                             "Operation")
    return mod.OPERATION, tuple(getattr(mod, "SPANS", ()))


def sample_keep(n_calls_seen: int, rng, k: int) -> int | None:
    """Reservoir sampling: the slot (0..k-1) where the n-th answer seen
    (1-based) replaces a kept one, or None to drop it."""
    if n_calls_seen <= k:
        return n_calls_seen - 1
    j = int(rng.integers(n_calls_seen))
    return j if j < k else None
