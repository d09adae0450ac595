"""foreign_decode: set-up makes each payload's zlib stream with Python's zlib
(the configuration's `encoder`, a foreign encoder to the port) and indexes
its DEFLATE body once with the port's RawInflater.build_index, as zlib's
examples/zran.c does; a call decompresses one whole stream with that index
through zstrm.decompress, the Adler-32 check included.

Each answer is held to its payload; set-up's streams and indexes are
judged too: every stream by zlib_reference.py (RFC 1950 header, zlib's
raw inflate ending at the trailer, the trailer's Adler-32), every index by
reference.check_index with `index_samples` seeded entries decoded. The
index is exact, so a sampled entry whose output length is not the
index's (C7 in the port's own members) is an index fault here.

The guarantee that a mismatched trailer raises is held on the same card:
the fresh payload's call, once the window has closed, also sends its
stream with the trailer's last byte flipped through the same entry, and
fails unless that raises ChecksumError. A decode that skipped or
miscomputed the check would return right bytes there, so the run would
read correct without it; with it, the failed call counts in
calls_failed."""
import time
import zlib

from benchmark import generator, reference, spec, zlib_reference
from benchmark.harness import log

SPANS = spec.load_module("operations", "decode", needs="SPANS").SPANS + (
    ("jdeflate_tpu_torch.ops.checksum", "adler32", "adler32"),
)


def _index_seconds() -> float | None:
    """Seconds of the build_index call that just returned, from the port's
    request record (None where the port does not trace it)."""
    from jdeflate_tpu_torch import trace
    rec = trace.last_request()
    if rec is None or rec["op"] != "RawInflater.build_index":
        return None
    return rec["seconds"]


class ForeignDecode(generator.Operation):
    fresh = None        # index of the fresh payload, once added

    def prepare(self) -> None:
        enc = self.cfg["encoder"]
        log(f"zlib {zlib.ZLIB_RUNTIME_VERSION}: compressobj({enc['level']}, "
            f"DEFLATED, {enc['wbits']}, {enc['mem_level']}, "
            f"{enc['strategy']})")
        self.streams = [self.make(i) for i in range(len(self.payloads))]

    def add(self, payload: bytes) -> int:
        i = super().add(payload)
        self.streams.append(self.make(i))
        self.fresh = i
        return i

    def make(self, i: int) -> tuple:
        """(zlib stream, index of its body) of payload i."""
        from jdeflate_tpu_torch.codec.inflate import RawInflater
        enc = self.cfg["encoder"]
        co = zlib.compressobj(enc["level"], zlib.DEFLATED, enc["wbits"],
                              enc["mem_level"], getattr(zlib, enc["strategy"]))
        stream = co.compress(self.payloads[i]) + co.flush()
        t0 = time.perf_counter()
        index = RawInflater(device=self.device).build_index(stream[2:-4])
        host = time.perf_counter() - t0
        log(f"payload {i}: {len(self.payloads[i])} B, zlib stream "
            f"{len(stream)} B, {len(index['block_bits'])} index entries in "
            f"{host:.4f} s (request record: {_index_seconds()})")
        return stream, index

    def call(self, i: int):
        stream, index = self.streams[i]
        out = self.zstrm.decompress(stream, format="zlib", index=index,
                                    device=self.device)
        if i == self.fresh:
            self.refuses_flipped_trailer(stream, index)
        return out, {"decoded": len(out)}

    def refuses_flipped_trailer(self, stream: bytes, index: dict) -> None:
        """Raises unless the stream with its Adler-32 trailer's last byte
        flipped raises ChecksumError through the call's entry."""
        from jdeflate_tpu_torch.utils.errors import ChecksumError
        bad = stream[:-1] + bytes([stream[-1] ^ 1])
        try:
            self.zstrm.decompress(bad, format="zlib", index=index,
                                  device=self.device)
        except ChecksumError:
            log("the fresh stream with its trailer flipped raised "
                "ChecksumError")
            return
        raise RuntimeError("a stream whose Adler-32 trailer is flipped "
                           "decoded without ChecksumError")

    def check(self, i: int, answer, rng) -> dict:
        return {"bytes_differing": reference.bytes_differing(
            answer, self.payloads[i])}

    def check_setup(self, rng) -> dict:
        """The streams decoded must be valid zlib streams holding their
        payloads, each index exact for its stream."""
        tot = {"streams_rejected": 0, "bytes_differing": 0,
               "index_faults": 0, "notes": []}
        for i, (stream, index) in enumerate(self.streams):
            got = zlib_reference.check_stream(stream, self.payloads[i])
            tot["streams_rejected"] += got["rejected"]
            tot["bytes_differing"] += got["differing"]
            if "raw" not in got:
                tot["index_faults"] += 1
                tot["notes"].append(f"stream {i} does not decode: no index "
                                    "check")
                continue
            found, c7 = reference.check_index(
                got["raw"], index, self.payloads[i], rng,
                self.traffic["index_samples"])
            if c7:
                found.append(f"{c7} sampled entries whose output length is "
                             "not the index's")
            tot["index_faults"] += len(found)
            tot["notes"] += [f"stream {i}: {f}" for f in found]
        return tot


OPERATION = ForeignDecode
