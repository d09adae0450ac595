"""roundtrip: a call compresses one payload (zstrm.compress_with_index),
then decompresses the member with its index (zstrm.decompress)."""
from benchmark import generator, reference, spec

# the spans of both halves
SPANS = (spec.load_module("operations", "encode", needs="SPANS").SPANS
         + spec.load_module("operations", "decode", needs="SPANS").SPANS)


class RoundTrip(generator.Operation):
    def call(self, i: int):
        stream, index, hl = self.compress(i)
        out = self.decompress(stream, index, hl)
        return (stream, index, hl, out), {"encoded": len(self.payloads[i]),
                                          "member": len(stream),
                                          "decoded": len(out)}

    def check(self, i: int, answer, rng) -> dict:
        stream, index, hl, out = answer
        f = generator.member_faults(stream, index, hl, self.payloads[i], rng,
                                    self.traffic["index_samples"])
        f["bytes_differing"] += reference.bytes_differing(out,
                                                          self.payloads[i])
        return f


OPERATION = RoundTrip
