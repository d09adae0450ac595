"""encode: a call compresses one payload into a gzip member and its index
(zstrm.compress_with_index)."""
from benchmark import generator

DEFLATE = "jdeflate_tpu_torch.codec.deflate"
SPANS = (
    ("jdeflate_tpu_torch.stream.zstrm", "compress_with_index", "encode"),
    (DEFLATE, "RawDeflater.launch", "encode.launch"),
    (DEFLATE, "RawDeflater.finish", "encode.finish"),
    ("jdeflate_tpu_torch.ops.checksum", "crc32", "crc32"),
)


class Encode(generator.Operation):
    def warm_calls(self) -> list:
        # every batch of every payload has one shape: the smallest payload
        # warms the encode program and the checksum's
        sizes = [len(p) for p in self.payloads]
        return [sizes.index(min(sizes))]

    def call(self, i: int):
        stream, index, hl = self.compress(i)
        return (stream, index, hl), {"encoded": len(self.payloads[i]),
                                     "member": len(stream)}

    def check(self, i: int, answer, rng) -> dict:
        return generator.member_faults(*answer, self.payloads[i], rng,
                                       self.traffic["index_samples"])


OPERATION = Encode
