"""decode: set-up makes each payload's gzip member and index with the port
(zstrm.compress_with_index); a call decompresses one member with its index,
the CRC-32 check included. Set-up's members are judged too."""
from benchmark import generator, reference

ZSTRM = "jdeflate_tpu_torch.stream.zstrm"
INFLATE = "jdeflate_tpu_torch.codec.inflate"
SPANS = (
    (ZSTRM, "decompress", "decode"),
    (INFLATE, "RawInflater.decompress", "decode.inflater"),
    (INFLATE, "RawInflater._plan", "decode.plan"),
    (INFLATE, "RawInflater._upload", "decode.upload"),
    (INFLATE, "RawInflater._launch", "decode.launch"),
    (INFLATE, "RawInflater._finish", "decode.finish"),
    ("jdeflate_tpu_torch.stream.native", "inflate", "decode.native"),
    ("jdeflate_tpu_torch.ops.checksum", "crc32", "crc32"),
)


class Decode(generator.Operation):
    def prepare(self) -> None:
        self.members = [self.compress(i) for i in range(len(self.payloads))]

    def add(self, payload: bytes) -> int:
        i = super().add(payload)
        self.members.append(self.compress(i))
        return i

    def call(self, i: int):
        out = self.decompress(*self.members[i])
        return out, {"decoded": len(out)}

    def check(self, i: int, answer, rng) -> dict:
        return {"bytes_differing": reference.bytes_differing(
            answer, self.payloads[i])}

    def check_setup(self, rng) -> dict:
        """The members decoded must be valid gzip holding their payloads."""
        tot: dict = {}
        for i, (stream, index, hl) in enumerate(self.members):
            for k, v in generator.member_faults(
                    stream, index, hl, self.payloads[i], rng,
                    self.traffic["index_samples"]).items():
                tot[k] = tot.get(k, 0 if k != "notes" else []) + v
        return tot


OPERATION = Decode
