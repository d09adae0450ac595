"""sharded_encode: a call compresses one whole payload with the port's
ShardedDeflater (parallel/shard.py) in members mode, over a mesh of the
configuration's `ranks` cards: one gzip member of `blocks_per_device` x
`block_size` bytes per shard, each with its index, in source order. It
bypasses zstrm, so the `zstrm` the harness passes is not used.

Every member of a judged answer is held to members_reference.py; the
index of `index_members` seeded members of the answer is held to
reference.check_index through generator.member_faults, `index_samples`
entries each (the pure-Python block decoder would take minutes over every
member's index)."""
from benchmark import generator, members_reference
from benchmark import program_records as pr

SHARD = "jdeflate_tpu_torch.parallel.shard"
# the request record of each call, for the per-layer readers
COMPRESS = "ShardedDeflater.compress"
RECORDS = ((SHARD, "ShardedDeflater.compress", COMPRESS, pr.keep),)
SPANS = RECORDS + (
    (SHARD, "encode_sharded", "shard.encode_sharded"),
    (SHARD, "checksums_sharded", "shard.checksums_sharded"),
    (SHARD, "read_crc", "shard.read_crc"),
    ("jdeflate_tpu_torch.codec.deflate", "read_batch", "deflate.read_batch"),
)


class ShardedEncode(generator.Operation):
    def prepare(self) -> None:
        from jdeflate_tpu_torch.parallel import mesh, shard
        c = self.cfg
        ranks = c["ranks"]
        self.mesh = (mesh.make_mesh(ranks) if self.device == "cuda"
                     else mesh.make_mesh(ranks, device=self.device))
        self.deflater = shard.ShardedDeflater(
            mesh=self.mesh, level=c["level"], block_size=c["block_size"],
            blocks_per_device=c["blocks_per_device"], mode=c["mode"])
        self.shard = c["block_size"] * c["blocks_per_device"]

    def warm_calls(self) -> list:
        # one payload: its call captures every card's two programs
        return [0]

    def call(self, i: int):
        blob, info = self.deflater.compress(self.payloads[i])
        return (blob, info), {"encoded": len(self.payloads[i]),
                              "member": len(blob)}

    def check(self, i: int, answer, rng) -> dict:
        blob, info = answer
        payload = self.payloads[i]
        got = members_reference.check_members(blob, payload, self.shard,
                                               info)
        faults = {"streams_rejected": got["rejected"],
                  "bytes_differing": got["differing"],
                  "index_faults": len(got["info_faults"]), "c7_blocks": 0,
                  "notes": list(got["info_faults"])}
        listed = info.get("members") or []
        picks = rng.choice(len(listed), min(self.traffic["index_members"],
                                            len(listed)), replace=False) \
            if listed else []
        for k in sorted(int(k) for k in picks):
            if len(listed[k]) < 4 or not isinstance(listed[k][3], dict):
                faults["index_faults"] += 1
                faults["notes"].append(f"member {k} has no index")
                continue
            off, ln, _, index = listed[k]
            src = payload[k * self.shard:(k + 1) * self.shard]
            for key, v in generator.member_faults(
                    blob[off:off + ln], index, index.get("header_len"), src,
                    rng, self.traffic["index_samples"]).items():
                faults[key] += v
        return faults

    def check_setup(self, rng) -> dict:
        """Set-up makes nothing that is judged. Logs each card's peak
        memory since the start (the result line holds the first card's)."""
        import torch
        if self.device == "cuda":
            from benchmark.harness import log
            log("peak memory by card: " + ", ".join(
                f"{d}: {torch.cuda.max_memory_allocated(d)}"
                for d in self.mesh))
        return {}


OPERATION = ShardedEncode
