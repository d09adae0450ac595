"""Share of a sharded encode's time (the port's kept ShardedDeflater.compress
records, parallel/shard.py) spent in the host's gather, in percent: its
spans shard.read (each rank's crc32 and batch read back, the wait for the
card included) and shard.assemble (member bytes, index entries, the file),
over the records' seconds: what the JAX package did with collectives.
Silent where a record lacks the spans (a port that does not trace the
sharded call)."""
from benchmark import program_records as pr
from benchmark import spec

OP = spec.load_module("operations", "sharded_encode", needs="RECORDS")
SPANS = OP.RECORDS
GATHER = ("shard.read", "shard.assemble")


def read(trace):
    recs = pr.records(trace, OP.COMPRESS)
    if recs is None or any(r["op"] != OP.COMPRESS
                           or any(s not in r["spans"] for s in GATHER)
                           for r in recs):
        return None
    total = sum(r["seconds"] for r in recs)
    if not total:
        return None
    return 100.0 * sum(r["spans"][s] for r in recs for s in GATHER) / total
