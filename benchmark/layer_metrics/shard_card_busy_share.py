"""How much of its cards a sharded encode keeps at work, in percent: the
encode stages' device time of every batch (the encode.match_ns and
encode.code_ns counters of the port's kept ShardedDeflater.compress
records, parallel/shard.py) over the cards' time, each record's shard.ranks
(the ranks that encoded a shard) times its seconds. Silent where a record
lacks a counter (a port that does not trace the sharded call, the CPU)."""
from benchmark import program_records as pr
from benchmark import spec

OP = spec.load_module("operations", "sharded_encode", needs="RECORDS")
SPANS = OP.RECORDS
COUNTERS = ("encode.match_ns", "encode.code_ns", "shard.ranks")


def read(trace):
    recs = pr.records(trace, OP.COMPRESS)
    if recs is None or any(r["op"] != OP.COMPRESS
                           or any(c not in r["counters"] for c in COUNTERS)
                           for r in recs):
        return None
    cards_ns = sum(r["counters"]["shard.ranks"] * r["seconds"] * 1e9
                   for r in recs)
    if not cards_ns:
        return None
    busy = sum(r["counters"][c] for r in recs for c in COUNTERS[:2])
    return 100.0 * busy / cards_ns
