"""Device time of the encoder's match stage (ops/lz77.py
find_matches_batch, its own captured program per batch) per MiB of input
encoded: the encode.match_ns counter of the port's kept encode records
(jdeflate_tpu_torch/codec/deflate.py read_batch), summed, in ms. Silent
where a record lacks the counter (a port that times no stage, the CPU)."""
from benchmark import program_records as pr

SPANS = pr.ENCODE
COUNTER = "encode.match_ns"


def read(trace):
    recs = pr.records(trace, "encode")
    if (recs is None or not trace.encoded
            or any(COUNTER not in r["counters"] for r in recs)):
        return None
    ms = sum(r["counters"][COUNTER] for r in recs) / 1e6
    return ms / (trace.encoded / (1 << 20))
