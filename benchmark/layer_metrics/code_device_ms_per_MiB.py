"""Device time of the encoder's coding stages (codec/deflate.py
encode_batch after the match: parse, the match walk B3, frequencies, split
DP, trees, pack, anchors; their own captured program per batch) per MiB of
input encoded: the encode.code_ns counter of the port's kept encode
records, summed, in ms. Silent where a record lacks the counter."""
from benchmark import program_records as pr

SPANS = pr.ENCODE
COUNTER = "encode.code_ns"


def read(trace):
    recs = pr.records(trace, "encode")
    if (recs is None or not trace.encoded
            or any(COUNTER not in r["counters"] for r in recs)):
        return None
    ms = sum(r["counters"][COUNTER] for r in recs) / 1e6
    return ms / (trace.encoded / (1 << 20))
