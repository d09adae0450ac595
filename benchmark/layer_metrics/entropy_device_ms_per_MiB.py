"""Device time of the coding stages' entropy stage (codec/deflate.py
code_batch from the split's exit to _block_entropy's: the groups, their
frequencies, the trees and the header items) per MiB of input encoded:
the encode.entropy_ns counter of the port's kept encode records (the
card's clock stamped inside the coding program), summed, in ms. Silent
where a record lacks the counter."""
from benchmark import program_records as pr

SPANS = pr.ENCODE
COUNTER = "encode.entropy_ns"


def read(trace):
    recs = pr.records(trace, "encode")
    if (recs is None or not trace.encoded
            or any(COUNTER not in r["counters"] for r in recs)):
        return None
    ms = sum(r["counters"][COUNTER] for r in recs) / 1e6
    return ms / (trace.encoded / (1 << 20))
