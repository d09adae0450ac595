"""Device time between the encoder's two programs per MiB of input
encoded: from the match program's last node to the coding program's first
(the match program's output clones, the coding program's input copies and
the card's wait for the host to launch it), the encode.launch_wait_ns
counter of the port's kept encode records (codec/deflate.py read_batch,
from the card's clock stamped inside the programs), summed, in ms. Silent
where a record lacks the counter."""
from benchmark import program_records as pr

SPANS = pr.ENCODE
COUNTER = "encode.launch_wait_ns"


def read(trace):
    recs = pr.records(trace, "encode")
    if (recs is None or not trace.encoded
            or any(COUNTER not in r["counters"] for r in recs)):
        return None
    ms = sum(r["counters"][COUNTER] for r in recs) / 1e6
    return ms / (trace.encoded / (1 << 20))
