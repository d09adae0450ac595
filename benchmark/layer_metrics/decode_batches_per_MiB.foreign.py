"""Windowed batches the host decode path planned per MiB decoded: the
program's counter decode.win_batches (RawInflater.decompress) summed over
the kept decode records, over the MiB they returned. Each batch pays the
decode's fixed costs (a meta row, a program launch, its share of the
readback). Silent where a record lacks the counter (a port that does not
count it)."""
from benchmark import program_records as pr

SPANS = pr.DECODE
COUNTER = "decode.win_batches"


def read(trace):
    recs = pr.records(trace, "decode")
    if (recs is None or not trace.decoded
            or any(COUNTER not in r["counters"] for r in recs)):
        return None
    return sum(r["counters"][COUNTER] for r in recs) / (trace.decoded / 2**20)
