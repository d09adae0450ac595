"""Graph nodes the captured programs replay per request (compress_with_index,
then decompress): the program.nodes counter (codec/program.py, each
replay's node count, read at capture) summed over both request records of
each request. Silent where no kept record has the counter."""
from benchmark import program_records as pr

SPANS = pr.ENCODE + pr.DECODE
COUNTER = "program.nodes"


def read(trace):
    recs = pr.records(trace, "encode", "decode")
    if (recs is None or not trace.requests
            or not any(COUNTER in r["counters"] for r in recs)):
        return None
    return sum(r["counters"].get(COUNTER, 0)
               for r in recs) / trace.requests
