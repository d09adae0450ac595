"""Share of a request's time (compress_with_index, then decompress) that
the host spends replaying captured programs (codec/program.py: the input
copies, the graph launch, the output clones), in percent: the
program.replay span's seconds over the seconds of both request records of
each request. Silent where no kept record has the span."""
from benchmark import program_records as pr

SPANS = pr.ENCODE + pr.DECODE
SPAN = "program.replay"


def read(trace):
    recs = pr.records(trace, "encode", "decode")
    if recs is None or not any(SPAN in r["spans"] for r in recs):
        return None
    return pr.span_share(trace, SPAN, None, "encode", "decode")
