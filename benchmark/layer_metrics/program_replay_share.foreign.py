"""Share of a zlib decode's time (the program's span decode,
zstrm.decompress) that the host spends replaying captured programs
(codec/program.py: the input copies, the graph launch, the output
clones), in percent: the program.replay span's seconds over the decode
span's, over the kept decode records. Silent where no kept record has the
span."""
from benchmark import program_records as pr

SPANS = pr.DECODE
SPAN = "program.replay"


def read(trace):
    recs = pr.records(trace, "decode")
    if recs is None or not any(SPAN in r["spans"] for r in recs):
        return None
    return pr.span_share(trace, SPAN, "decode", "decode")
