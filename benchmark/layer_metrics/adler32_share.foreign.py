"""Share of a zlib decode's time (the program's span decode,
zstrm.decompress) spent in the Adler-32 check of its output (the program's
span adler32, ops/checksum.py), in percent, over the kept decode records.
Silent where a record lacks the adler32 span (a port that does not trace
adler32)."""
from benchmark import program_records as pr

SPANS = pr.DECODE


def read(trace):
    recs = pr.records(trace, "decode")
    if recs is None or any("adler32" not in r["spans"] for r in recs):
        return None
    return pr.span_share(trace, "adler32", "decode", "decode")
