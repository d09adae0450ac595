"""Share of the decoded bytes that the card's batches produced, in percent:
the program's counter decode.card_bytes (RawInflater.decompress, by
codec/inflate.py::card_bytes' rule: the device batches before the first
that errs) over the bytes the kept decode records returned. Silent where a
record lacks the counter (a port that does not count it)."""
from benchmark import program_records as pr

SPANS = pr.DECODE
COUNTER = "decode.card_bytes"


def read(trace):
    recs = pr.records(trace, "decode")
    if (recs is None or not trace.decoded
            or any(COUNTER not in r["counters"] for r in recs)):
        return None
    return 100.0 * sum(r["counters"][COUNTER] for r in recs) / trace.decoded
