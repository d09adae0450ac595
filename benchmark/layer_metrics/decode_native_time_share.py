"""Share of the decode's time (the program's span decode) spent in the
native decoder (the program's span decode.native: the re-decode from the
first batch that errs, and the index-less sequential path), in percent."""
from benchmark import program_records as pr

SPANS = pr.DECODE


def read(trace):
    return pr.span_share(trace, "decode.native", "decode", "decode")
