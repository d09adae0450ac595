"""Share of a request's time (compress_with_index, then decompress) spent
in the checksum, ops/checksum.py crc32, in percent: the crc32 span's
seconds over the seconds of both request records of each request."""
from benchmark import program_records as pr

SPANS = pr.ENCODE + pr.DECODE


def read(trace):
    return pr.span_share(trace, "crc32", None, "encode", "decode")
