"""Share of a decode's time (zstrm.decompress) spent in the checksum of
its output, ops/checksum.py crc32, in percent: the crc32 span's seconds
over the decode records' seconds."""
from benchmark import program_records as pr

SPANS = pr.DECODE


def read(trace):
    return pr.span_share(trace, "crc32", None, "decode")
