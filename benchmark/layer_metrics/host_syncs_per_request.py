"""Blocking device-to-host reads per request: the d2h.calls counter of the
port's transfers (utils/device.py::to_host), summed over both request
records of each request (compress_with_index, then decompress)."""
from benchmark import program_records as pr

SPANS = pr.ENCODE + pr.DECODE


def read(trace):
    recs = pr.records(trace, "encode", "decode")
    if recs is None or not trace.requests:
        return None
    return sum(r["counters"].get("d2h.calls", 0)
               for r in recs) / trace.requests
