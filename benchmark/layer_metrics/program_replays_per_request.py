"""Program replays (codec/program.py, program.stats["replays"]) per request
of the traced stretch."""


def read(trace):
    if not trace.requests or "replays" not in trace.stats:
        return None
    return trace.stats["replays"] / trace.requests
