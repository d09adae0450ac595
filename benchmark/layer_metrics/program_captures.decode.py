"""CUDA graphs the program layer (codec/program.py) captured during the
traced stretch: program.stats["captures"] after, less before. Above 0 where
the programs of the payloads' shapes overflow the cache and are captured
again."""


def read(trace):
    return trace.stats.get("captures")
