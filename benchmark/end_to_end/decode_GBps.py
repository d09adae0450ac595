"""Decompressed, CRC-checked bytes over the whole window's time, GB/s."""
from benchmark import stats


def read(window):
    n = sum(r.decoded for r in window.records)
    return stats.rate(n, window.seconds) / 1e9 if n else None
