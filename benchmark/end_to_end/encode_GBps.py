"""Input bytes turned into gzip members with their index over the whole
window's time, GB/s."""
from benchmark import stats


def read(window):
    n = sum(r.encoded for r in window.records)
    return stats.rate(n, window.seconds) / 1e9 if n else None
