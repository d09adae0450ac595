"""The 95th percentile (nearest rank) of one request's time on the host's
clock, over every request of the window, in ms."""
from benchmark import stats


def read(window):
    if not window.records:
        return None
    return stats.percentile([r.seconds for r in window.records], 95) * 1e3
