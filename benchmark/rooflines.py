"""The table of peaks and the roofline share that each kernel's reader
(layer_metrics/roofline.*.py) reports. The bytes a kernel needs are worked
out in its reader from that call's inputs and outputs: each input byte read
once and each output byte written once, of what these inputs need (the
tokens produced, the matches emitted), never the buffers' capacity."""
from __future__ import annotations

# NVIDIA H100 SXM (the "NVIDIA H100 80GB HBM3" card), data sheet: HBM3 at
# 3.35 TB/s, at its 700 W power limit
PEAK_BYTES_PER_S = 3.35e12


def share(trace, key: str, pattern: str):
    """Percent of the roofline: the least time the card's memory could take
    for the bytes counted under `key` over the profiled time of the kernels
    whose names match `pattern`. None where the counting pass and the
    profiled stretch saw different numbers of launches, or where nothing
    was counted or timed."""
    nbytes = trace.kernel_bytes.get(key)
    calls = trace.kernel_calls.get(key)
    if not nbytes or calls != trace.launches.get(key):
        return None
    secs = trace.kernel_seconds(pattern)
    if secs <= 0:
        return None
    return 100.0 * nbytes / PEAK_BYTES_PER_S / secs
