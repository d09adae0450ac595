"""The devices' idle share of the traced stretch: 1 minus the union of every
card's kernels, copies and sets over the stretch's length, in percent."""


def read(trace):
    if not trace.window_s or trace.busy_s is None:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
