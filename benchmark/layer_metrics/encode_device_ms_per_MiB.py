"""Device time (the union of kernels, copies and sets that torch.profiler
saw in the traced stretch) per MiB of input encoded."""


def read(trace):
    if trace.busy_s is None or not trace.encoded:
        return None
    return trace.busy_s * 1e3 / (trace.encoded / (1 << 20))
