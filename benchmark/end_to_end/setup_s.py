"""Process start to the first timed call: the kernels' build, the payloads,
the members a decode needs, and the warm calls, in seconds."""


def read(window):
    return window.setup_s
