"""device.idle_pct: the share of the traced window in which no kernel and no
copy ran on the card (the union of the profiler's device intervals), in %."""


def read(trace):
    span = trace.span[1] - trace.span[0]
    if span <= 0 or not (trace.kernels or trace.copies):
        return None
    return 100.0 * (1.0 - trace.busy_s / span)
