"""device.kernels_per_solve: kernels the card ran in the traced window (copies
and fills left out) over the solves completed in it."""


def read(trace):
    if not trace.kernels or trace.solves < 1:
        return None
    return len(trace.kernels) / trace.solves
