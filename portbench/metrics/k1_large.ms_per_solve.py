"""k1_large.ms_per_solve: device milliseconds of K1's large instance
(``stencil_pcg_large_kernel``) over the solves completed in the traced
window."""


def read(trace):
    launches, seconds = trace.kernel_seconds("stencil_pcg_large_kernel")
    if launches == 0 or trace.solves < 1:
        return None
    return 1e3 * seconds / trace.solves
