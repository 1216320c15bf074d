"""k3_large.roofline_pct: K3's large instance (``chol_solve_large_kernel``)
against its bound, in %: the least time the card could take for the cell
solves of the window (``portbench/roofline/chol_solve_large.py``, every cell
of every completed solve) over the kernel's device time in the window."""


def read(trace):
    launches, seconds = trace.kernel_seconds("chol_solve_large_kernel")
    if launches == 0 or trace.solves < 1 or trace.peaks is None:
        return None
    w = trace.work
    roof = trace.roofline("chol_solve_large")
    bound = roof.bound_seconds(w["cells"] * trace.solves, w["cell_dofs"], w["generators"],
                               trace.peaks)
    return 100.0 * bound / seconds
