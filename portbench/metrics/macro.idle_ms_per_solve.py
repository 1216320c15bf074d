"""macro.idle_ms_per_solve: device idle milliseconds inside the program's
macro stage (its spans ``hommx.macro.*``: the load vector and the macro
assembly, the CG with its stop-test reads or the dense solve) over the
solves completed in the traced window; nothing where the program records no
such span."""

from portbench.spans import idle_seconds


def read(trace):
    if trace.solves < 1:
        return None
    idle = idle_seconds(trace, lambda name: name.startswith("hommx.macro."))
    return None if idle is None else 1e3 * idle / trace.solves
