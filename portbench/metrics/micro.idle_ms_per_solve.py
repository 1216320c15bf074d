"""micro.idle_ms_per_solve: device idle milliseconds inside the program's
micro stage (its span ``hommx.micro``: the chunk glue and the cell solves'
launches) over the solves completed in the traced window; nothing where the
program records no such span."""

from portbench.spans import idle_seconds


def read(trace):
    if trace.solves < 1:
        return None
    idle = idle_seconds(trace, lambda name: name == "hommx.micro")
    return None if idle is None else 1e3 * idle / trace.solves
