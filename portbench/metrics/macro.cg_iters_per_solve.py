"""macro.cg_iters_per_solve: the macro CG's iterations (the program's counter
``step.macro_solve.iterations``) over the solves of the traced window;
nothing where the macro solve is direct."""


def read(trace):
    iters = trace.counters.get("macro_iterations") or []
    if not iters or not any(iters):
        return None
    return sum(iters) / len(iters)
