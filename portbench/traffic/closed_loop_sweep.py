"""The ``closed_loop_sweep`` traffic kind: one client sends the next solve
when the last has returned.  Solve k writes θ_k into the 0-d parameter that
the configuration's coefficient closes over and runs the model's step over
every cell; the first ``warmup`` solves are the set-up's.

``order: cycles``: [low, high] is cut into ``cycle`` equal strata, and the
window's solves come in cycles that each take every stratum once, in an
order drawn from the seed, at a point ``jitter``·(r − ½) of a stratum's
width off its centre, r drawn from the seed for each cycle.  A solve's work
follows θ (the cells' contrast sets the micro solver's iterations, in
steps), so every seed sends the same work, in another order, up to the
last cycle that the window cuts off; no θ comes twice.  The warm-up solves
take θ uniform in [low, high].

A traffic file of this kind holds ``FIELDS`` and nothing else; its one
end-to-end metric of its own is ``solve_s``, the window over the solves
completed in it.
"""

from __future__ import annotations

__all__ = ["FIELDS", "params", "solve", "end_to_end"]

#: the keys a traffic file of this kind may hold, all of which it honours
FIELDS = frozenset({"kind", "low", "high", "order", "cycle", "jitter", "about"})


def params(traffic: dict, seed: int, count: int, device, warmup: int):
    """θ of solves 0..count-1 (the first ``warmup`` the set-up's), made on
    ``device`` from ``seed``."""
    import torch

    if traffic["order"] != "cycles":
        raise ValueError(f"closed_loop_sweep: unknown order {traffic['order']!r}")
    m, jitter = int(traffic["cycle"]), float(traffic["jitter"])
    if m < 2 or not 0.0 <= jitter < 1.0:
        raise ValueError(f"closed_loop_sweep: cycle {m} (2 or more), jitter {jitter} (in [0, 1))")
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    n = count - warmup
    cycles = -(-n // m)
    f64 = torch.float64
    strata = torch.argsort(torch.rand((cycles, m), generator=g, device=device, dtype=f64), dim=1)
    r = torch.rand((cycles, 1), generator=g, device=device, dtype=f64)
    u = torch.cat([torch.rand((warmup,), generator=g, device=device, dtype=f64),
                   ((strata + 0.5 + jitter * (r - 0.5)) / m).reshape(-1)[:n]])
    lo, hi = float(traffic["low"]), float(traffic["high"])
    return lo + (hi - lo) * u


def solve(system, theta, values, k: int):
    """Solve k: θ_k into ``theta``, then the step; its output u."""
    theta.copy_(values[k])
    return system.step(system.centers)


def end_to_end(window_s: float, solves: int) -> dict:
    """This kind's end-to-end values from the window's length and the
    solves completed in it."""
    return {"solve_s": window_s / solves}
