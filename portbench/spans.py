"""Device idle time inside the program's spans: the host intervals that
``hommx_tpu_torch`` records on the profiler's timeline (``hommx.step``,
``hommx.micro``, ``hommx.macro.solve``, ...; its ``utils/profiling.py``)
read against the device's kernels and copies of a :class:`~portbench.trace.Trace`."""

from __future__ import annotations

import bisect

__all__ = ["merged", "idle_seconds"]


def merged(intervals) -> list:
    """The union of ``(start, end)`` intervals as sorted disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def idle_seconds(trace, match):
    """Seconds of the traced window inside the host spans whose name
    ``match(name)`` accepts (their union, clipped to the window) in which
    no kernel and no copy ran on the device; None where the trace has no
    such span (a program without spans)."""
    t0, t1 = trace.span
    spans = merged((max(s, t0), min(e, t1)) for name, s, e in trace.host
                   if match(name) and e > t0 and s < t1)
    if not spans:
        return None
    busy = merged([(s, e) for _, s, e in trace.kernels] + [(s, e) for _, s, e in trace.copies])
    ends = [e for _, e in busy]
    idle = 0.0
    for a, b in spans:
        covered = 0.0
        for s, e in busy[bisect.bisect_right(ends, a):]:
            if s >= b:
                break
            covered += min(e, b) - max(s, a)
        idle += (b - a) - covered
    return idle
