"""Phase timers and a profiler trace (torch port of
``hommx_tpu/utils/profiling.py``).

``PhaseTimer`` accumulates wall-clock seconds per named phase.  ``trace``
wraps ``torch.profiler.profile`` (CPU activity, and CUDA activity where a
card is present) and writes a Chrome trace under ``dirname``, where the
reference writes a ``jax.profiler`` (xprof) trace.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Dict

logger = logging.getLogger("hommx_tpu_torch")

__all__ = ["PhaseTimer", "trace"]


class PhaseTimer:
    """Accumulates wall-clock per named phase; prints a summary table."""

    def __init__(self):
        self.totals: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] = self.totals.get(name, 0.0) + time.perf_counter() - t0

    def summary(self) -> str:
        total = sum(self.totals.values()) or 1.0
        lines = [
            f"  {name:<24s} {dt:8.3f}s  {100 * dt / total:5.1f}%"
            for name, dt in sorted(self.totals.items(), key=lambda kv: -kv[1])
        ]
        return "\n".join(lines)


@contextlib.contextmanager
def trace(dirname: str):
    """``torch.profiler`` trace context: yields the profiler, and on exit
    writes ``dirname/trace_<pid>_<ns>.json`` (Chrome trace format; view in
    Perfetto or chrome://tracing).  The profiler's ``key_averages()`` stay
    readable on the yielded object."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(dirname, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        path = os.path.join(dirname, f"trace_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        logger.info("profiler trace written to %s", path)
