"""Phase timers, the program's spans and a profiler trace (torch port of
``hommx_tpu/utils/profiling.py``).

``span(name)`` marks a stretch of the program on the ``torch.profiler``
timeline, beside the host's operations and on the device trace's clock.
The solve step opens these (``models/hmm.py``, ``micro/chunk.py``,
``micro/krylov.py``, ``ops/solvers.py``, ``parallel/macro.py``):

    hommx.step                 a call of ``build_pipeline()``'s step
      hommx.micro              the micro stage (every chunk, every shard)
        hommx.micro.prepare    a chunk's coefficients, stencil weights or
                               Kc assembly, loads and scaling (on the
                               Cholesky route also the dense Ks)
        hommx.micro.solve      a chunk's cell solve (K1 or K3 with its
                               wrapper, or the plain PCG loop)
        hommx.micro.astar      a chunk's clamp, unscaling and A* contraction
      hommx.macro.assemble     the load vector and the macro system
      hommx.macro.solve        the macro CG (stop-test reads included) or
                               the dense direct solve

``solve()`` opens the same spans but ``hommx.step``, and a backward pass
opens ``hommx.micro.solve`` and ``hommx.macro.solve`` for its adjoint
solves.  A span is a host event of the profiler, never a user annotation:
the profiler mirrors annotations onto the device's timeline, where they
would read as device work.  With no profiler running a span is one check
of the profiler's state (well under a microsecond).

``PhaseTimer`` accumulates seconds per named phase, each phase also a
span; where CUDA is initialised it synchronises the current device at both
edges of a phase, so the seconds are the device's work and not only its
enqueue.  ``trace`` wraps ``torch.profiler.profile`` (CPU activity, and
CUDA activity where a card is present) and writes a Chrome trace under
``dirname``, where the reference writes a ``jax.profiler`` (xprof) trace.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Dict

import torch

logger = logging.getLogger("hommx_tpu_torch")

__all__ = ["PhaseTimer", "span", "trace"]

_RecordFunctionFast = getattr(torch._C._profiler, "_RecordFunctionFast", None)
_profiler_enabled = torch._C._autograd._profiler_enabled
#: the context a span is where no profiler records (or torch has no fast
#: record function)
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context that records ``name`` as a host event of a running
    ``torch.profiler`` session; without one, the shared no-op context."""
    if _RecordFunctionFast is None or not _profiler_enabled():
        return _NO_SPAN
    return _RecordFunctionFast(name)


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


class PhaseTimer:
    """Accumulates seconds per named phase; prints a summary table."""

    def __init__(self):
        self.totals: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        with span(name):
            _sync()
            t0 = time.perf_counter()
            try:
                yield
            finally:
                _sync()
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
