"""The reader of ``micro.syncs_per_solve`` on hand-built traces: blocking
runtime calls counted inside the window's ``hommx.micro`` spans, the
asynchronous ones and those outside the spans or the window not; nothing
without the span."""

from __future__ import annotations

import importlib.util

import pytest

from portbench.harness import ROOT
from portbench.trace import Trace


def _read(trace):
    path = ROOT / "portbench" / "metrics" / "micro.syncs_per_solve.py"
    spec = importlib.util.spec_from_file_location("micro_syncs_per_solve", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(trace)


def _trace(host, solves=2, span=(0.0, 1.0)):
    return Trace(solves, span[1] - span[0], [], [], list(host), {"macro_iterations": []}, {},
                 "NVIDIA H100 80GB HBM3", span)


def test_blocking_calls_inside_micro_spans():
    """Two solves in [0, 1], micro spans [0, 0.4] and [0.5, 0.8] (a chunk's
    spans nested inside), the macro stage between them, a micro span
    before the window."""
    host = [("hommx.micro", -0.5, -0.1), ("cudaStreamSynchronize", -0.3, -0.2),
            ("hommx.step", 0.0, 0.45), ("hommx.micro", 0.0, 0.4),
            ("hommx.micro.prepare", 0.05, 0.1), ("cudaStreamSynchronize", 0.06, 0.07),
            ("hommx.micro.astar", 0.3, 0.35), ("cudaMemcpy", 0.31, 0.32),
            ("cudaMemcpyAsync", 0.2, 0.21), ("cudaLaunchKernel", 0.21, 0.22),
            ("cudaLaunchKernelExC", 0.22, 0.23), ("aten::item", 0.25, 0.26),
            ("hommx.macro.solve", 0.4, 0.45), ("cudaStreamSynchronize", 0.41, 0.42),
            ("hommx.micro", 0.5, 0.8), ("cudaDeviceSynchronize", 0.55, 0.56),
            ("cudaEventSynchronize", 0.6, 0.61), ("cudaStreamSynchronize_ptsz", 0.7, 0.71),
            ("cudaMemcpy_v3020", 0.79, 0.85), ("cudaStreamSynchronize", 0.9, 0.95)]
    # inside: 0.06, 0.31 (blocking copy), 0.55, 0.6, 0.7, 0.79 -> 6 over 2 solves
    assert _read(_trace(host)) == pytest.approx(3.0)
    assert _read(_trace(host, solves=3)) == pytest.approx(2.0)


def test_no_blocking_call_reads_zero():
    host = [("hommx.micro", 0.0, 0.5), ("cudaMemcpyAsync", 0.1, 0.2),
            ("cudaLaunchKernel", 0.2, 0.3), ("cudaStreamSynchronize", 0.6, 0.7)]
    assert _read(_trace(host)) == 0.0


def test_nothing_to_read():
    """No ``hommx.micro`` span in the window (a program without spans), or
    no solve: nothing."""
    assert _read(_trace([("cudaStreamSynchronize", 0.1, 0.2)])) is None
    assert _read(_trace([("hommx.micro", -0.5, -0.1), ("cudaStreamSynchronize", -0.3, -0.2)])) \
        is None
    assert _read(_trace([("hommx.micro", 0.0, 0.5)], solves=0)) is None
