"""The readers of the program's spans and counter on hand-built traces:
``micro.idle_ms_per_solve`` and ``macro.idle_ms_per_solve`` (device idle
time inside the ``hommx.*`` host spans), ``k1_large.roofline_pct`` (K1's
logged per-block iterations against ``stencil_pcg_large_kernel``'s device
time) and its operation and byte counts by hand."""

from __future__ import annotations

import importlib.util
import sys
import types

import pytest
import torch

from portbench.harness import ROOT
from portbench.spans import idle_seconds, merged
from portbench.trace import Trace

PKG = ROOT / "portbench"
PEAKS = {"float32_flop_per_s": 67e12, "hbm_byte_per_s": 3.35e12}
K1_MODULE = "hommx_tpu_torch.micro.stencil_pcg"


def _load(folder, name):
    spec = importlib.util.spec_from_file_location(f"t_{name}", PKG / folder / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _trace(kernels, host, solves=2, span=(0.0, 1.0), copies=()):
    return Trace(solves, span[1] - span[0], list(kernels), list(copies), list(host),
                 {"macro_iterations": []}, {}, "NVIDIA H100 80GB HBM3", span)


def _spanned():
    """Two solves in [0, 1]: micro spans [0.0, 0.4] and [0.5, 0.8], macro
    spans [0.4, 0.5] (assemble) and [0.8, 0.95] (solve); a span before the
    window; kernels, a copy and an overlapping pair."""
    host = [("hommx.step", 0.0, 0.5), ("hommx.micro", 0.0, 0.4),
            ("hommx.micro.solve", 0.1, 0.2), ("hommx.macro.assemble", 0.4, 0.5),
            ("hommx.step", 0.5, 0.95), ("hommx.micro", 0.5, 0.8),
            ("hommx.macro.solve", 0.8, 0.95), ("hommx.micro", -0.5, -0.1),
            ("aten::copy_", 0.85, 0.9)]
    kernels = [("stencil_pcg_large_kernel", 0.05, 0.25), ("elementwise", 0.2, 0.3),
               ("elementwise", 0.45, 0.6), ("gemv", 0.82, 0.84)]
    copies = [("Memcpy DtoH", 0.7, 0.75)]
    return _trace(kernels, host, copies=copies)


def test_merged_intervals():
    assert merged([]) == []
    assert merged([(2.0, 3.0), (0.0, 1.0), (0.5, 1.5), (3.0, 4.0)]) == [(0.0, 1.5), (2.0, 4.0)]


def test_idle_inside_spans_by_hand():
    tr = _spanned()
    # micro [0, 0.4]: busy [0.05, 0.3] -> idle 0.15; [0.5, 0.8]: busy
    # [0.5, 0.6] and [0.7, 0.75] -> idle 0.15; the span before the window
    # is left out
    micro = idle_seconds(tr, lambda n: n == "hommx.micro")
    assert micro == pytest.approx(0.30)
    # macro [0.4, 0.5]: busy [0.45, 0.5] -> 0.05; [0.8, 0.95]: busy
    # [0.82, 0.84] -> 0.13
    macro = idle_seconds(tr, lambda n: n.startswith("hommx.macro."))
    assert macro == pytest.approx(0.18)
    assert _load("metrics", "micro.idle_ms_per_solve").read(tr) == pytest.approx(150.0)
    assert _load("metrics", "macro.idle_ms_per_solve").read(tr) == pytest.approx(90.0)
    # together no more than the window's idle time
    assert micro + macro <= tr.span[1] - tr.span[0] - tr.busy_s + 1e-12
    # the breakdown names the gaps by the program's innermost span
    names = [name for name, _ in tr.breakdown()["idle_gaps"]]
    assert names == ["hommx.macro.solve"] + ["hommx.micro"] * 4


def test_idle_readers_without_spans():
    """A program without spans (the parent of this benchmark's readers)
    gives nothing to read."""
    tr = _trace([("k", 0.0, 0.5)], [("aten::add", 0.0, 0.1)])
    assert idle_seconds(tr, lambda n: n == "hommx.micro") is None
    for name in ("micro.idle_ms_per_solve", "macro.idle_ms_per_solve"):
        assert _load("metrics", name).read(tr) is None
        assert _load("metrics", name).read(_trace([], [], solves=0)) is None


def test_k1_large_counts_by_hand():
    roof = _load("roofline", "stencil_pcg_large")
    n, s, K = 4, 2, 5
    # 5 cells in blocks of 2: 2, 2 and 1 real cells at 3, 1 and 2 iterations
    per_cell = {it: (it + 2) * 2 * n * n * s + (it + 1) * 2 * K * n * s for it in (1, 2, 3)}
    assert roof.flops(n, s, K, 5, 2, [3, 1, 2]) == 2 * per_cell[3] + 2 * per_cell[1] + per_cell[2]
    assert roof.bytes_moved(n, s, K, 5) == 4 * (K * n * 5 + 2 * n * s * 5 + n * n)
    # the 64² cell (n = 4096, s = 2, K = 9) at 10 iterations: 12 preconditioner
    # products of 2n²s and 11 stencil products of 2Kns, 807.1 MFLOP a cell
    assert roof.flops(4096, 2, 9, 1, 8, [10]) == 12 * 2 * 4096**2 * 2 + 11 * 2 * 9 * 4096 * 2
    assert roof.bound_seconds(67e12, 0.0, PEAKS) == pytest.approx(1.0)
    assert roof.bound_seconds(0.0, 3.35e12, PEAKS) == pytest.approx(1.0)


def _k1_log(monkeypatch, entries):
    mod = types.SimpleNamespace(BLOCK_ITERS=entries)
    monkeypatch.setitem(sys.modules, K1_MODULE, mod)
    return mod


def _entry(iters, cells, launcher="hommx_stencil_pcg_large_f32"):
    return {"launcher": launcher, "n": 4096, "s": 2, "K": 9, "cells": cells,
            "cells_per_block": 8, "iters": torch.tensor(iters, dtype=torch.int32)}


def test_k1_large_roofline_reader(monkeypatch):
    """Launch by launch bound over the kernel's device time; the small
    instance's entries are not counted; the list is drained."""
    read = _load("metrics", "k1_large.roofline_pct").read
    roof = _load("roofline", "stencil_pcg_large")
    entries = [_entry([10, 9], 12), _entry([7], 3, "hommx_stencil_pcg_f32"), _entry([8], 8)]
    mod = _k1_log(monkeypatch, entries)
    kernels = [("void stencil_pcg_large_kernel<128>(...)", 0.0, 0.02),
               ("void stencil_pcg_kernel<16>(...)", 0.02, 0.03),
               ("void stencil_pcg_large_kernel<128>(...)", 0.05, 0.06)]
    bound = sum(roof.bound_seconds(roof.flops(4096, 2, 9, c, 8, its),
                                   roof.bytes_moved(4096, 2, 9, c), PEAKS)
                for its, c in (([10, 9], 12), ([8], 8)))
    assert read(_trace(kernels, [])) == pytest.approx(100.0 * bound / 0.03)
    assert mod.BLOCK_ITERS == []
    assert 0 < 100.0 * bound / 0.03 <= 100


def test_k1_large_roofline_reader_finds_nothing(monkeypatch):
    read = _load("metrics", "k1_large.roofline_pct").read
    kernels = [("stencil_pcg_large_kernel", 0.0, 0.02)]
    monkeypatch.setitem(sys.modules, K1_MODULE, types.SimpleNamespace())
    assert read(_trace(kernels, [])) is None  # a program without the counter
    _k1_log(monkeypatch, [])
    assert read(_trace(kernels, [])) is None  # no launch logged
    mod = _k1_log(monkeypatch, [_entry([3], 8), _entry([3], 8)])
    assert read(_trace(kernels, [])) is None  # two launches logged, one traced
    assert mod.BLOCK_ITERS == []
    _k1_log(monkeypatch, [_entry([3], 8)])
    assert read(_trace([], [])) is None  # no kernel in the window
