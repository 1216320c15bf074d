"""The frozen arithmetic of the yardstick against hand counts: K3's
operation and byte counts, the union of device intervals and the idle gaps,
TF32 rounding, the metric readers on a toy trace; and the import guard."""

from __future__ import annotations

import importlib.util
import subprocess
import sys

import pytest
import torch

from portbench.harness import ROOT
from portbench.reference.fem import tf32_round
from portbench.trace import Trace, gaps, union_seconds

PKG = ROOT / "portbench"


def _roofline(name):
    spec = importlib.util.spec_from_file_location(name, PKG / "roofline" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_k3_counts_by_hand():
    k3 = _roofline("chol_solve_large")
    # n³/3 + 6 n² s: 1536³/3 = 1,207,959,552 and 6·1536²·6 = 84,934,656
    assert k3.flops(1, 1536, 6) == pytest.approx(1_292_894_208, rel=1e-15)
    # 648³/3 = 90,699,264 and 6·648²·6 = 15,116,544
    assert k3.flops(1, 648, 6) == pytest.approx(105_815_808, rel=1e-15)
    # K (n²) and F, X (n·s each) in float32
    assert k3.bytes_moved(1, 1536, 6) == 4 * (1536**2 + 2 * 1536 * 6)
    peaks = {"float32_flop_per_s": 67e12, "hbm_byte_per_s": 3.35e12}
    # the beam's 4320 cells of 8³: 5.585e12 operations, 83.4 ms at the float32 peak
    assert k3.bound_seconds(4320, 1536, 6, peaks) == pytest.approx(4320 * 1_292_894_208 / 67e12)


def test_interval_union_and_gaps():
    assert union_seconds([]) == 0.0
    assert union_seconds([(0.0, 1.0), (2.0, 3.0)]) == pytest.approx(2.0)  # disjoint
    assert union_seconds([(0.0, 2.0), (1.0, 3.0)]) == pytest.approx(3.0)  # overlapping
    assert union_seconds([(0.0, 4.0), (1.0, 2.0)]) == pytest.approx(4.0)  # nested
    assert union_seconds([(2.0, 3.0), (0.0, 1.0), (1.0, 2.5)]) == pytest.approx(3.0)
    g = gaps([(1.0, 2.0), (2.5, 3.0), (1.5, 2.2)], 0.0, 4.0)
    assert g == [(0.0, 1.0), (3.0, 4.0), (2.2, 2.5)]


def test_tf32_rounding():
    x = torch.tensor([1.0, 1 + 2**-10, 1 + 2**-11, 1 + 3 * 2**-11, -(1 + 3 * 2**-12), 3.0e-5])
    r = tf32_round(x)
    assert r[0] == 1.0 and r[1] == 1 + 2**-10
    assert r[2] == 1.0  # a tie goes to the even neighbour
    assert r[3] == 1 + 2**-9  # a tie, up to the even neighbour
    assert r[4] == -(1 + 2**-10)
    assert abs(float(r[5]) / 3.0e-5 - 1) <= 2**-11
    assert torch.all(tf32_round(r) == r)


def _toy_trace():
    kernels = [("stencil_pcg_large_kernel<128, 8>", 0.0, 0.4),
               ("chol_solve_large_kernel", 0.5, 0.6), ("elementwise", 0.35, 0.45)]
    copies = [("Memcpy HtoD", 0.7, 0.8)]
    host = [("portbench.solve", 0.0, 1.0), ("aten::item", 0.85, 0.99)]
    work = {"cells": 4320, "cell_dofs": 1536, "generators": 6}
    return Trace(2, 1.0, kernels, copies, host, {"macro_iterations": [6, 6]}, work,
                 "NVIDIA H100 80GB HBM3", (0.0, 1.0))


def _reader(name):
    spec = importlib.util.spec_from_file_location(name, PKG / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_metric_readers_on_a_toy_trace():
    tr = _toy_trace()
    assert tr.busy_s == pytest.approx(0.45 + 0.1 + 0.1)
    assert _reader("device.idle_pct")(tr) == pytest.approx(35.0)
    assert _reader("device.kernels_per_solve")(tr) == pytest.approx(1.5)
    assert _reader("k1_large.ms_per_solve")(tr) == pytest.approx(200.0)
    assert _reader("macro.cg_iters_per_solve")(tr) == pytest.approx(6.0)
    bound = 2 * 4320 * 1_292_894_208 / 67e12
    assert _reader("k3_large.roofline_pct")(tr) == pytest.approx(100 * bound / 0.1)
    b = tr.breakdown()
    assert b["device_ops"][0][0].startswith("stencil_pcg_large_kernel")
    assert b["idle_gaps"][0] == ["aten::item", pytest.approx(0.2)]


def test_readers_find_nothing_to_read():
    empty = Trace(3, 1.0, [], [], [], {"macro_iterations": [0, 0, 0]}, {}, "cpu", (0.0, 1.0))
    for name in ("device.idle_pct", "device.kernels_per_solve", "k1_large.ms_per_solve",
                 "k3_large.roofline_pct", "macro.cg_iters_per_solve"):
        assert _reader(name)(empty) is None


_GUARD = """
import importlib.util, json, sys
from pathlib import Path
root = Path(sys.argv[1])
for name in {modules!r}:
    importlib.import_module(name)
for path in sorted((root / "portbench" / "metrics").glob("*.py")):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
for path in sorted((root / "portbench" / "configs").glob("*.json")):
    json.loads(path.read_text())
{extra}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _loaded(modules, extra=""):
    code = _GUARD.format(modules=modules, extra=extra)
    res = subprocess.run([sys.executable, "-c", code, str(ROOT)], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    import json

    return set(json.loads(res.stdout.strip().splitlines()[-1]))


def test_import_guard_harness():
    """The harness, its readers, the families with the program built, and
    the reference load neither JAX nor the JAX package."""
    extra = ("from portbench._tiny import tiny_cell\n"
             "from portbench.harness import run_cell\n"
             "run_cell(tiny_cell('poisson_cells64.sweep'), 5, 0.05, True, device='cpu')\n")
    top = _loaded(["portbench.run", "portbench.harness", "portbench.control", "portbench.check",
                   "portbench.trace", "portbench.families.poisson_hmm",
                   "portbench.families.elasticity_stratified_hmm",
                   "portbench.reference.poisson_hmm",
                   "portbench.reference.elasticity_stratified_hmm"], extra)
    assert "hommx_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "hommx_tpu"}


def test_import_guard_reference():
    """The plain reference loads nothing of the program either."""
    top = _loaded(["portbench.reference.poisson_hmm",
                   "portbench.reference.elasticity_stratified_hmm"])
    assert not top & {"jax", "jaxlib", "flax", "hommx_tpu", "hommx_tpu_torch"}
