"""The port's example scripts against the JAX examples on the CPU, in
float64 (``tests/test_torch_examples.py`` sets out how): the periodic cell
solves (``periodic_cell_load``), the elasticity examples
(``rotated_fibers``, ``high_res_micro``) and the unstructured macro mesh
(``unstructured``)."""

from pathlib import Path

import numpy as np
import torch

from hommx_tpu_torch.examples.diffusion import periodic_cell_load, unstructured
from hommx_tpu_torch.examples.linear_elasticity import high_res_micro, rotated_fibers
from tests.test_torch_examples import _last_number, _rel, _run_jax_example, _run_port, _wording

torch.set_num_threads(1)


def test_periodic_cell_load_matches_jax(monkeypatch, capsys, tmp_path):
    """The manufactured periodic Poisson errors on 8²–64² within 1e-8
    relative; the generator cell through grad_rhs reproduces the engine's
    corrector to below 1e-10 in both frameworks."""
    jax_out, seen = _run_jax_example(monkeypatch, capsys, tmp_path,
                                     "diffusion/periodic_cell_load.py", [], names=("err",))
    res, out = _run_port(capsys, periodic_cell_load.run)
    assert _wording(out) == _wording(jax_out)
    errs = [float(e) for e in seen["err"]]
    assert len(errs) == len(res["errors"]) == 4
    for a, b in zip(res["errors"], errs):
        assert _rel(a, b) < 1e-8
    assert res["delta"] < 1e-10 and _last_number(jax_out) < 1e-10


def test_rotated_fibers_quick_matches_jax(monkeypatch, capsys, tmp_path):
    """The 10x3x3 beam: max |u| and the tip deflection within 1e-6
    relative, and the warped PNG."""
    jax_out, seen = _run_jax_example(monkeypatch, capsys, tmp_path,
                                     "linear_elasticity/rotated_fibers.py", ["--quick"],
                                     names=("vals",))
    res, out = _run_port(capsys, rotated_fibers.run, quick=True, out=str(tmp_path))
    assert _wording(out) == _wording(jax_out)
    vals = np.asarray(seen["vals"][-1])
    assert _rel(res["max_u"], float(np.abs(vals).max())) < 1e-6
    assert _rel(res["tip"], float(vals[:, 2].min())) < 1e-6
    assert Path(res["pngs"][0]).read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_high_res_micro_matches_jax(monkeypatch, capsys, tmp_path):
    """``--n 8``: the loop (4, 8, 8) on the default route, A* of each step
    within 1e-8 relative (max norm)."""
    jax_out, seen = _run_jax_example(monkeypatch, capsys, tmp_path,
                                     "linear_elasticity/high_res_micro.py", ["--n", "8"],
                                     names=("A",))
    res, out = _run_port(capsys, high_res_micro.run, n=8)
    assert _wording(out) == _wording(jax_out)
    assert [r["n"] for r in res["rows"]] == [4, 8, 8]
    assert len(seen["A"]) == 3
    for row, A_ref in zip(res["rows"], seen["A"]):
        A_ref = np.asarray(A_ref)
        assert np.abs(np.asarray(row["A"]) - A_ref).max() / np.abs(A_ref).max() < 1e-8


def test_unstructured_matches_jax(monkeypatch, capsys, tmp_path):
    """``--n 24`` (625 dofs, the dense direct route): the distance to the
    structured solution at the jittered nodes within 1e-6 relative, under
    the example's bar of 5e-2."""
    jax_out, seen = _run_jax_example(monkeypatch, capsys, tmp_path,
                                     "diffusion/unstructured.py", ["--n", "24"],
                                     names=("rel", "its"))
    res, out = _run_port(capsys, unstructured.run, n=24)
    assert _wording(out) == _wording(jax_out)
    assert res["macro_iterations"] == seen["its"][-1] == 0
    assert _rel(res["rel"], seen["rel"][-1]) < 1e-6
    assert res["rel"] < 5e-2
