"""Port parity, host side: meshes, periodic map, ELL/DIA patterns and the
micro engine's static operators equal the JAX package's arrays EXACTLY
(same inputs, same numpy code paths), and the port imports neither JAX
nor the JAX package."""

import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hommx_tpu as hx
import hommx_tpu_torch as ht
from hommx_tpu.micro.engine import MicroEngine as JaxEngine
from hommx_tpu.micro.periodic import build_periodic_map as jax_periodic_map
from hommx_tpu.ops.dia import build_dia_from_ell as jax_dia
from hommx_tpu.ops.sparse import build_ell_pattern as jax_ell
from hommx_tpu_torch.micro.periodic import build_periodic_map
from hommx_tpu_torch.ops.dia import build_dia_from_ell
from hommx_tpu_torch.ops.sparse import build_ell_pattern
from tests._torch_parity import port_mesh

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent

MESHES = {
    "square6": (lambda m: m.create_unit_square(6)),
    "rect5x7": (lambda m: m.create_rectangle([[0.0, 0.0], [1.0, 1.0]], [5, 7])),
    "cube3": (lambda m: m.create_unit_cube(3)),
}


@pytest.mark.parametrize("name", sorted(MESHES))
def test_mesh_periodic_map_and_patterns_equal(name):
    jm, tm = MESHES[name](hx), MESHES[name](ht)
    np.testing.assert_array_equal(tm.vertices, jm.vertices)
    np.testing.assert_array_equal(tm.cells, jm.cells)
    assert tm.structure.shape == jm.structure.shape
    assert tm.volume() == jm.volume()
    np.testing.assert_array_equal(tm.boundary_vertices(), jm.boundary_vertices())

    jp, tp = jax_periodic_map(jm), build_periodic_map(tm)
    np.testing.assert_array_equal(tp.masters, jp.masters)
    np.testing.assert_array_equal(tp.is_slave, jp.is_slave)
    np.testing.assert_array_equal(tp.reduced_index, jp.reduced_index)
    assert tp.n_reduced == jp.n_reduced

    je, te = jax_ell(jm.cells, jm.num_vertices), build_ell_pattern(tm.cells, tm.num_vertices)
    assert te.row_width == je.row_width
    np.testing.assert_array_equal(te.cols, je.cols)
    np.testing.assert_array_equal(te.slots, je.slots)
    np.testing.assert_array_equal(te.diag_slots, je.diag_slots)

    jd, td = jax_dia(je), build_dia_from_ell(te)
    assert td.offsets == jd.offsets
    np.testing.assert_array_equal(td.ell_to_dia, jd.ell_to_dia)
    np.testing.assert_array_equal(td.ell_off_index, jd.ell_off_index)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_micro_operators_and_stencil_equal(name):
    jm = MESHES[name](hx)
    je = JaxEngine(jm, dtype=jnp.float64, solver="pcg")
    te = ht.MicroEngine(port_mesh(jm), device="cpu")
    np.testing.assert_array_equal(te.Draw.numpy(), np.asarray(je.Draw))
    np.testing.assert_array_equal(te.loc2red.numpy(), np.asarray(je.loc2red))
    np.testing.assert_array_equal(te.D.numpy(), np.asarray(je.D))
    np.testing.assert_array_equal(te.pin_mask.numpy(), np.asarray(je.pin_mask))
    # quadrature points and weights are einsum sums of d+1 terms (torch vs
    # XLA summation order): equal to one ulp
    np.testing.assert_allclose(te.yq_dev.numpy(), np.asarray(je.yq_dev), rtol=1e-15, atol=0)
    np.testing.assert_allclose(te.wq_dev.numpy(), np.asarray(je.wq_dev), rtol=1e-15, atol=0)

    js, ts = je._get_stencil(), te._get_stencil()
    assert ts.shape == js.shape and ts.self_k == js.self_k
    np.testing.assert_array_equal(ts.offsets, js.offsets)
    np.testing.assert_array_equal(ts.pinned, js.pinned)
    np.testing.assert_array_equal(ts.Wd, js.Wd)
    np.testing.assert_array_equal(ts.WF, js.WF)
    np.testing.assert_array_equal(ts.teF, js.teF)
    for k in range(len(js.te)):
        np.testing.assert_array_equal(ts.te[k], js.te[k])
        np.testing.assert_array_equal(ts.gB[k], js.gB[k])

    # K0 = DᵀD is a matrix product (torch's CPU BLAS here, XLA's dot in the
    # reference), so its entries — and its inverse — agree to rounding, not
    # bitwise: 1e-13 relative to the largest entry
    for got, want in ((te._get_K0inv(), je._get_K0inv()), (te._get_K0diag(), je._get_K0diag())):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-13 * np.abs(want).max())


def test_port_imports_no_jax():
    """No module of the port imports jax or the JAX package, and importing
    the port (kernel modules included) loads neither and builds nothing."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|hommx_tpu)\b(?!_torch)", re.M)
    offenders = [
        str(p.relative_to(REPO))
        for p in (REPO / "hommx_tpu_torch").rglob("*.py")
        if pat.search(p.read_text())
    ]
    assert offenders == []
    code = (
        "import sys, hommx_tpu_torch, hommx_tpu_torch.micro.stencil_pcg as k1, "
        "hommx_tpu_torch.ops.dia as k2\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'hommx_tpu.')) "
        "or m == 'hommx_tpu' for m in sys.modules), sorted(sys.modules)\n"
        "assert k1.KERNEL._lib is None and k2.KERNEL._lib is None\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert res.returncode == 0, res.stderr


def test_dtype_policy_and_tf32_off():
    from hommx_tpu_torch.config import default_dtype

    assert default_dtype("cpu") == torch.float64
    assert default_dtype("cuda") == torch.float32
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
