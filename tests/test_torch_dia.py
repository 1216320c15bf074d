"""K2 module parity: the port's DIA conversion and plain SpMV against the
JAX package (float64, and float32 against its Pallas kernel in interpret
mode) on a 40x40 macro system, and the ELL assembly forms."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hommx_tpu as hx
from hommx_tpu.ops import dia as jdia
from hommx_tpu.ops.assembly import apply_dirichlet as jax_apply_dirichlet
from hommx_tpu.ops.sparse import build_ell_pattern as jax_ell
from hommx_tpu.ops.sparse import spmv as jax_spmv
from hommx_tpu_torch.ops import dia as tdia
from hommx_tpu_torch.ops.assembly import (
    apply_dirichlet,
    assemble_ell,
    build_gather_assembly,
)
from hommx_tpu_torch.ops.solvers import solve_ell
from hommx_tpu_torch.ops.sparse import build_ell_pattern, ell_to_dense, spmv
from hommx_tpu_torch.utils.options import SolverOptions

torch.set_num_threads(1)


def _system(seed=0):
    """40x40 macro ELL pattern, DIA views of both packages, and seeded
    (symmetric-pattern) ELL values and a vector."""
    mesh = hx.create_unit_square(40)
    jp = jax_ell(mesh.cells, mesh.num_vertices)
    tp = build_ell_pattern(mesh.cells, mesh.num_vertices)
    rng = np.random.default_rng(seed)
    used = np.zeros(tp.cols.size, bool)
    used[np.unique(tp.slots)] = True
    vals = np.where(used, rng.standard_normal(tp.cols.size), 0.0)
    x = rng.standard_normal(tp.num_dofs)
    return jp, tp, jdia.build_dia_from_ell(jp), tdia.build_dia_from_ell(tp), vals, x


def test_dia_spmv_f64_matches_reference():
    jp, tp, jd, td, vals, x = _system()
    jv = jdia.ell_vals_to_dia(jd, jnp.asarray(vals))
    tv = tdia.ell_vals_to_dia(td, torch.as_tensor(vals))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    y_ref = np.asarray(jdia.dia_spmv(jv, jd.offsets, jnp.asarray(x)))
    y = tdia.dia_spmv(tv, td.offsets, torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(y, y_ref, rtol=0, atol=1e-13)
    # the DIA product is the ELL product
    y_ell = spmv(torch.as_tensor(vals), torch.as_tensor(tp.cols.astype(np.int64)), torch.as_tensor(x))
    np.testing.assert_allclose(y, y_ell.numpy(), rtol=0, atol=1e-12)
    # and the CPU dispatch of the kernel wrapper is the plain version
    assert torch.equal(tdia.dia_spmv_op(tv, td.offsets, torch.as_tensor(x)),
                       tdia.dia_spmv(tv, td.offsets, torch.as_tensor(x)))


def test_dia_spmv_f32_matches_pallas_kernel():
    """float32 against the TPU kernel (Pallas interpreter): relative 1e-5
    of max|y|, the kernel's bar in the reference."""
    jp, tp, jd, td, vals, x = _system(1)
    jv = jdia.ell_vals_to_dia(jd, jnp.asarray(vals, jnp.float32))
    y_pl = np.asarray(
        jdia.dia_spmv_pallas(jv, jd.offsets, jnp.asarray(x, jnp.float32), block=1024, interpret=True)
    )
    tv = tdia.ell_vals_to_dia(td, torch.as_tensor(vals, dtype=torch.float32))
    y = tdia.dia_spmv(tv, td.offsets, torch.as_tensor(x, dtype=torch.float32)).numpy()
    assert np.abs(y - y_pl).max() / np.abs(y_pl).max() < 1e-5


def test_gather_cols_and_dirichlet_match_reference():
    jp, tp, jd, td, vals, x = _system(2)
    rng = np.random.default_rng(3)
    mask = rng.uniform(size=tp.num_dofs) < 0.2
    bvals = np.where(mask, rng.standard_normal(tp.num_dofs), 0.0)
    row = rng.standard_normal(tp.num_dofs)
    np.testing.assert_array_equal(
        tdia.gather_cols(td, torch.as_tensor(row)).numpy(),
        np.asarray(jdia.gather_cols(jd, jnp.asarray(row))),
    )
    cols = torch.as_tensor(tp.cols.astype(np.int64))
    diag = torch.as_tensor(tp.diag_slots.astype(np.int64))
    for use_dia in (False, True):
        jv, jb = jax_apply_dirichlet(
            jnp.asarray(vals), jnp.asarray(jp.cols), jnp.asarray(jp.diag_slots),
            jnp.asarray(x), jnp.asarray(mask), jnp.asarray(bvals), dia=jd if use_dia else None,
        )
        tv, tb = apply_dirichlet(
            torch.as_tensor(vals), cols, diag, torch.as_tensor(x), torch.as_tensor(mask),
            torch.as_tensor(bvals), dia=td if use_dia else None,
        )
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=0, atol=1e-13)


@pytest.mark.parametrize("gather", [False, True])
def test_assemble_ell_scatter_and_gather(gather):
    """Both assembly forms sum the element blocks into the ELL values; the
    dense matrix equals a direct dense scatter of the blocks."""
    mesh = hx.create_unit_square(12)
    tp = build_ell_pattern(mesh.cells, mesh.num_vertices)
    rng = np.random.default_rng(4)
    S = rng.standard_normal((mesh.num_cells, 3, 3))
    table = torch.as_tensor(build_gather_assembly(tp)) if gather else None
    vals = assemble_ell(tp, torch.as_tensor(S), torch.as_tensor(tp.slots.astype(np.int64)), gather=table)
    dense = np.zeros((tp.num_dofs, tp.num_dofs))
    c = mesh.cells
    np.add.at(dense, (c[:, :, None], c[:, None, :]), S)
    got = ell_to_dense(vals, torch.as_tensor(tp.cols.astype(np.int64))).numpy()
    np.testing.assert_allclose(got, dense, rtol=0, atol=1e-13)
    y_ref = np.asarray(jax_spmv(jnp.asarray(vals.numpy()), jnp.asarray(tp.cols), jnp.ones(tp.num_dofs)))
    np.testing.assert_allclose(dense.sum(axis=1), y_ref, rtol=0, atol=1e-12)


def test_cuda_entry_refuses_cpu_tensors():
    """The kernel module imports and runs its CPU dispatch with no nvcc and
    no card; its CUDA entry raises on CPU tensors rather than falling back."""
    _, _, _, td, vals, x = _system(5)
    tv = tdia.ell_vals_to_dia(td, torch.as_tensor(vals, dtype=torch.float32))
    with pytest.raises(TypeError):
        tdia.dia_spmv_cuda(tv, td.offsets, torch.as_tensor(x, dtype=torch.float32))
    assert tdia.KERNEL._lib is None and tdia.KERNEL.launches == 0


def test_macro_cg_matvec_is_the_kernel_wrapper_at_every_size(monkeypatch):
    """The macro CG takes the DIA SpMV through the kernel's device dispatch
    whatever the system size (here N = 81, far below the reference's 4096
    gate), so a CUDA system always reaches the kernel; in float32 on the CPU
    it solves an SPD system to its rtol (residual checked, 1e-5)."""
    mesh = hx.create_unit_square(8)
    tp = build_ell_pattern(mesh.cells, mesh.num_vertices)
    td = tdia.build_dia_from_ell(tp)
    rng = np.random.default_rng(6)
    G = rng.standard_normal((mesh.num_cells, 3, 3))
    S = torch.as_tensor(G @ np.swapaxes(G, 1, 2), dtype=torch.float32)  # PSD blocks
    vals = assemble_ell(tp, S, torch.as_tensor(tp.slots.astype(np.int64)))
    vals[torch.as_tensor(tp.diag_slots.astype(np.int64))] += 1.0  # SPD
    cols = torch.as_tensor(tp.cols.astype(np.int64))
    b = torch.as_tensor(rng.standard_normal(tp.num_dofs), dtype=torch.float32)
    calls = []
    real = tdia.dia_spmv_op

    def spy(*args):
        calls.append(1)
        return real(*args)

    monkeypatch.setattr(tdia, "dia_spmv_op", spy)
    opts = SolverOptions(method="cg", pc="jacobi", rtol=1e-6, maxiter=500)
    x, iters, _ = solve_ell(vals, cols, b, opts, dia=td)
    assert tp.num_dofs == 81 and 0 < iters < 500
    assert len(calls) == iters + 1  # the initial residual and one per iteration
    r = b - spmv(vals, cols, x)
    assert float(torch.linalg.norm(r) / torch.linalg.norm(b)) < 1e-5
