"""K2 module parity: the port's DIA conversion, plain SpMV and prepared
operator against the JAX package (float64, and float32 against its Pallas
kernel in interpret mode) on a 40x40 macro system and a 3D P1 box with 15
diagonals, the ELL assembly forms, and the kernel's launch path."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hommx_tpu as hx
from hommx_tpu.ops import dia as jdia
from hommx_tpu.ops.assembly import apply_dirichlet as jax_apply_dirichlet
from hommx_tpu.ops.sparse import build_ell_pattern as jax_ell
from hommx_tpu.ops.sparse import spmv as jax_spmv
from hommx_tpu_torch import _cuda
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


def _system(seed=0, mesh=None):
    """40x40 macro ELL pattern (or that of ``mesh``), DIA views of both
    packages, and seeded (symmetric-pattern) ELL values and a vector."""
    mesh = hx.create_unit_square(40) if mesh is None else mesh
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


PATTERNS = {"square40": lambda: hx.create_unit_square(40), "box3d": lambda: hx.create_unit_cube(6)}


@pytest.mark.parametrize("pattern", sorted(PATTERNS))
def test_dia_operator_f64_matches_reference(pattern):
    """The prepared operator on the CPU (the plain product) equals JAX's
    dia_spmv at 1e-13 in float64: 7 diagonals in 2D, 15 on the 3D box."""
    jp, tp, jd, td, vals, x = _system(7, PATTERNS[pattern]())
    assert td.num_diagonals == (7 if pattern == "square40" else 15)
    jv = jdia.ell_vals_to_dia(jd, jnp.asarray(vals))
    y_ref = np.asarray(jdia.dia_spmv(jv, jd.offsets, jnp.asarray(x)))
    op = tdia.DIAOperator(tdia.ell_vals_to_dia(td, torch.as_tensor(vals)), td.offsets)
    assert op.N == tp.num_dofs and op.out.dtype == torch.float64
    np.testing.assert_allclose(op(torch.as_tensor(x)).numpy(), y_ref, rtol=0, atol=1e-13)


@pytest.mark.parametrize("pattern", sorted(PATTERNS))
def test_dia_operator_f32_matches_pallas_kernel(pattern):
    """The prepared operator in float32 against the TPU kernel (Pallas
    interpreter), relative 1e-5 of max|y|."""
    jp, tp, jd, td, vals, x = _system(8, PATTERNS[pattern]())
    jv = jdia.ell_vals_to_dia(jd, jnp.asarray(vals, jnp.float32))
    y_pl = np.asarray(
        jdia.dia_spmv_pallas(jv, jd.offsets, jnp.asarray(x, jnp.float32), block=1024, interpret=True)
    )
    op = tdia.DIAOperator(tdia.ell_vals_to_dia(td, torch.as_tensor(vals, dtype=torch.float32)),
                          td.offsets)
    y = op(torch.as_tensor(x, dtype=torch.float32)).numpy()
    assert np.abs(y - y_pl).max() / np.abs(y_pl).max() < 1e-5


def test_dia_operator_out_writes_into_buffer():
    """``out=`` receives the product and is returned; without it each call
    returns a new tensor; bad shapes raise at construction."""
    _, _, _, td, vals, x = _system(9)
    dv = tdia.ell_vals_to_dia(td, torch.as_tensor(vals))
    op = tdia.DIAOperator(dv, td.offsets)
    xt = torch.as_tensor(x)
    ref = tdia.dia_spmv(dv, td.offsets, xt)
    for out in (op.out, torch.full_like(xt, float("nan"))):
        got = op(xt, out=out)
        assert got is out
        assert torch.equal(out, ref)
    fresh = op(xt)
    assert fresh is not op.out and torch.equal(fresh, ref)
    with pytest.raises(ValueError):
        tdia.DIAOperator(dv[1:], td.offsets)


def test_dirichlet_lifting_does_not_run_the_plain_dia_product(monkeypatch):
    """The Dirichlet lifting takes the ELL product, so no system, on the
    card or off it, reaches K2's plain version outside the operator."""
    jp, tp, jd, td, vals, x = _system(10)
    mask = np.random.default_rng(11).uniform(size=tp.num_dofs) < 0.2

    def refuse(*args):
        raise AssertionError("the plain DIA product ran in the lifting")

    monkeypatch.setattr(tdia, "dia_spmv", refuse)
    tv, tb = apply_dirichlet(
        torch.as_tensor(vals), torch.as_tensor(tp.cols.astype(np.int64)),
        torch.as_tensor(tp.diag_slots.astype(np.int64)), torch.as_tensor(x),
        torch.as_tensor(mask), torch.as_tensor(np.where(mask, 1.0, 0.0)), dia=td,
    )
    jv, jb = jax_apply_dirichlet(
        jnp.asarray(vals), jnp.asarray(jp.cols), jnp.asarray(jp.diag_slots), jnp.asarray(x),
        jnp.asarray(mask), jnp.asarray(np.where(mask, 1.0, 0.0)), dia=jd,
    )
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=0, atol=1e-13)


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
    assert tdia.KERNEL._launchers == {}


def _spd_system(n=8, seed=6):
    """A float32 SPD macro system on an n x n mesh: ELL values, columns,
    right-hand side and the DIA pattern."""
    mesh = hx.create_unit_square(n)
    tp = build_ell_pattern(mesh.cells, mesh.num_vertices)
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((mesh.num_cells, 3, 3))
    S = torch.as_tensor(G @ np.swapaxes(G, 1, 2), dtype=torch.float32)  # PSD blocks
    vals = assemble_ell(tp, S, torch.as_tensor(tp.slots.astype(np.int64)))
    vals[torch.as_tensor(tp.diag_slots.astype(np.int64))] += 1.0  # SPD
    cols = torch.as_tensor(tp.cols.astype(np.int64))
    b = torch.as_tensor(rng.standard_normal(tp.num_dofs), dtype=torch.float32)
    return vals, cols, b, tdia.build_dia_from_ell(tp)


class _SpyOperator(tdia.DIAOperator):
    """DIAOperator that records its constructions and products."""

    made = []
    calls = []

    def __init__(self, *args):
        super().__init__(*args)
        self.made.append(self)

    def __call__(self, x, out=None):
        self.calls.append(out is self.out)
        return super().__call__(x, out=out)


@pytest.fixture
def spy_operator(monkeypatch):
    _SpyOperator.made, _SpyOperator.calls = [], []
    monkeypatch.setattr(tdia, "DIAOperator", _SpyOperator)
    return _SpyOperator


def test_macro_cg_matvec_is_the_kernel_wrapper_at_every_size(spy_operator):
    """The macro CG takes the DIA SpMV through the kernel's prepared
    operator, which dispatches by device alone, whatever the system size
    (here N = 81, far below the reference's 4096 gate), so a CUDA system
    always reaches the kernel; in float32 on the CPU it solves an SPD
    system to its rtol (residual checked, 1e-5)."""
    vals, cols, b, td = _spd_system()
    opts = SolverOptions(method="cg", pc="jacobi", rtol=1e-6, maxiter=500)
    x, iters, _ = solve_ell(vals, cols, b, opts, dia=td)
    assert td.num_dofs == 81 and 0 < iters < 500
    # the initial residual and one product per iteration, all into the buffer
    assert spy_operator.calls == [True] * (iters + 1)
    r = b - spmv(vals, cols, x)
    assert float(torch.linalg.norm(r) / torch.linalg.norm(b)) < 1e-5


def test_solve_ell_prepares_one_operator_per_solve(spy_operator):
    """Each CG solve makes its operator once and calls it iterations + 1
    times; the solution is the one the ELL gather CG reaches."""
    vals, cols, b, td = _spd_system(10, 12)
    opts = SolverOptions(method="cg", pc="jacobi", rtol=1e-6, maxiter=500)
    iters = []
    for rhs in (b, 2.0 * b):
        n_calls = len(spy_operator.calls)
        x, k, _ = solve_ell(vals, cols, rhs, opts, dia=td)
        assert len(spy_operator.calls) - n_calls == k + 1
        iters.append(k)
    assert len(spy_operator.made) == 2
    x_ell, k_ell, _ = solve_ell(vals, cols, 2.0 * b, opts)
    assert len(spy_operator.made) == 2  # the ELL path makes none
    assert abs(k_ell - iters[1]) <= 1
    assert float((x - x_ell).abs().max() / x_ell.abs().max()) < 1e-5


class _FakeLib:
    """Stands in for the built library: records each call, returns rc."""

    def __init__(self):
        self.calls, self.rc = [], 0

    def hommx_fake(self, *args):
        self.calls.append(args)
        return self.rc


def test_launcher_resolves_once_counts_and_raises(monkeypatch):
    """The launch path without a card: the function is looked up once, the
    current stream's raw handle goes last, the device context is entered
    only for another device, a launch counts only when its cudaError_t is
    0, and a refused launch raises."""
    kern = _cuda.CudaKernel(tdia.KERNEL.source, {})
    lib = kern._lib = _FakeLib()
    entered = []

    class _Device:
        def __init__(self, index):
            entered.append(index)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda d: 1000 + d, raising=False)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device", _Device)
    launch = kern.launcher("hommx_fake")
    assert kern.launcher("hommx_fake") is launch
    launch(0, 11, 12)
    kern.launch("hommx_fake", 1, 13)
    assert lib.calls == [(11, 12, 1000), (13, 1001)]
    assert entered == [1] and kern.launches == 2
    lib.rc = 700
    with pytest.raises(RuntimeError, match="cudaError_t 700"):
        launch(0, 14)
    assert kern.launches == 2
