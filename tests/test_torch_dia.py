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
    GatherPlan,
    apply_dirichlet,
    assemble_ell,
    build_gather_assembly,
)
from hommx_tpu_torch.ops import solvers
from hommx_tpu_torch.ops.solvers import _CHECK_EVERY, STOP_TEST, solve_ell
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


def test_dia_spmv_cols_matches_reference():
    """The multi-vector DIA product equals the reference's on a block of
    columns in float64, and each column is the single-vector product."""
    jp, tp, jd, td, vals, x = _system(13)
    X = np.random.default_rng(14).standard_normal((tp.num_dofs, 5))
    jv = jdia.ell_vals_to_dia(jd, jnp.asarray(vals))
    tv = tdia.ell_vals_to_dia(td, torch.as_tensor(vals))
    Y = tdia.dia_spmv_cols(tv, td.offsets, torch.as_tensor(X))
    Y_ref = np.asarray(jdia.dia_spmv_cols(jv, jd.offsets, jnp.asarray(X)))
    np.testing.assert_allclose(Y.numpy(), Y_ref, rtol=0, atol=1e-13)
    for j in range(X.shape[1]):
        assert torch.equal(Y[:, j], tdia.dia_spmv(tv, td.offsets, torch.as_tensor(X[:, j])))


def test_dia_operator_f64_on_cpu_is_the_plain_path(monkeypatch):
    """A float64 operator on the CPU runs the plain product and never
    reaches the kernel's launcher (no build, no launch)."""
    _, _, _, td, vals, x = _system(15)

    def refuse(name):
        raise AssertionError(f"the CPU operator asked for the launcher {name}")

    monkeypatch.setattr(tdia.KERNEL, "launcher", refuse)
    tv = tdia.ell_vals_to_dia(td, torch.as_tensor(vals))
    op = tdia.DIAOperator(tv, td.offsets)
    xt = torch.as_tensor(x)
    assert op.dtype == torch.float64 and op._launch is None
    assert torch.equal(op(xt, out=op.out), tdia.dia_spmv(tv, td.offsets, xt))
    assert tdia.KERNEL._lib is None and tdia.KERNEL.launches == 0


@pytest.mark.cuda
def test_dia_operator_cuda_dispatch_by_dtype():
    """On the card each dtype launches its own instance of the kernel and
    matches the plain version (float64 to 1e-12 of max|y|); float16 raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the DIA kernel runs only there")
    _, _, _, td, vals, x = _system(16)
    for dtype, name, tol in ((torch.float32, "hommx_dia_spmv_f32", 1e-5),
                             (torch.float64, "hommx_dia_spmv_f64", 1e-12)):
        tv = tdia.ell_vals_to_dia(td, torch.as_tensor(vals, dtype=dtype, device="cuda"))
        xt = torch.as_tensor(x, dtype=dtype, device="cuda")
        before = tdia.KERNEL.counts[name]
        y = tdia.DIAOperator(tv, td.offsets)(xt)
        assert tdia.KERNEL.counts[name] == before + 1
        y_p = tdia.dia_spmv(tv, td.offsets, xt)
        assert float((y - y_p).abs().max() / y_p.abs().max()) < tol
    with pytest.raises(TypeError):
        tdia.DIAOperator(tv.half(), td.offsets)


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
    table = GatherPlan(build_gather_assembly(tp), tp.slots.size) if gather else None
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
    steps0 = STOP_TEST.steps
    x, iters, _ = solve_ell(vals, cols, b, opts, dia=td)
    steps = STOP_TEST.steps - steps0
    assert td.num_dofs == 81 and 0 < iters < 500
    # the initial residual and one product per loop step (the iterations
    # and the frozen steps before the host's next check), all into the buffer
    assert spy_operator.calls == [True] * (steps + 1)
    assert iters <= steps < iters + _CHECK_EVERY
    r = b - spmv(vals, cols, x)
    assert float(torch.linalg.norm(r) / torch.linalg.norm(b)) < 1e-5


def test_solve_ell_prepares_one_operator_per_solve(spy_operator):
    """Each CG solve makes its operator once and calls it steps + 1 times
    (iterations + 1 when the host checks every step); the solution is the
    one the ELL gather CG reaches."""
    vals, cols, b, td = _spd_system(10, 12)
    opts = SolverOptions(method="cg", pc="jacobi", rtol=1e-6, maxiter=500)
    iters = []
    for rhs, every in ((b, _CHECK_EVERY), (2.0 * b, 1)):
        n_calls, steps0 = len(spy_operator.calls), STOP_TEST.steps
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(solvers, "_CHECK_EVERY", every)
            x, k, _ = solve_ell(vals, cols, rhs, opts, dia=td)
        assert len(spy_operator.calls) - n_calls == STOP_TEST.steps - steps0 + 1
        if every == 1:
            assert STOP_TEST.steps - steps0 == k
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

    hommx_fake_f64 = hommx_fake


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


def test_launch_counts_per_instance(monkeypatch):
    """Each launcher name of one source keeps its own count beside the
    total; ``reset_counts`` zeroes both; the DIA kernel declares one
    instance per dtype."""
    assert set(tdia.KERNEL.counts) == {"hommx_dia_spmv_f32", "hommx_dia_spmv_f64"}
    assert tdia.LAUNCHERS == {torch.float32: "hommx_dia_spmv_f32",
                              torch.float64: "hommx_dia_spmv_f64"}
    kern = _cuda.CudaKernel(tdia.KERNEL.source, {"hommx_fake": [], "hommx_fake_f64": []})
    kern._lib = _FakeLib()
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda d: 7, raising=False)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    for name, n in (("hommx_fake", 2), ("hommx_fake_f64", 3)):
        for _ in range(n):
            kern.launch(name, 0)
    assert kern.counts == {"hommx_fake": 2, "hommx_fake_f64": 3} and kern.launches == 5
    kern.reset_counts()
    assert kern.counts == {"hommx_fake": 0, "hommx_fake_f64": 0} and kern.launches == 0


@pytest.mark.parametrize("case", ["uniform", "ragged", "empty_targets"])
def test_gather_plan_sums_like_the_scatter(case):
    """invert_scatter and GatherPlan: the fixed-order gather sum equals
    index_add_ on a map where every target has the same number of
    contributors, on a ragged one, and on one with targets that none
    reaches (they sum to 0)."""
    from hommx_tpu_torch.ops.assembly import GatherPlan, gather_sum, invert_scatter

    rng = np.random.default_rng(12)
    if case == "uniform":
        targets = np.repeat(np.arange(40), 3)[rng.permutation(120)]
        T = 40
    elif case == "ragged":
        targets, T = rng.integers(0, 30, 200), 30
    else:
        targets, T = rng.integers(0, 25, 60) * 2, 50
    src = torch.as_tensor(rng.standard_normal((3, targets.size)))
    table = invert_scatter(targets, T)
    assert table.shape[0] == T and (table[table < targets.size] >= 0).all()
    got = gather_sum(src, GatherPlan(table, targets.size))
    ref = torch.zeros((3, T), dtype=src.dtype).index_add_(1, torch.as_tensor(targets), src)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-13)
    assert invert_scatter(targets, T, max_mult=1) is None
