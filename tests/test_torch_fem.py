"""The single-scale P1 FEM through the port on the CPU, mirroring
tests/test_fem.py: each case runs the JAX package and the port on the same
mesh in this process, in float64, and holds the port to it at the
tolerance written in the case; plus LinearElasticityFEM, the golden ``fem``
at the goldens' RTOL, the 1D DIA offsets and multigrid hierarchy, and the
parts that raise."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hommx_tpu as hx
import hommx_tpu_torch as ht
from hommx_tpu.models.common import MacroSystem as JaxMacroSystem
from hommx_tpu.models.fem import fem_solve as jax_fem_solve
from hommx_tpu.ops.function_space import FunctionSpace as JaxFunctionSpace
from hommx_tpu.ops.function_space import boundary_dofs as jax_boundary_dofs
from hommx_tpu.utils import validation as jval
from hommx_tpu_torch.models.common import MacroSystem
from hommx_tpu_torch.models.fem import fem_solve
from hommx_tpu_torch.ops.function_space import boundary_dofs
from hommx_tpu_torch.utils import validation as tval
from tests._torch_parity import port_mesh
from tests.test_golden import GOLDEN, RTOL

torch.set_num_threads(1)


def _pair(jm, bs=1):
    """(JAX space, port space) on the same mesh."""
    return JaxFunctionSpace(jm, bs), ht.FunctionSpace(port_mesh(jm), bs)


def _zero_bcs(Vj, Vt):
    return ([hx.dirichletbc(0.0, jax_boundary_dofs(Vj), Vj)],
            [ht.dirichletbc(0.0, boundary_dofs(Vt), Vt)])


def _rel(a, ref) -> float:
    ref = np.asarray(ref)
    return float(np.abs(np.asarray(a) - ref).max() / np.abs(ref).max())


def test_poisson_manufactured_convergence():
    """-Δu = 2π² sin πx sin πy: O(h²) L² convergence, each level's error
    equal to the reference's."""
    jf = lambda x: 2 * jnp.pi**2 * jnp.sin(jnp.pi * x[0]) * jnp.sin(jnp.pi * x[1])
    tf = lambda x: 2 * torch.pi**2 * torch.sin(torch.pi * x[0]) * torch.sin(torch.pi * x[1])
    exact = lambda x: torch.sin(torch.pi * x[0]) * torch.sin(torch.pi * x[1])
    jexact = lambda x: jnp.sin(jnp.pi * x[0]) * jnp.sin(jnp.pi * x[1])
    errs = []
    for n in (8, 16, 32):
        jm = hx.create_unit_square(n, n)
        ref = hx.PoissonFEM(jm, lambda x: 1.0, jf).solve()
        tm = port_mesh(jm)
        u = ht.PoissonFEM(tm, lambda x: 1.0, tf, device="cpu").solve()
        assert u.array.dtype == torch.float64 and u.macro_method == "direct"
        assert _rel(u.array.numpy(), ref.array) < 1e-12
        errs.append(tval.calc_l2_norm(tm, u, exact=exact))
        assert errs[-1] == pytest.approx(jval.calc_l2_norm(jm, ref, exact=jexact), rel=1e-10)
    assert errs[1] / errs[0] < 0.3
    assert errs[2] / errs[1] < 0.3


def test_poisson_1d():
    """-u'' = 1 on 64 intervals, u(0) = u(1) = 0: u = x(1-x)/2 within 1e-4
    in L², and the reference's solution to 1e-12."""
    Vj, Vt = _pair(hx.create_interval(64))
    bj, bt = _zero_bcs(Vj, Vt)
    ref = jax_fem_solve(Vj, lambda x: 1.0, lambda x: 1.0, bj)
    u = fem_solve(Vt, lambda x: 1.0, lambda x: 1.0, bt, device="cpu")
    assert _rel(u.array.numpy(), ref.array) < 1e-12
    err = tval.calc_l2_norm(Vt.mesh, u, exact=lambda x: x[0] * (1 - x[0]) / 2)
    assert err < 1e-4


@pytest.mark.parametrize("dim", [1, 2])
def test_dia_offsets_and_multigrid_match_reference(dim):
    """The macro system's DIA offsets and slot map equal the reference's
    arrays; in 1D neither package builds a multigrid hierarchy (the direct
    solve takes every 1D system up to direct_threshold)."""
    jm = hx.create_interval(40) if dim == 1 else hx.create_unit_square(8)
    Vj, Vt = _pair(jm)
    jsys = JaxMacroSystem(Vj, jnp.float64)
    tsys = MacroSystem(Vt, torch.float64, "cpu")
    assert tsys.dia.offsets == tuple(jsys.dia.offsets)
    np.testing.assert_array_equal(tsys.dia.ell_to_dia, np.asarray(jsys.dia.ell_to_dia))
    if dim == 1:
        assert tsys.mg is None and jsys.mg is None
    else:
        assert [lev.grid for lev in tsys.mg.levels] == [lev.grid for lev in jsys.mg.levels]


def test_nonzero_dirichlet_lifting():
    """u = 1 + x² + y² on the boundary, A = 1, f = −4: the interpolant of
    the exact u to O(h²), and the reference's solution to 1e-12."""
    Vj, Vt = _pair(hx.create_unit_square(16, 16))
    gj = hx.Function(Vj).interpolate(lambda x: 1 + x[0] ** 2 + x[1] ** 2)
    gt = ht.Function(Vt, device="cpu").interpolate(lambda x: 1 + x[0] ** 2 + x[1] ** 2)
    ref = jax_fem_solve(Vj, lambda x: 1.0, lambda x: -4.0,
                        [hx.dirichletbc(gj, jax_boundary_dofs(Vj))])
    u = fem_solve(Vt, lambda x: 1.0, lambda x: -4.0, [ht.dirichletbc(gt, boundary_dofs(Vt))],
                  device="cpu")
    assert _rel(u.array.numpy(), ref.array) < 1e-12
    err = tval.calc_l2_norm(Vt.mesh, u, exact=lambda x: 1 + x[0] ** 2 + x[1] ** 2)
    assert err < 5e-3


@pytest.mark.parametrize("method", ["direct", "cg"])
def test_cg_matches_direct(method):
    """A = 1 + x: the direct solve and the multigrid CG to 1e-14 agree to
    1e-9, each with the reference's solution of the same method."""
    Vj, Vt = _pair(hx.create_unit_square(12, 12))
    bj, bt = _zero_bcs(Vj, Vt)
    kw = dict(method=method, atol=1e-14, rtol=1e-14) if method == "cg" else dict(method=method)
    ref = jax_fem_solve(Vj, lambda x: 1.0 + x[0], lambda x: jnp.sin(3 * x[0]) + x[1], bj,
                        hx.SolverOptions(**kw))
    u = fem_solve(Vt, lambda x: 1.0 + x[0], lambda x: torch.sin(3 * x[0]) + x[1], bt,
                  ht.SolverOptions(**kw), device="cpu")
    direct = fem_solve(Vt, lambda x: 1.0 + x[0], lambda x: torch.sin(3 * x[0]) + x[1], bt,
                       ht.SolverOptions(method="direct"), device="cpu")
    assert u.macro_method == method
    assert float((u.array - direct.array).abs().max()) < 1e-9
    assert _rel(u.array.numpy(), ref.array) < 1e-9
    if method == "cg":
        assert u.solver_iterations > 0


def test_matrix_coefficient_fem():
    """An anisotropic constant matrix coefficient: positive interior
    solution, the reference's to 1e-12."""
    Vj, Vt = _pair(hx.create_unit_square(10, 10))
    bj, bt = _zero_bcs(Vj, Vt)
    M = [[2.0, 0.5], [0.5, 1.0]]
    ref = jax_fem_solve(Vj, lambda x: jnp.array(M), lambda x: 1.0, bj)
    u = fem_solve(Vt, lambda x: torch.tensor(M, dtype=torch.float64), lambda x: 1.0, bt,
                  device="cpu")
    vals = u.array.numpy()
    interior = np.setdiff1d(np.arange(Vt.num_dofs), boundary_dofs(Vt))
    assert vals.max() > 0 and (vals[interior] > 0).all()
    assert _rel(vals, ref.array) < 1e-12


def test_linear_elasticity_fem_matches_reference():
    """LinearElasticityFEM with an x-dependent Hooke tensor on a clamped 2D
    strip: the reference's solution to 1e-12."""
    jm = hx.create_rectangle([[0.0, 0.0], [1.0, 0.25]], [8, 2])
    jA = jval.hooke_tensor(2, lambda x, y: 1.0 + x[0], lambda x, y: 0.5)
    tA = tval.hooke_tensor(2, lambda x, y: 1.0 + x[0], lambda x, y: 0.5)
    fj = hx.LinearElasticityFEM(jm, lambda x: jA(x, x), lambda x: jnp.array([0.0, -0.01]))
    ft = ht.LinearElasticityFEM(port_mesh(jm), lambda x: tA(x, x),
                                lambda x: torch.tensor([0.0, -0.01], dtype=torch.float64),
                                device="cpu")
    clamp = lambda x: np.isclose(x[0], 0)
    Vj, Vt = fj.function_space, ft.function_space
    fj.set_boundary_conditions(hx.dirichletbc(np.zeros(2), jax_boundary_dofs(Vj, clamp), Vj))
    ft.set_boundary_conditions(ht.dirichletbc(np.zeros(2), boundary_dofs(Vt, clamp), Vt))
    ref, u = fj.solve(), ft.solve()
    assert u.array.shape == (Vt.num_dofs,) and Vt.bs == 2
    assert _rel(u.array.numpy(), ref.array) < 1e-12


def test_golden_fem_f64():
    """The golden ``fem`` configuration (PoissonFEM, 32², A = 1 + ½ sin sin)
    through the port at the goldens' RTOL."""
    msh = ht.create_unit_square(32, 32)
    A = lambda x: 1.0 + 0.5 * torch.sin(2 * torch.pi * x[0]) * torch.sin(2 * torch.pi * x[1])
    u = ht.PoissonFEM(msh, A, lambda x: 1.0, device="cpu").solve()
    got = (tval.calc_l2_norm(msh, u), float(u.array.abs().max()))
    for g, w in zip(got, GOLDEN["fem"]):
        assert g == pytest.approx(w, rel=RTOL)


def test_fem_unported_parts_raise():
    """P2 spaces now run: PoissonFEM(degree=2) gives the reference's
    solution (1e-10) on a direct solve; a P2 system above
    ``direct_threshold`` has no geometric hierarchy, so its CG with
    pc='auto' takes Jacobi below the AMG bottom size, as the reference
    does (1e-9, the same iterations), and with pc='jacobi' runs.  Plotting
    now runs: before a solve it raises, after one it draws the solution."""
    jm = hx.create_unit_square(4)
    msh = port_mesh(jm)
    f = lambda x: 1.0 + x[0]  # noqa: E731
    u = ht.PoissonFEM(msh, lambda x: 1.0, f, degree=2, device="cpu").solve()
    ref = hx.PoissonFEM(jm, lambda x: 1.0, f, degree=2).solve()
    assert u.function_space.degree == 2 and u.macro_method == "direct"
    assert _rel(u.array.numpy(), ref.array) < 1e-10
    small = dict(method="auto", direct_threshold=16, rtol=1e-12)
    u_auto = ht.PoissonFEM(msh, lambda x: 1.0, f, ht.SolverOptions(**small), degree=2,
                           device="cpu").solve()
    ref_auto = hx.PoissonFEM(jm, lambda x: 1.0, f, hx.SolverOptions(**small), degree=2).solve()
    assert u_auto.macro_method == "cg" and u_auto.diagnostics["macro_amg_levels"] is None
    assert u_auto.solver_iterations == int(ref_auto.solver_iterations) > 0
    assert _rel(u_auto.array.numpy(), ref.array) < 1e-9
    jac = ht.SolverOptions(method="auto", direct_threshold=16, pc="jacobi", rtol=1e-12)
    u_cg = ht.PoissonFEM(msh, lambda x: 1.0, f, jac, degree=2, device="cpu").solve()
    assert u_cg.macro_method == "cg" and _rel(u_cg.array.numpy(), ref.array) < 1e-9
    fem = ht.PoissonFEM(msh, lambda x: 1.0, 1.0, device="cpu")
    with pytest.raises(RuntimeError, match="solve"):
        fem.plot_solution()
    fem.solve()
    fig = fem.plot_solution()
    assert len(fig.axes) == 2  # the contour plot and its colorbar
    import matplotlib.pyplot as plt

    plt.close(fig)
