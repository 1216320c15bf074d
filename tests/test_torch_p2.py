"""P2 (quadratic) elements in the port's single-scale FEM, mirroring
tests/test_p2.py case by case: each case runs the JAX package and the port
on the same mesh in this process, in float64, holds the port's result to
the reference's at 1e-10 where the case computes one, and keeps the
reference test's own check."""

import jax.numpy as jnp
import numpy as np
import torch

import hommx_tpu as hx
import hommx_tpu_torch as ht
from hommx_tpu.models.fem import fem_solve as jax_fem_solve
from hommx_tpu.ops.function_space import Function as JaxFunction
from hommx_tpu.ops.function_space import FunctionSpace as JaxFunctionSpace
from hommx_tpu.ops.function_space import boundary_dofs as jax_boundary_dofs
from hommx_tpu.utils.validation import l2_norm_space as jax_l2_norm_space
from hommx_tpu_torch.models.fem import fem_solve
from hommx_tpu_torch.ops.function_space import Function, FunctionSpace, boundary_dofs
from hommx_tpu_torch.utils.validation import l2_norm_space
from tests._torch_parity import port_mesh

torch.set_num_threads(1)

PI = np.pi


def _pair(jm, bs=1, degree=2):
    """(JAX space, port space) of one degree on the same mesh."""
    return JaxFunctionSpace(jm, bs, degree=degree), FunctionSpace(port_mesh(jm), bs, degree=degree)


def _rel(a, ref) -> float:
    a, ref = np.asarray(a), np.asarray(ref)
    return float(np.abs(a - ref).max() / max(np.abs(ref).max(), 1e-300))


def _interp_bcs(Vj, Vt, jfn, tfn):
    """Dirichlet data interpolated from the exact solution on both sides
    (the port's own Function.interpolate)."""
    gj = JaxFunction(Vj).interpolate(jfn)
    gt = Function(Vt, device="cpu").interpolate(tfn)
    return [hx.dirichletbc(gj, jax_boundary_dofs(Vj))], [ht.dirichletbc(gt, boundary_dofs(Vt))]


def _zero_bcs(Vj, Vt):
    return ([hx.dirichletbc(0.0, jax_boundary_dofs(Vj), Vj)],
            [ht.dirichletbc(0.0, boundary_dofs(Vt), Vt)])


def _hooke2(lib, mu, lam):
    eye = jnp.eye(2) if lib is jnp else torch.eye(2, dtype=torch.float64)
    return (lam * lib.einsum("ij,kl->ijkl", eye, eye)
            + mu * (lib.einsum("ik,jl->ijkl", eye, eye) + lib.einsum("il,jk->ijkl", eye, eye)))


def _sines(lib):
    f = lambda x: 2 * PI**2 * lib.sin(PI * x[0]) * lib.sin(PI * x[1])  # noqa: E731
    exact = lambda x: lib.sin(PI * x[0]) * lib.sin(PI * x[1])  # noqa: E731
    return f, exact


def test_p2_space_structure():
    """4x4 square: 25 vertices and 56 edges; the dofmap, the dof
    coordinates and the boundary nodes are the reference's."""
    Vj, Vt = _pair(hx.create_unit_square(4, 4))
    assert Vt.num_nodes == 25 + 56 and Vt.dofs_per_cell == 6
    assert Vt.tabulate_dof_coordinates().shape == (81, 2)
    np.testing.assert_array_equal(Vt.cell_nodes(), Vj.cell_nodes())
    np.testing.assert_array_equal(Vt.tabulate_dof_coordinates(), Vj.tabulate_dof_coordinates())
    np.testing.assert_array_equal(Vt.boundary_nodes(), Vj.boundary_nodes())


def test_p2_partition_of_unity_and_gradients():
    """p2_basis: a partition of unity, constant-gradient coefficient sums,
    both tables equal to the reference's to 1e-12."""
    from hommx_tpu.ops.p2 import p2_basis as jax_p2_basis
    from hommx_tpu_torch.ops.p2 import p2_basis

    rng = np.random.default_rng(0)
    for d in (2, 3):
        xi = rng.uniform(0, 0.3, (5, d))
        phi, dlam = p2_basis(torch.as_tensor(xi), d)
        phi_j, dlam_j = jax_p2_basis(jnp.asarray(xi), d)
        assert np.allclose(phi.numpy().sum(axis=1), 1.0, atol=1e-12)
        colsum = dlam.numpy().sum(axis=1)
        assert np.allclose(colsum, colsum[:, :1], atol=1e-12)
        assert np.abs(phi.numpy() - np.asarray(phi_j)).max() < 1e-12
        assert np.abs(dlam.numpy() - np.asarray(dlam_j)).max() < 1e-12


def test_p2_exactness_for_quadratics():
    """−Δu = −6 with u = 1 + x² + 2y²: nodally exact (L2 error < 1e-10), the
    reference's solution to 1e-10."""
    Vj, Vt = _pair(hx.create_unit_square(5, 5))
    exact = lambda x: 1 + x[0] ** 2 + 2 * x[1] ** 2  # noqa: E731
    bj, bt = _interp_bcs(Vj, Vt, exact, exact)
    ref = jax_fem_solve(Vj, lambda x: 1.0, lambda x: -6.0, bj)
    u = fem_solve(Vt, lambda x: 1.0, lambda x: -6.0, bt, device="cpu")
    assert l2_norm_space(u, exact=exact) < 1e-10
    assert _rel(u.array, ref.array) < 1e-10


def test_p2_convergence_third_order():
    """−Δu = 2π² sin sin: O(h³) in L² (rate > 2.7 from 8 to 16, the rate
    the reference's test checks), each solution and error the
    reference's to 1e-10."""
    (fj, ej), (ft, et) = _sines(jnp), _sines(torch)
    errs = []
    for n in (8, 16):
        Vj, Vt = _pair(hx.create_unit_square(n, n))
        bj, bt = _zero_bcs(Vj, Vt)
        ref = jax_fem_solve(Vj, lambda x: 1.0, fj, bj, quad_degree=4, rhs_degree=4)
        u = fem_solve(Vt, lambda x: 1.0, ft, bt, quad_degree=4, rhs_degree=4, device="cpu")
        assert _rel(u.array, ref.array) < 1e-10
        errs.append(l2_norm_space(u, exact=et))
        assert abs(errs[-1] - jax_l2_norm_space(ref, exact=ej)) <= 1e-10 * errs[-1]
    assert np.log2(errs[0] / errs[1]) > 2.7, errs


def test_p2_beats_p1_at_same_mesh():
    """At 8x8 the P2 L2 error is under a tenth of P1's; both solutions are
    the reference's to 1e-10."""
    (fj, _), (ft, et) = _sines(jnp), _sines(torch)
    jm = hx.create_unit_square(8, 8)
    out = {}
    for deg, kw in ((1, {}), (2, dict(quad_degree=4, rhs_degree=4))):
        Vj, Vt = _pair(jm, degree=deg)
        bj, bt = _zero_bcs(Vj, Vt)
        ref = jax_fem_solve(Vj, lambda x: 1.0, fj, bj, **kw)
        u = fem_solve(Vt, lambda x: 1.0, ft, bt, device="cpu", **kw)
        assert _rel(u.array, ref.array) < 1e-10
        out[deg] = l2_norm_space(u, exact=et)
    assert out[2] < out[1] / 10, out


def test_p2_3d():
    """3D P2 on the 3³ cube: u = |x|² exactly, the reference's to 1e-10."""
    Vj, Vt = _pair(hx.create_unit_cube(3))
    exact = lambda x: x[0] ** 2 + x[1] ** 2 + x[2] ** 2  # noqa: E731
    bj, bt = _interp_bcs(Vj, Vt, exact, exact)
    ref = jax_fem_solve(Vj, lambda x: 1.0, lambda x: -6.0, bj)
    u = fem_solve(Vt, lambda x: 1.0, lambda x: -6.0, bt, device="cpu")
    assert l2_norm_space(u, exact=exact) < 1e-9
    assert _rel(u.array, ref.array) < 1e-10


def test_p2_variable_coefficient():
    """−d/dx((1+x) d/dx sin πx): rate > 2.6 from 4 to 8, the reference's
    solutions to 1e-10."""
    def case(lib):
        exact = lambda x: lib.sin(PI * x[0])  # noqa: E731
        f = lambda x: (PI**2 * (1 + x[0]) * lib.sin(PI * x[0])  # noqa: E731
                       - PI * lib.cos(PI * x[0]))
        return exact, f

    (ej, fj), (et, ft) = case(jnp), case(torch)
    errs = []
    for n in (4, 8):
        Vj, Vt = _pair(hx.create_unit_square(n, n))
        bj, bt = _interp_bcs(Vj, Vt, ej, et)
        ref = jax_fem_solve(Vj, lambda x: 1.0 + x[0], fj, bj, quad_degree=4, rhs_degree=5)
        u = fem_solve(Vt, lambda x: 1.0 + x[0], ft, bt, quad_degree=4, rhs_degree=5,
                      device="cpu")
        assert _rel(u.array, ref.array) < 1e-10
        errs.append(l2_norm_space(u, exact=et))
    assert np.log2(errs[0] / errs[1]) > 2.6, errs


def test_p2_vector_elasticity_quadratic_exact():
    """Vector P2, u = (x², y²), constant Hooke (μ = λ = 1): exact, the
    reference's to 1e-10."""
    Vj, Vt = _pair(hx.create_unit_square(4, 4), bs=2)
    bj, bt = _interp_bcs(Vj, Vt, lambda x: jnp.array([x[0] ** 2, x[1] ** 2]),
                         lambda x: torch.stack([x[0] ** 2, x[1] ** 2]))
    fv = -(2 * 1.0 + 4 * 1.0)
    ref = jax_fem_solve(Vj, lambda x: _hooke2(jnp, 1.0, 1.0), lambda x: jnp.array([fv, fv]),
                        bj, quad_degree=4, rhs_degree=4)
    u = fem_solve(Vt, lambda x: _hooke2(torch, 1.0, 1.0),
                  lambda x: torch.tensor([fv, fv], dtype=torch.float64), bt,
                  quad_degree=4, rhs_degree=4, device="cpu")
    assert l2_norm_space(u, exact=lambda x: torch.stack([x[0] ** 2, x[1] ** 2])) < 1e-10
    assert _rel(u.array, ref.array) < 1e-10


def test_p2_point_eval_and_cross_mesh():
    """P2 point evaluation is exact for quadratics; P2 -> P1 and P1 -> P2
    cross-mesh interpolation as in the reference, each the reference's
    values to 1e-12."""
    from hommx_tpu.ops.interpolation import eval_p1 as jax_eval
    from hommx_tpu.ops.interpolation import interpolate_nonmatching as jax_nonmatching
    from hommx_tpu_torch.ops.interpolation import eval_p1, interpolate_nonmatching

    exact = lambda x: 1 + x[0] ** 2 + 2 * x[0] * x[1]  # noqa: E731
    V2j, V2t = _pair(hx.create_unit_square(6, 6))
    u2j = JaxFunction(V2j).interpolate(exact)
    u2t = Function(V2t, device="cpu").interpolate(exact)
    pts = np.random.default_rng(0).uniform(0.05, 0.95, (40, 2))
    vals = eval_p1(u2t, pts).numpy()
    assert np.abs(vals - np.array([exact(p) for p in pts])).max() < 1e-12
    assert np.abs(vals - np.asarray(jax_eval(u2j, pts))).max() < 1e-12

    V1j, V1t = _pair(hx.create_unit_square(9, 9), degree=1)
    g1 = interpolate_nonmatching(V1t, u2t)
    ref1 = np.array([exact(p) for p in V1t.tabulate_dof_coordinates()])
    assert np.abs(g1.array.numpy() - ref1).max() < 1e-12
    assert np.abs(g1.array.numpy() - np.asarray(jax_nonmatching(V1j, u2j).array)).max() < 1e-12

    u1j = JaxFunction(V1j).interpolate(exact)
    u1t = Function(V1t, device="cpu").interpolate(exact)
    V2bj, V2bt = _pair(hx.create_unit_square(7, 7))
    g2 = interpolate_nonmatching(V2bt, u1t)
    ref2 = eval_p1(u1t, V2bt.tabulate_dof_coordinates()).numpy()
    assert np.abs(g2.array.numpy() - ref2).max() < 1e-12
    assert np.abs(g2.array.numpy() - np.asarray(jax_nonmatching(V2bj, u1j).array)).max() < 1e-12


def test_p2_vector_beats_p1():
    """Clamped beam: the P2 tip displacement at 10x3 is closer to a fine P1
    reference (80x24) than P1's; the P2 solution is the reference's to
    1e-10 (the P1 FEM is held to it in tests/test_torch_fem.py)."""
    mu, lam = 1.0, 1.25

    def clamp_j(V):
        return [hx.dirichletbc(np.zeros(2), jax_boundary_dofs(V, lambda x: np.isclose(x[0], 0)),
                               V)]

    def clamp_t(V):
        return [ht.dirichletbc(np.zeros(2), boundary_dofs(V, lambda x: np.isclose(x[0], 0)), V)]

    tips = {}
    for name, n, deg, kw in (("p1", (10, 3), 1, {}), ("p2", (10, 3), 2, dict(quad_degree=4)),
                             ("fine", (80, 24), 1, {})):
        Vj, Vt = _pair(hx.create_rectangle([[0, 0], [1.0, 0.2]], list(n)), bs=2, degree=deg)
        u = fem_solve(Vt, lambda x: _hooke2(torch, mu, lam),
                      lambda x: torch.tensor([0.0, -0.01], dtype=torch.float64), clamp_t(Vt),
                      device="cpu", **kw)
        if deg == 2:
            ref = jax_fem_solve(Vj, lambda x: _hooke2(jnp, mu, lam),
                                lambda x: jnp.array([0.0, -0.01]), clamp_j(Vj), **kw)
            assert _rel(u.array, ref.array) < 1e-10
        tips[name] = float(u.array.reshape(-1, 2)[:, 1].min())
    assert abs(tips["p2"] - tips["fine"]) < abs(tips["p1"] - tips["fine"]) / 3, tips
