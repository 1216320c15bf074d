"""Differentiation through the port on the CPU, mirroring
tests/test_differentiable_pipeline.py: each case runs the JAX package and
the port in this process, in float64, and holds the port's derivatives to
the reference's and to central differences of its own forward, at the
tolerance written in the case.

The port's solves carry the implicit-function rule
(ops/solvers.py::implicit_linear_solve): the forward solve runs with
grad mode off, exactly as a kernel launch returns a tensor with no
history.  The opaque-solve cases make that explicit by detaching the raw
solve's output; without the rule their second derivatives would miss by
about 1%, which the controls (``implicit_diff=False``) show.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hommx_tpu as hx
import hommx_tpu_torch as ht
from hommx_tpu.micro.engine import MicroEngine as JaxEngine
from hommx_tpu.models.fem import fem_solve_fn as jax_fem_solve_fn
from hommx_tpu.ops.function_space import FunctionSpace as JaxFunctionSpace
from hommx_tpu.ops.function_space import boundary_dofs as jax_boundary_dofs
from hommx_tpu.utils import validation as jval
from hommx_tpu.utils.options import SolverOptions as JaxOptions
from hommx_tpu_torch.micro import chunk
from hommx_tpu_torch.micro.krylov import _solve_linear
from hommx_tpu_torch.ops import solvers
from hommx_tpu_torch.ops.function_space import boundary_dofs
from hommx_tpu_torch.utils import validation as tval
from tests._torch_parity import port_mesh
from tests.test_torch_elasticity import jax_fibre, jax_rotation, torch_fibre, torch_rotation

torch.set_num_threads(1)

F64 = torch.float64
OPTIONS = {
    "cg-mg": dict(method="cg", pc="mg", rtol=1e-12, atol=0.0),
    "cg-jacobi": dict(method="cg", pc="jacobi", rtol=1e-12, atol=0.0),
    "direct": dict(method="direct"),
}


def _t(v):
    return torch.tensor(float(v), dtype=F64, requires_grad=True)


def _grad(loss, theta, order=1):
    """d^order loss / dθ^order at θ by autograd (create_graph for order 2)."""
    th = _t(theta)
    (g,) = torch.autograd.grad(loss(th), th, create_graph=order > 1)
    if order > 1:
        (g,) = torch.autograd.grad(g, th)
    return float(g)


def _central(f, x, h):
    return (f(x + h) - f(x - h)) / (2 * h)


def _value(loss, theta):
    with torch.no_grad():
        return float(loss(torch.tensor(float(theta), dtype=F64)))


def _close(a, b, rtol):
    assert abs(a - b) < rtol * max(1.0, abs(b)), (a, b)


# -- the HMM pipeline ---------------------------------------------------------


def _port_model(theta, options=None, **kw):
    A = lambda x, y: 1.1 + theta * x[0] + 0.5 * torch.sin(2 * torch.pi * y[0])
    return ht.PoissonHMM(ht.create_unit_square(8, 8), A, lambda x: 1.0,
                         ht.create_unit_square(6, 6), 2**-4, options_global_solve=options,
                         device="cpu", **kw)


def _port_loss(options=None):
    def loss(theta):
        step, centers = _port_model(theta, ht.SolverOptions(**options) if options else None
                                    ).build_pipeline()
        return (step(centers) ** 2).sum()

    return loss


def _jax_loss(options):
    def loss(theta):
        A = lambda x, y: 1.1 + theta * x[0] + 0.5 * jnp.sin(2 * jnp.pi * y[0])
        hmm = hx.PoissonHMM(hx.create_unit_square(8, 8), A, lambda x: 1.0,
                            hx.create_unit_square(6, 6), 2**-4,
                            options_global_solve=JaxOptions(**options))
        step, centers = hmm.build_pipeline()
        return jnp.sum(step(centers) ** 2)

    return loss


@functools.lru_cache(maxsize=None)
def _jax_derivative(name, order):
    """The JAX package's d^order J/dθ^order at θ = 1 on the ``name`` path
    (second derivatives: the direct path only; the reference's adjoint CG
    is a while_loop, which JAX cannot differentiate in reverse)."""
    fn = _jax_loss(OPTIONS[name])
    for _ in range(order):
        fn = jax.grad(fn)
    return float(fn(1.0))


@pytest.mark.parametrize("name", list(OPTIONS))
def test_grad_through_full_pipeline(name):
    """dJ/dθ through the micro solves, the assembly and the macro solve, on
    every macro path (the CG ones run the implicit rule around the CG),
    against the JAX package at 1e-7 and a central difference at 1e-5."""
    loss = _port_loss(OPTIONS[name])
    g = _grad(loss, 1.0)
    g_ref = _jax_derivative(name, 1)
    fd = _central(lambda t: _value(loss, t), 1.0, 1e-5)
    assert np.isfinite(g)
    _close(g, g_ref, 1e-7)
    _close(g, fd, 1e-5)


def test_pipeline_matches_solve_and_reference():
    """step(centers) is solve() with dedup off (the same operations: 1e-12)
    and the reference's step(centers) (1e-8); a shard_mesh that is not a
    ShardMesh is a TypeError, an unknown shard_mode a ValueError, and the
    pipeline on two CPU shards equals the unsharded one (1e-12)."""
    hmm = _port_model(1.0, dedup_cells=False)
    step, centers = hmm.build_pipeline()
    u = step(centers)
    u_solve = hmm.solve().array
    assert u.dtype == F64 and u.shape == u_solve.shape
    assert float((u - u_solve).abs().max()) <= 1e-12 * float(u_solve.abs().max())
    A = lambda x, y: 1.1 + x[0] + 0.5 * jnp.sin(2 * jnp.pi * y[0])
    jstep, jcenters = hx.PoissonHMM(hx.create_unit_square(8, 8), A, lambda x: 1.0,
                                    hx.create_unit_square(6, 6), 2**-4).build_pipeline()
    np.testing.assert_allclose(centers.numpy(), np.asarray(jcenters), rtol=0, atol=1e-15)
    ref = np.asarray(jstep(jcenters))
    assert np.abs(u.numpy() - ref).max() / np.abs(ref).max() < 1e-8
    with pytest.raises(TypeError, match="ShardMesh"):
        hmm.build_pipeline(shard_mesh=object())
    for mode in ("auto", "shard_map"):
        step2, _ = hmm.build_pipeline(shard_mesh=ht.ShardMesh(["cpu"] * 2), shard_mode=mode)
        assert float((step2(centers) - u).abs().max()) <= 1e-12 * float(u.abs().max())
    with pytest.raises(ValueError, match="shard_mode"):
        hmm.build_pipeline(shard_mode="pmap")


def test_second_derivative_through_full_pipeline():
    """d²J/dθ² through every solve twice: against the JAX package's
    jax.grad(jax.grad(J)) at 1e-6 and a central difference of the port's
    own first derivative at 1e-4."""
    loss = _port_loss(OPTIONS["direct"])
    h2 = _grad(loss, 1.0, order=2)
    h2_ref = _jax_derivative("direct", 2)
    fd2 = _central(lambda t: _grad(loss, t), 1.0, 1e-4)
    assert np.isfinite(h2)
    _close(h2, h2_ref, 1e-6)
    _close(h2, fd2, 1e-4)


def _detached(fn):
    """``fn`` whose tensor outputs come back with no history, as a ctypes
    kernel launch returns them."""

    def wrapped(*a, **k):
        out = fn(*a, **k)
        if isinstance(out, tuple):
            return tuple(o.detach() if torch.is_tensor(o) else o for o in out)
        return out.detach()

    return wrapped


def test_opaque_macro_cg_second_derivative(monkeypatch):
    """The macro CG made opaque (its output detached) leaves d²J/dθ²
    through the cg-mg pipeline where it was (1e-8): the implicit rule, not
    autograd through the loop, carries the macro solve's derivatives.  The
    value is the reference's direct-path one (1e-6): the reference has no
    second derivative through its CG."""
    loss = _port_loss(OPTIONS["cg-mg"])
    ref = _grad(loss, 1.0, order=2)
    monkeypatch.setattr(solvers, "solve_ell", _detached(solvers.solve_ell))
    got = _grad(loss, 1.0, order=2)
    _close(got, ref, 1e-8)
    _close(got, _jax_derivative("direct", 2), 1e-6)


def test_implicit_linear_solve_matches_autograd():
    """The rule in isolation on a dense SPD system A(θ) X = F(θ) whose raw
    solve is opaque (no_grad): first and second derivatives equal those of
    autograd through torch.linalg.solve (1e-12), and a mixed one through
    both the operator and the loads."""
    M = torch.as_tensor(np.random.default_rng(5).standard_normal((6, 6)))
    B = torch.as_tensor(np.random.default_rng(6).standard_normal((6, 2)))

    def parts(th):
        A = M @ M.T + 6.0 * torch.eye(6, dtype=F64) + th * torch.diag(torch.arange(6.0))
        return A + th**2 * torch.ones(6, 6, dtype=F64), B * torch.cos(th)

    def implicit(th):
        A, F = parts(th)
        X = solvers.implicit_linear_solve(lambda p, v: p[0] @ v, (A,), F,
                                          lambda p, G: torch.linalg.solve(p[0], G))
        return (X**3).sum()

    def unrolled(th):
        A, F = parts(th)
        return (torch.linalg.solve(A, F) ** 3).sum()

    for order in (1, 2):
        _close(_grad(implicit, 0.3, order), _grad(unrolled, 0.3, order), 1e-12)


# -- the micro routes ---------------------------------------------------------


def _scalar_engines():
    jm = hx.create_unit_square(8, 8)
    centers = np.random.default_rng(0).uniform(0, 1, (5, 2))
    te = ht.MicroEngine(port_mesh(jm), device="cpu", solver="pcg", pcg_tol=1e-13)
    return jm, te, centers


def _scalar_micro_loss(te, centers, **kw):
    c = torch.as_tensor(centers)

    def loss(theta):
        A = lambda x, y: 1.1 + theta * x[0] + 0.5 * torch.sin(2 * torch.pi * y[0])
        return (te.tensors_for_centers(A, c, **kw) ** 2).sum()

    return loss


def _jax_scalar_micro_loss(jm, centers, solver, **kw):
    eng = JaxEngine(jm, bs=1, coeff_kind="scalar", dtype=jnp.float64, solver=solver,
                    pcg_tol=1e-13, **kw)

    def loss(theta):
        A = lambda x, y: 1.1 + theta * x[0] + 0.5 * jnp.sin(2 * jnp.pi * y[0])
        return jnp.sum(eng.tensors_for_centers(A, jnp.asarray(centers)) ** 2)

    return loss


def test_grad_through_micro_chunk_pcg():
    """The stencil chunk-PCG route (K1's plain version under the implicit
    rule) against the reference's exact Cholesky route at 1e-7, and a
    central difference at 1e-5."""
    jm, te, centers = _scalar_engines()
    loss = _scalar_micro_loss(te, centers)
    g = _grad(loss, 1.0)
    g_cho = float(jax.grad(_jax_scalar_micro_loss(jm, centers, "cholesky"))(1.0))
    _close(g, g_cho, 1e-7)
    _close(g, _central(lambda t: _value(loss, t), 1.0, 1e-6), 1e-5)


def test_opaque_k1_route_second_derivative(monkeypatch):
    """K1's route with its raw solve detached: d²J/dθ² unchanged (1e-8) and
    equal to the reference's Cholesky route's (1e-6).  The control without
    the rule (``implicit_diff=False``: the solve carries no gradient) keeps
    the first derivative, which A*'s stationarity protects, and misses the
    second by more than 0.5%."""
    jm, te, centers = _scalar_engines()
    loss = _scalar_micro_loss(te, centers)
    ref = _grad(loss, 1.0, order=2)
    monkeypatch.setattr(chunk, "stencil_pcg", _detached(chunk.stencil_pcg))
    got = _grad(loss, 1.0, order=2)
    _close(got, ref, 1e-8)
    jloss = _jax_scalar_micro_loss(jm, centers, "cholesky")
    _close(got, float(jax.grad(jax.grad(jloss))(1.0)), 1e-6)
    control = _scalar_micro_loss(te, centers, implicit_diff=False)
    _close(_grad(control, 1.0), _grad(loss, 1.0), 1e-8)
    assert abs(_grad(control, 1.0, order=2) - got) > 5e-3 * abs(got)


def test_shard_map_without_mesh_keeps_gradient(monkeypatch):
    """Without a mesh, shard_mode='shard_map' is the unsharded pipeline, as
    in the reference: the cell solves keep their implicit rule.  With the
    micro solves detached (as a kernel launch returns them), d²J/dθ²
    equals the 'auto' mode's (1e-8); without the rule it would miss by
    more than 0.5% (test_opaque_k1_route_second_derivative's control)."""

    def loss(mode):
        def J(theta):
            step, centers = _port_model(theta).build_pipeline(shard_mode=mode)
            return (step(centers) ** 2).sum()

        return J

    monkeypatch.setattr(chunk, "stencil_pcg", _detached(chunk.stencil_pcg))
    monkeypatch.setattr(chunk, "fused_chol_solve", _detached(chunk.fused_chol_solve))
    _close(_grad(loss("shard_map"), 1.0, order=2), _grad(loss("auto"), 1.0, order=2), 1e-8)


def test_correctors_gradient():
    """A gradient through the correctors X themselves (``with_correctors``),
    where A*'s stationarity does not help: the implicit rule against a
    central difference at 1e-6."""
    _, te, centers = _scalar_engines()
    c = torch.as_tensor(centers)

    def loss(theta):
        A = lambda x, y: 1.1 + theta * x[0] + 0.5 * torch.sin(2 * torch.pi * y[0])
        _, X = te.tensors_for_centers(A, c, with_correctors=True)
        return (X**2).sum()

    _close(_grad(loss, 1.0), _central(lambda t: _value(loss, t), 1.0, 1e-6), 1e-6)


def test_clamped_columns_zero_gradient():
    """Columns the energy clamp forces to the zero corrector have primal 0
    and gradient 0; with enough iterations no column clamps and the
    gradient is the analytic one (K = 1000·I: X = F/1000)."""
    n, s, C = 8, 2, 3
    K = 1000.0 * torch.eye(n, dtype=F64)
    matvec = lambda X: torch.einsum("nm,msc->nsc", K, X)
    prec = lambda R: R
    F0 = torch.as_tensor(np.random.default_rng(11).standard_normal((n, s, C)))

    def loss(maxiter):
        F = F0.clone().requires_grad_(True)
        X, _ = _solve_linear(matvec, prec, F, 1e-13, maxiter, False, True)
        (g,) = torch.autograd.grad((X**2).sum(), F)
        return X.detach(), g

    X0, g0 = loss(0)
    assert float(X0.abs().max()) == 0.0 and float(g0.abs().max()) == 0.0
    X1, g1 = loss(200)
    np.testing.assert_allclose(X1.numpy(), F0.numpy() / 1000.0, atol=1e-12)
    np.testing.assert_allclose(g1.numpy(), 2.0 * F0.numpy() / 1e6, atol=1e-12)


# -- the Cholesky route (K3's plain version) ----------------------------------


def _elastic_engines():
    jm = hx.create_unit_cube(3)
    centers = np.random.default_rng(3).uniform(0, 1, (4, 3))
    je = JaxEngine(jm, bs=3, coeff_kind="tensor4", dtype=jnp.float64, solver="cholesky")
    te = ht.MicroEngine(port_mesh(jm), bs=3, coeff_kind="tensor4", device="cpu")
    return je, te, centers


def _elastic_A(theta, lib):
    if lib is torch:
        def mu(x, y):
            one = torch.ones((), dtype=y.dtype)
            return torch.where(torch_fibre(y[1], y[2]), 100.0 * theta * (1.0 + x[0]) * one,
                               0.5 * one)

        return tval.hooke_tensor(3, mu, lambda x, y: 1.0)
    mu = lambda x, y: jnp.where(jax_fibre(y[1], y[2]), 100.0 * theta * (1.0 + x[0]), 0.5)
    return jval.hooke_tensor(3, mu, lambda x, y: 1.0)


def _elastic_losses(je, te, centers, **kw):
    c = torch.as_tensor(centers)
    tl = lambda th: (te.tensors_for_centers(_elastic_A(th, torch), c, G_fn=torch_rotation,
                                            **kw) ** 2).sum()
    jl = lambda th: jnp.sum(je.tensors_for_centers(_elastic_A(th, jnp), jnp.asarray(centers),
                                                   G_fn=jax_rotation) ** 2)
    return tl, jl


def test_grad_through_micro_chol_route():
    """The chunk Cholesky route (K3's plain version under the implicit rule)
    against the reference (1e-7), the per-cell route differentiated by
    torch.linalg itself (1e-7), and a central difference (1e-5)."""
    je, te, centers = _elastic_engines()
    loss, jloss = _elastic_losses(je, te, centers)
    g = _grad(loss, 1.0)
    _close(g, float(jax.grad(jloss)(1.0)), 1e-7)
    c = torch.as_tensor(centers)

    def percell(theta):
        A = _elastic_A(theta, torch)
        out = 0.0
        for x in c:
            out = out + (te.cell_tensor(te.element_coeff(A, x), torch_rotation(x))[0] ** 2).sum()
        return out

    _close(g, _grad(percell, 1.0), 1e-7)
    _close(g, _central(lambda t: _value(loss, t), 1.0, 1e-5), 1e-5)


@pytest.mark.parametrize("route", ["chunk", "whole_batch", "chunk_gather"])
def test_opaque_k3_route_second_derivative(monkeypatch, route):
    """K3's route (in-chunk, ``HOMMX_CHOL_SOLVE_BATCH=1``, and in-chunk on
    the gather assembly, the card's default, whose scaling is
    differentiated through diag(Kc) on the nonzeros) with its solve
    detached: d²J/dθ² unchanged (1e-8) and equal to the reference's
    (1e-6); the control without the rule misses it."""
    if route == "whole_batch":
        monkeypatch.setenv("HOMMX_CHOL_SOLVE_BATCH", "1")
    if route == "chunk_gather":
        monkeypatch.setenv("HOMMX_KC_ASSEMBLY", "gather")
    je, te, centers = _elastic_engines()
    loss, jloss = _elastic_losses(je, te, centers)
    ref = _grad(loss, 1.0, order=2)
    monkeypatch.setattr(chunk, "fused_chol_solve", _detached(chunk.fused_chol_solve))
    got = _grad(loss, 1.0, order=2)
    _close(got, ref, 1e-8)
    _close(got, float(jax.grad(jax.grad(jloss))(1.0)), 1e-6)
    control, _ = _elastic_losses(je, te, centers, implicit_diff=False)
    assert abs(_grad(control, 1.0, order=2) - got) > 1e-3 * abs(got)


def test_elasticity_pipeline_gradient():
    """The rotated-fibre LinearElasticityStratifiedHMM pipeline at a tiny
    size (3×1×1 macro box, 3³ micro cube; θ scales the fibre modulus):
    dJ/dθ against the JAX package at 1e-7 and a central difference at
    1e-5."""
    jmac = hx.create_box([[0, 0, 0], [1.0, 0.4, 0.1]], [3, 1, 1])
    jmic = hx.create_unit_cube(3)
    tmac, tmic = port_mesh(jmac), port_mesh(jmic)
    f = [0.0, 0.0, -0.008]
    clamp = lambda x: np.isclose(x[0], 0)

    def loss(theta):
        hmm = ht.LinearElasticityStratifiedHMM(
            tmac, _elastic_A(theta, torch), lambda x: torch.tensor(f, dtype=F64), tmic,
            2**-5, torch_rotation, device="cpu")
        V = hmm.function_space
        hmm.set_boundary_conditions(ht.dirichletbc(np.zeros(3), boundary_dofs(V, clamp), V))
        step, centers = hmm.build_pipeline()
        return (step(centers) ** 2).sum()

    def jloss(theta):
        hmm = hx.LinearElasticityStratifiedHMM(
            jmac, _elastic_A(theta, jnp), lambda x: jnp.array(f), jmic, 2**-5, jax_rotation)
        V = hmm.function_space
        hmm.set_boundary_conditions(
            hx.dirichletbc(np.zeros(3), jax_boundary_dofs(V, clamp), V))
        step, centers = hmm.build_pipeline()
        return jnp.sum(step(centers) ** 2)

    g = _grad(loss, 1.0)
    _close(g, float(jax.grad(jloss)(1.0)), 1e-7)
    _close(g, _central(lambda t: _value(loss, t), 1.0, 1e-5), 1e-5)


# -- fem_solve_fn, the entry point, inverse design ----------------------------


def test_grad_through_single_scale_fem():
    """fem_solve_fn: dJ/dθ through the float64 assembly and the implicit
    multigrid CG, against the JAX package at 1e-9 and a central difference
    at 1e-6; the adjoint is one more CG solve."""
    jm = hx.create_unit_square(12, 12)
    Vj, Vt = JaxFunctionSpace(jm, 1), ht.FunctionSpace(port_mesh(jm), 1)
    jbcs = [hx.dirichletbc(0.0, jax_boundary_dofs(Vj), Vj)]
    tbcs = [ht.dirichletbc(0.0, boundary_dofs(Vt), Vt)]
    opts = dict(method="cg", rtol=1e-13, atol=0.0)
    solve = ht.fem_solve_fn(Vt, lambda th, x: 1.0 + th * x[0] * x[1], 1.0, tbcs,
                            options=ht.SolverOptions(**opts), device="cpu")
    jsolve = jax_fem_solve_fn(Vj, lambda th, x: 1.0 + th * x[0] * x[1], 1.0, jbcs,
                              options=JaxOptions(**opts))
    loss = lambda th: (solve(th) ** 2).sum()
    g = _grad(loss, 0.7)
    assert solve.macro_solve.iterations[-1] > 0  # the adjoint CG ran
    _close(g, float(jax.grad(lambda th: jnp.sum(jsolve(th) ** 2))(0.7)), 1e-9)
    _close(g, _central(lambda t: _value(loss, t), 0.7, 1e-6), 1e-6)


def test_entry_matches_graft_entry():
    """entry(device="cpu") is the flagship's pipeline: its u against
    __graft_entry__.entry()'s at 1e-8; it defaults to the card."""
    import inspect

    import __graft_entry__

    step, (centers,) = ht.entry(device="cpu")
    u = step(centers)
    jstep, (jcenters,) = __graft_entry__.entry()
    ref = np.asarray(jstep(jcenters))
    assert u.dtype == F64 and u.shape == ref.shape
    assert np.abs(u.numpy() - ref).max() / np.abs(ref).max() < 1e-8
    assert inspect.signature(ht.entry).parameters["device"].default == "cuda"


def test_inverse_design_newton():
    """examples/inverse_design.py at its n = 8, through the port's script
    (``hommx_tpu_torch.examples.inverse_design.run``): damped Newton on
    J(p) = ‖u(eᵖ) − u*‖² / ‖u*‖² with both derivatives by autograd
    recovers the laminate contrast m* = 7 from m = 2 within 1e-4."""
    from hommx_tpu_torch.examples.inverse_design import run

    res = run(n=8, steps=12, m_true=7.0, m_init=2.0, device="cpu")
    assert abs(res["m"] - 7.0) / 7.0 < 1e-4
