"""The per-cell micro route through the port on the CPU:
``MicroEngine.element_coeff``, ``cell_tensor`` (the block-PCG branch on
scalar problems, the Cholesky branch on elasticity, with and without a
gradient map G) and ``solve_periodic`` (load and gradient load, dense and
PCG branches), held to the JAX package in this process and to the port's
own chunk routes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hommx_tpu as hx
import hommx_tpu_torch as ht
import hommx_tpu_torch.micro.percell as percell
from hommx_tpu.micro.engine import MicroEngine as JaxEngine
from hommx_tpu.utils import validation as jval
from hommx_tpu_torch.utils import validation as tval
from tests._torch_parity import port_mesh

torch.set_num_threads(1)


def _rel(a, ref) -> float:
    ref = np.asarray(ref)
    return float(np.abs(np.asarray(a) - ref).max() / np.abs(ref).max())


def jax_scalar(x, y):
    return 1.5 + 0.5 * jnp.sin(2 * jnp.pi * y[0]) + 0.3 * jnp.cos(2 * jnp.pi * y[1]) + x[0]


def torch_scalar(x, y):
    return 1.5 + 0.5 * torch.sin(2 * torch.pi * y[0]) + 0.3 * torch.cos(2 * torch.pi * y[1]) + x[0]


def _jax_mu(x, y):
    return jnp.where((y[0] - 0.5) ** 2 + (y[1] - 0.5) ** 2 < 0.09, 30.0 * (1 + x[0]), 1.0)


def _torch_mu(x, y):
    one = torch.ones((), dtype=y.dtype)
    return torch.where((y[0] - 0.5) ** 2 + (y[1] - 0.5) ** 2 < 0.09, 30.0 * (1 + x[0]) * one, one)


ONE = lambda x, y: 1.0  # noqa: E731
JAX_HOOKE, TORCH_HOOKE = jval.hooke_tensor(2, _jax_mu, ONE), tval.hooke_tensor(2, _torch_mu, ONE)
X0 = np.array([0.3, 0.7])
G = np.array([[1.0, 0.4], [-0.2, 1.1]])


def _engines(kind, dtype="float64"):
    """(JAX engine, port engine, JAX coefficient, port coefficient)."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    if kind == "scalar":
        jm = hx.create_unit_square(6)
        return (JaxEngine(jm, dtype=jdt, solver="pcg"),
                ht.MicroEngine(port_mesh(jm), dtype=tdt, device="cpu", solver="pcg"),
                jax_scalar, torch_scalar)
    jm = hx.create_unit_square(4)
    return (JaxEngine(jm, bs=2, coeff_kind="tensor4", dtype=jdt, solver="cholesky"),
            ht.MicroEngine(port_mesh(jm), bs=2, coeff_kind="tensor4", dtype=tdt, device="cpu"),
            JAX_HOOKE, TORCH_HOOKE)


@pytest.mark.parametrize("kind", ["scalar", "elasticity"])
@pytest.mark.parametrize("mapped", [False, True])
def test_cell_tensor_matches_reference(kind, mapped):
    """element_coeff exactly, then cell_tensor's A* and correctors within
    1e-10 of the reference's (block-PCG on the scalar engine, Cholesky on
    the elasticity engine; G = Dθᵀ or none), and A* within 1e-10 of the
    port's chunk route at the same center."""
    je, te, jA, tA = _engines(kind)
    Ae_j = je.element_coeff(jA, jnp.asarray(X0))
    Ae_t = te.element_coeff(tA, torch.as_tensor(X0))
    np.testing.assert_allclose(Ae_t.numpy(), np.asarray(Ae_j), rtol=1e-15, atol=1e-15)
    Gj = jnp.asarray(G) if mapped else None
    Gt = torch.as_tensor(G) if mapped else None
    A_ref, X_ref = je.cell_tensor(Ae_j, Gj)
    A, X = te.cell_tensor(Ae_t, Gt)
    assert A.shape == (te.s_full, te.s_full) and X.shape == (te.n_reduced, te.s_full)
    assert _rel(A.numpy(), A_ref) < 1e-10
    assert _rel(X.numpy(), X_ref) < 1e-10
    G_fn = (lambda x: torch.as_tensor(G)) if mapped else None
    A_chunk = te.tensors_for_centers(tA, torch.as_tensor(X0[None]), G_fn=G_fn)[0]
    assert _rel(A.numpy(), A_chunk.numpy()) < 1e-10


def test_cell_tensor_float32_cholesky_matches_reference():
    """The float32 Cholesky branch (equilibration and one refinement sweep,
    scatter assembly) against the reference's float32 per-cell route
    within 5e-6, the bar of the float32 chunk route's test."""
    je, te, jA, tA = _engines("elasticity", "float32")
    assert te.assembly == "scatter"
    A_ref, _ = je.cell_tensor(je.element_coeff(jA, jnp.asarray(X0, jnp.float32)))
    A, _ = te.cell_tensor(te.element_coeff(tA, torch.as_tensor(X0, dtype=torch.float32)))
    assert A.dtype == torch.float32
    assert _rel(A.numpy(), A_ref) < 5e-6


def test_cell_tensor_gather_matches_scatter(monkeypatch):
    """With HOMMX_KC_ASSEMBLY=gather the per-cell route sums K, F and the
    D-free products in the gather's fixed order: equal to the scatter's
    within 1e-13."""
    je, te, jA, tA = _engines("scalar")
    te.D = None  # the matrix-free products through the reduced-dof sums
    A_s, X_s = te.cell_tensor(te.element_coeff(tA, X0))
    monkeypatch.setenv("HOMMX_KC_ASSEMBLY", "gather")
    _, te_g, _, _ = _engines("scalar")
    te_g.D = None
    A_g, X_g = te_g.cell_tensor(te_g.element_coeff(tA, X0))
    assert te_g._kc_gather is not None and te._kc_gather is None
    assert _rel(A_g.numpy(), A_s.numpy()) < 1e-13
    assert _rel(X_g.numpy(), X_s.numpy()) < 1e-10


def _loads(kind):
    """(JAX rhs, JAX grad_rhs, port rhs, port grad_rhs) with zero mean."""
    if kind == "scalar":
        return (lambda y: jnp.cos(2 * jnp.pi * y[1]),
                lambda y: jnp.array([jnp.sin(2 * jnp.pi * y[0]), 0.5]),
                lambda y: torch.cos(2 * torch.pi * y[1]),
                lambda y: torch.stack([torch.sin(2 * torch.pi * y[0]),
                                       torch.full_like(y[0], 0.5)]))
    return (lambda y: jnp.array([jnp.cos(2 * jnp.pi * y[1]), jnp.sin(2 * jnp.pi * y[0])]),
            lambda y: jnp.array([jnp.sin(2 * jnp.pi * y[0]), 0.0, 0.0, 1.0]),
            lambda y: torch.stack([torch.cos(2 * torch.pi * y[1]), torch.sin(2 * torch.pi * y[0])]),
            lambda y: torch.stack([torch.sin(2 * torch.pi * y[0]), torch.zeros_like(y[0]),
                                   torch.zeros_like(y[0]), torch.ones_like(y[0])]))


@pytest.mark.parametrize("kind", ["scalar", "elasticity"])
@pytest.mark.parametrize("terms", ["rhs", "grad_rhs", "both"])
def test_solve_periodic_matches_reference(kind, terms):
    """solve_periodic with a load, a gradient load or both, expanded to the
    full periodic node set: the reference's u within 1e-10."""
    je, te, jA, tA = _engines(kind)
    fj, gj, ft, gt = _loads(kind)
    kj = dict(rhs=fj if terms != "grad_rhs" else None, grad_rhs=gj if terms != "rhs" else None)
    kt = dict(rhs=ft if terms != "grad_rhs" else None, grad_rhs=gt if terms != "rhs" else None)
    u_ref = np.asarray(je.solve_periodic(jA, x_center=X0, **kj))
    u = te.solve_periodic(tA, x_center=X0, **kt)
    assert u.shape == (te.mesh.num_vertices * te.bs,)
    assert _rel(u.numpy(), u_ref) < 1e-10


def test_solve_periodic_pcg_branch(monkeypatch):
    """Above the dense limit solve_periodic runs the one-cell PCG (on this
    structured mesh: the block stencil with the torus multigrid): the
    dense branch's (and the reference's) solution within 1e-8; no load
    raises."""
    je, te, jA, tA = _engines("scalar")
    fj, gj, ft, gt = _loads("scalar")
    u_ref = np.asarray(je.solve_periodic(jA, rhs=fj, grad_rhs=gj))
    u_dense = te.solve_periodic(tA, rhs=ft, grad_rhs=gt)
    monkeypatch.setattr(percell, "_DENSE_MAX", 8)
    u_pcg = te.solve_periodic(tA, rhs=ft, grad_rhs=gt)
    assert _rel(u_pcg.numpy(), u_dense.numpy()) < 1e-8
    assert _rel(u_pcg.numpy(), u_ref) < 1e-8
    with pytest.raises(ValueError):
        te.solve_periodic(tA)
