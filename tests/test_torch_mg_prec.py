"""Torus multigrid cell preconditioner and block stencil: the port
(``hommx_tpu_torch/micro/mg_prec.py``, ``micro/block_stencil.py``) against
the JAX package in the same process, at the sizes of the reference's
``tests/test_mg_prec.py`` (4³ elasticity, 16² 2D elasticity, 32² scalar),
float64 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hommx_tpu as hx
import hommx_tpu_torch as ht
from hommx_tpu.micro.engine import MicroEngine as JaxEngine
from hommx_tpu.utils.validation import hooke_tensor as jax_hooke
from hommx_tpu_torch.micro import krylov
from hommx_tpu_torch.utils.validation import hooke_tensor as torch_hooke
from tests._torch_parity import port_mesh

torch.set_num_threads(1)

F64 = torch.float64


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


# the same formulas in both frameworks
def _jax_circle(a, b):
    da = jnp.arccos(jnp.cos(2 * jnp.pi * (a - 0.5)))
    db = jnp.arccos(jnp.cos(2 * jnp.pi * (b - 0.5)))
    return (da**2 + db**2) < ((2 * jnp.pi) ** 2 / 16)


def _torch_circle(a, b):
    da = torch.arccos(torch.cos(2 * torch.pi * (a - 0.5)))
    db = torch.arccos(torch.cos(2 * torch.pi * (b - 0.5)))
    return (da**2 + db**2) < ((2 * torch.pi) ** 2 / 16)


def _fibre(lib, soft=0.001):
    """The stiff fibre (contrast 1e5) in framework ``lib``."""
    if lib is torch:
        mu = lambda x, y: torch.where(_torch_circle(y[1], y[2]), 100.0, soft)
        return torch_hooke(3, mu, lambda x, y: 1.0)
    mu = lambda x, y: jnp.where(_jax_circle(y[1], y[2]), 100.0, soft)
    return jax_hooke(3, mu, lambda x, y: 1.0)


def _inclusion(lib, hi, lo):
    box = lambda y: (abs(y[0] - 0.5) < 0.25) & (abs(y[1] - 0.5) < 0.25)
    if lib is torch:
        return lambda x, y: torch.where(box(y), hi, lo)
    return lambda x, y: jnp.where(box(y), hi, lo)


def _pair(jmesh, **kw):
    """(JAX engine, port engine) on one mesh with the same arguments."""
    je = JaxEngine(jmesh, dtype=jnp.float64, **kw)
    te = ht.MicroEngine(port_mesh(jmesh), device="cpu", **kw)
    return je, te


def _centers(n, dim, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (n, dim))


MG_EL = dict(bs=3, coeff_kind="tensor4", solver="pcg", pcg_strategy="matfree", cell_prec="mg")


@pytest.mark.parametrize("case", ["square32", "cube4_vector", "cube8_vector"])
def test_build_mg_levels_tables_equal_reference(case):
    """The host-side hierarchy (grid shapes, signed offsets, the Galerkin
    (Δ, δ, u) tables) is the reference's, entry for entry."""
    from hommx_tpu.micro.mg_prec import _signed_offsets as jax_signed
    from hommx_tpu.micro.mg_prec import build_mg_levels as jax_levels
    from hommx_tpu_torch.micro.mg_prec import _signed_offsets, build_mg_levels

    if case == "square32":
        jm, kw = hx.create_unit_square(32), dict(solver="pcg")
    else:
        n = 4 if case == "cube4_vector" else 8
        jm, kw = hx.create_unit_cube(n), dict(MG_EL)
    je, te = _pair(jm, **kw)
    jst = je._get_stencil() if te.bs == 1 else je._get_block_stencil()
    tst = te._get_stencil() if te.bs == 1 else te._get_block_stencil()
    np.testing.assert_array_equal(np.asarray(tst.offsets), np.asarray(jst.offsets))
    assert tuple(tst.shape) == tuple(jst.shape)
    ref = jax_levels(jax_signed(np.asarray(jst.offsets), jst.shape), jst.shape)
    got = build_mg_levels(_signed_offsets(np.asarray(tst.offsets), tst.shape), tst.shape)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_array_equal(g.offsets, r.offsets)
        assert (g.table is None) == (r.table is None)
        if r.table is not None:
            assert len(g.table) == len(r.table)
            for (ck, fk, u, coef), (rck, rfk, ru, rcoef) in zip(g.table, r.table):
                assert (ck, fk, coef) == (rck, rfk, rcoef)
                np.testing.assert_array_equal(u, ru)
            np.testing.assert_array_equal(g.coarse_offsets, r.coarse_offsets)


def test_block_stencil_matvec_equals_matfree():
    """The block stencil is an exact reformulation of the keep/pin-guarded
    matrix-free gather matvec (1e-12), and its weights are the
    reference's."""
    from hommx_tpu.micro.block_stencil import block_stencil_weights as jax_weights
    from hommx_tpu_torch.micro.block_stencil import (
        block_stencil_matvec,
        block_stencil_weights,
        scale_block_weights,
    )
    from hommx_tpu_torch.micro.percell import _gather_matvec

    je, te = _pair(hx.create_unit_cube(4), **MG_EL)
    C = 2
    c = _centers(C, 3)
    raw = torch.func.vmap(lambda x: te._raw_coeff(_fibre(torch), x))(torch.as_tensor(c))
    A_K = torch.einsum("mr,cemt,tn->cern", te._eye_sym, raw, te._eye_sym)
    st = te._get_block_stencil()
    assert st is not None and st.offsets.shape[0] <= 15
    W = block_stencil_weights(st, te, A_K)
    W_ref = jax_weights(je._get_block_stencil(), je, jnp.asarray(A_K.numpy()))
    assert _rel(W.numpy(), W_ref) < 1e-13
    P = torch.as_tensor(np.random.default_rng(1).standard_normal((te.n_reduced, te.s, C)))
    ref = _gather_matvec(te, A_K, P)
    assert _rel(block_stencil_matvec(st, W, P), ref) < 1e-12
    # the scaled weights are the scaled operator S K S
    sc = torch.as_tensor(np.random.default_rng(2).uniform(0.5, 2.0, (te.n_reduced, C)))
    sc[te.pin_mask] = 1.0
    Ws = scale_block_weights(st, W, sc)
    scaled = sc[:, None] * block_stencil_matvec(st, W, sc[:, None] * P)
    assert _rel(block_stencil_matvec(st, Ws, P), scaled) < 1e-12


def test_mg_scalar_matches_reference_and_k0inv():
    """The scalar chunk PCG with cell_prec='mg' on the 32² contrast-1e5
    inclusion: A* within 1e-8 of the reference's MG route and of the K1
    route (the default preconditioner), lockstep iterations within 2 of the
    reference's and fewer than the K1 route's."""
    c = _centers(4, 2)
    kw = dict(solver="pcg", pcg_tol=1e-11, pcg_maxiter=4000)
    jm = hx.create_unit_square(32)
    je, te = _pair(jm, cell_prec="mg", **kw)
    A_ref, it_ref = jax.jit(lambda c: je.tensors_chunk_pcg(
        _inclusion(jnp, 1e5, 1.0), c, with_iters=True, implicit_diff=False))(jnp.asarray(c))
    A, it = te.tensors_chunk_pcg(_inclusion(torch, 1e5, 1.0), c, with_iters=True,
                                 implicit_diff=False)
    assert _rel(A.numpy(), A_ref) < 1e-8
    assert abs(int(it) - int(it_ref)) <= 2, (int(it), int(it_ref))
    te_k1 = ht.MicroEngine(port_mesh(jm), device="cpu", **kw)
    A_k1, it_k1 = te_k1.tensors_chunk_pcg(_inclusion(torch, 1e5, 1.0), c, with_iters=True,
                                          implicit_diff=False)
    assert _rel(A.numpy(), A_k1.numpy()) < 1e-8
    assert int(it) < int(it_k1), (int(it), int(it_k1))


def test_mg_elasticity_matches_cholesky_4cubed():
    """At 4³ the hierarchy is one level, an exact dense solve: the MG route
    equals the reference's float64 Cholesky route and its own MG route to
    1e-8."""
    c = _centers(3, 3)
    je_chol = JaxEngine(hx.create_unit_cube(4), bs=3, coeff_kind="tensor4", dtype=jnp.float64)
    A_chol = np.asarray(je_chol.tensors_for_centers(_fibre(jnp), jnp.asarray(c)))
    je, te = _pair(hx.create_unit_cube(4), pcg_tol=1e-11, pcg_maxiter=2000, **MG_EL)
    A = te.tensors_for_centers(_fibre(torch), torch.as_tensor(c)).numpy()
    assert _rel(A, A_chol) < 1e-8
    assert _rel(A, je.tensors_for_centers(_fibre(jnp), jnp.asarray(c))) < 1e-8


def _mg_loss(eng, c, **kw):
    def loss(p):
        mu = lambda x, y: 1.0 + p * (x[0] + torch.where(y[1] < 0.5, 2.0, 0.5))
        A = torch_hooke(3, mu, lambda x, y: 1.0)
        return (eng.tensors_for_centers(A, torch.as_tensor(c), **kw) ** 2).sum()

    return loss


def _grad(loss, theta, order=1):
    th = torch.tensor(theta, dtype=F64, requires_grad=True)
    (g,) = torch.autograd.grad(loss(th), th, create_graph=order > 1)
    if order > 1:
        (g,) = torch.autograd.grad(g, th)
    return float(g)


def _detached(fn):
    def wrapped(*a, **k):
        X, k_ = fn(*a, **k)
        return X.detach(), k_

    return wrapped


def test_mg_gradient_matches_cholesky(monkeypatch):
    """The MG route differentiates through the implicit rule as the
    Cholesky route does through torch.linalg (1e-9) and as the reference's
    MG route (1e-9); with its raw Krylov solve detached, d²J/dθ² is
    unchanged (1e-8) and the Cholesky route's (1e-6), while the control
    without the rule misses it."""
    c = _centers(3, 3)
    jm = hx.create_unit_cube(4)
    kw = dict(pcg_tol=1e-12, pcg_maxiter=1000, **MG_EL)
    te_chol = ht.MicroEngine(port_mesh(jm), bs=3, coeff_kind="tensor4", device="cpu")
    je, te = _pair(jm, **kw)
    g_chol = _grad(_mg_loss(te_chol, c), 0.4)
    g_mg = _grad(_mg_loss(te, c), 0.4)
    assert abs(g_mg - g_chol) / abs(g_chol) < 1e-9

    def jloss(p):
        mu = lambda x, y: 1.0 + p * (x[0] + jnp.where(y[1] < 0.5, 2.0, 0.5))
        A = jax_hooke(3, mu, lambda x, y: 1.0)
        return jnp.sum(je.tensors_for_centers(A, jnp.asarray(c)) ** 2)

    g_ref = float(jax.jit(jax.grad(jloss))(0.4))
    assert abs(g_mg - g_ref) / abs(g_ref) < 1e-9
    h_chol = _grad(_mg_loss(te_chol, c), 0.4, order=2)
    h_mg = _grad(_mg_loss(te, c), 0.4, order=2)
    monkeypatch.setattr(krylov, "_chunk_pcg_raw", _detached(krylov._chunk_pcg_raw))
    h_opaque = _grad(_mg_loss(te, c), 0.4, order=2)
    assert abs(h_opaque - h_mg) < 1e-8 * abs(h_mg)
    assert abs(h_opaque - h_chol) < 1e-6 * abs(h_chol)
    h_control = _grad(_mg_loss(te, c, implicit_diff=False), 0.4, order=2)
    assert abs(h_control - h_chol) > 1e-3 * abs(h_chol)


def test_mg_rejects_unstructured_mesh():
    """cell_prec='mg' needs the torus grid: a mesh without the structured
    grid metadata raises ValueError, as in the reference."""
    box = ht.create_unit_square(6)
    mesh = ht.SimplexMesh(box.vertices, box.cells)
    assert mesh.structure is None
    eng = ht.MicroEngine(mesh, solver="pcg", cell_prec="mg", pcg_tol=1e-8, pcg_maxiter=100,
                         device="cpu")
    with pytest.raises(ValueError, match="structured box micro mesh"):
        eng.tensors_chunk_pcg(lambda x, y: 1.0 + y[0], torch.zeros((2, 2), dtype=F64),
                              implicit_diff=False)


def test_mg_matfree_switch_keeps_scalar_mg(monkeypatch):
    """Under HOMMX_MICRO_MATVEC=matfree the scalar MG route keeps its
    stencil, as the block stencil does (the reference drops it and then
    says the mesh is not structured): A* equals the run without the
    switch."""
    c = _centers(3, 2)
    A = lambda x, y: 1.5 + x[0] + 0.8 * torch.sin(2 * torch.pi * y[0])
    kw = dict(solver="pcg", cell_prec="mg", pcg_tol=1e-11, device="cpu")
    ref = ht.MicroEngine(ht.create_unit_square(16), **kw).tensors_for_centers(A, c)
    monkeypatch.setenv("HOMMX_MICRO_MATVEC", "matfree")
    eng = ht.MicroEngine(ht.create_unit_square(16), **kw)
    assert eng._get_stencil() is not None
    assert _rel(eng.tensors_for_centers(A, c).numpy(), ref.numpy()) < 1e-12


def test_mg_odd_grid_coarsest_guard():
    """A grid side that turns odd above 4 stops the coarsening: on a 65²
    cell the coarsest level would be the 4225-unknown fine grid, and the
    route raises naming it instead of factoring it densely per cell."""
    eng = ht.MicroEngine(ht.create_unit_square(65), solver="pcg", cell_prec="mg", device="cpu")
    with pytest.raises(ValueError, match="coarsest level"):
        eng.tensors_chunk_pcg(lambda x, y: 1.0 + y[0], torch.zeros((1, 2), dtype=F64),
                              implicit_diff=False)


def test_block_stencil_stratified_route_matches_matfree(monkeypatch):
    """The block-stencil matvec (the default on structured meshes) and the
    matrix-free gather (HOMMX_MICRO_MATVEC=matfree) give the same A* under
    the stratified strain map (1e-9), and the reference's Cholesky route's
    (1e-8)."""
    def jmu(x, y):
        return jnp.where(y[1] < 0.5, 20.0 * (1 + 0.1 * x[0]), 0.05)

    def tmu(x, y):
        return torch.where(y[1] < 0.5, 20.0 * (1 + 0.1 * x[0]), 0.05)

    def jG(x):
        g = 0.5 * jnp.pi * x[1] / 0.4
        return jnp.array([[jnp.cos(g), 0.0, jnp.sin(g)], [0.0, 1.0, 0.0],
                          [-jnp.sin(g), 0.0, jnp.cos(g)]]).T

    def tG(x):
        g = 0.5 * torch.pi * x[1] / 0.4
        z, o = torch.zeros_like(g), torch.ones_like(g)
        return torch.stack([torch.stack([torch.cos(g), z, torch.sin(g)]), torch.stack([z, o, z]),
                            torch.stack([-torch.sin(g), z, torch.cos(g)])]).T

    c = _centers(4, 3)
    kw = dict(bs=3, coeff_kind="tensor4", solver="pcg", pcg_strategy="matfree",
              pcg_tol=1e-11, pcg_maxiter=3000, device="cpu")
    outs = {}
    for mode in ("matfree", "auto"):
        monkeypatch.setenv("HOMMX_MICRO_MATVEC", mode)
        eng = ht.MicroEngine(ht.create_unit_cube(4), **kw)
        assert (eng._get_block_stencil() is None) == (mode == "matfree")
        outs[mode] = eng.tensors_for_centers(torch_hooke(3, tmu, lambda x, y: 1.0), c,
                                             G_fn=tG).numpy()
    assert _rel(outs["auto"], outs["matfree"]) < 1e-9
    je = JaxEngine(hx.create_unit_cube(4), bs=3, coeff_kind="tensor4", dtype=jnp.float64)
    A_chol = je.tensors_for_centers(jax_hooke(3, jmu, lambda x, y: 1.0), jnp.asarray(c),
                                    G_fn=jG)
    assert _rel(outs["auto"], A_chol) < 1e-8


def test_mg_with_densek_strategy():
    """cell_prec='mg' with the dense-K chunk strategy (the matvec stays Kc,
    the V-cycle is built from the block stencil) against the reference's
    Cholesky route (1e-8), in at most 5 iterations at 4³."""
    jmu = lambda x, y: jnp.where(y[1] < 0.5, 100.0, 0.001)
    tmu = lambda x, y: torch.where(y[1] < 0.5, 100.0, 0.001)
    c = _centers(3, 3)
    je = JaxEngine(hx.create_unit_cube(4), bs=3, coeff_kind="tensor4", dtype=jnp.float64)
    A_chol = je.tensors_for_centers(jax_hooke(3, jmu, lambda x, y: 1.0), jnp.asarray(c))
    te = ht.MicroEngine(ht.create_unit_cube(4), bs=3, coeff_kind="tensor4", solver="pcg",
                        pcg_strategy="densek", cell_prec="mg", pcg_tol=1e-11, pcg_maxiter=500,
                        device="cpu")
    A, it = te.tensors_chunk_pcg(torch_hooke(3, tmu, lambda x, y: 1.0), c, with_iters=True,
                                 implicit_diff=False)
    assert _rel(A.numpy(), A_chol) < 1e-8
    assert int(it) <= 5


def test_mg_elasticity_2d():
    """2D vector cells (bs = 2) at contrast 1e5 through a 16² three-level
    hierarchy: A* within 1e-8 of the reference's MG route and of the
    Cholesky route, lockstep iterations within 2 of the reference's (< 100)."""
    c = _centers(3, 2)
    jm = hx.create_unit_square(16)
    kw = dict(bs=2, coeff_kind="tensor4", solver="pcg", pcg_strategy="matfree", cell_prec="mg",
              pcg_tol=1e-11, pcg_maxiter=3000)
    je, te = _pair(jm, **kw)
    jA = jax_hooke(2, _inclusion(jnp, 1e3, 0.01), lambda x, y: 1.0)
    tA = torch_hooke(2, _inclusion(torch, 1e3, 0.01), lambda x, y: 1.0)
    A_ref, it_ref = jax.jit(lambda c: je.tensors_chunk_pcg(
        jA, c, with_iters=True, implicit_diff=False))(jnp.asarray(c))
    A, it = te.tensors_chunk_pcg(tA, c, with_iters=True, implicit_diff=False)
    te_chol = ht.MicroEngine(port_mesh(jm), bs=2, coeff_kind="tensor4", device="cpu")
    assert _rel(A.numpy(), A_ref) < 1e-8
    assert _rel(A.numpy(), te_chol.tensors_for_centers(tA, c).numpy()) < 1e-8
    assert abs(int(it) - int(it_ref)) <= 2 and int(it) < 100, (int(it), int(it_ref))


def test_solve_periodic_large_branch_matches_reference():
    """solve_periodic above 4096 reduced dofs (a 46² 2D elasticity cell, n
    = 4232): the one-cell PCG on the block stencil with the torus multigrid
    against the reference's at 1e-8."""
    jm = hx.create_unit_square(46)
    je, te = _pair(jm, bs=2, coeff_kind="tensor4", pcg_tol=1e-10)
    assert te.n_reduced > 4096
    jA = jax_hooke(2, lambda x, y: 1.0 + 0.5 * jnp.sin(2 * jnp.pi * y[0]), lambda x, y: 1.0)
    tA = torch_hooke(2, lambda x, y: 1.0 + 0.5 * torch.sin(2 * torch.pi * y[0]),
                     lambda x, y: 1.0)
    u_ref = jax.jit(lambda: je.solve_periodic(jA, grad_rhs=lambda y: jnp.stack(
        [jnp.sin(2 * jnp.pi * y[0]), 0.0, 0.0, jnp.cos(2 * jnp.pi * y[1])])))()
    u = te.solve_periodic(tA, grad_rhs=lambda y: torch.stack(
        [torch.sin(2 * torch.pi * y[0]), torch.zeros_like(y[0]), torch.zeros_like(y[0]),
         torch.cos(2 * torch.pi * y[1])]))
    assert _rel(u.numpy(), u_ref) < 1e-8


def test_solve_periodic_large_branch_jacobi(monkeypatch):
    """On a mesh without the torus grid the large branch runs Jacobi on the
    matrix-free operator (forced here on an 8² cell by lowering the dense
    limit): the dense branch's solution and the reference's within 1e-8."""
    from hommx_tpu_torch.micro import percell

    jm = hx.create_unit_square(8)
    flat = hx.SimplexMesh(np.asarray(jm.vertices), np.asarray(jm.cells))
    je, te = _pair(flat, bs=2, coeff_kind="tensor4", pcg_tol=1e-12)
    assert te._get_block_stencil() is None
    jA = jax_hooke(2, lambda x, y: 1.0 + 0.5 * jnp.sin(2 * jnp.pi * y[0]), lambda x, y: 1.0)
    tA = torch_hooke(2, lambda x, y: 1.0 + 0.5 * torch.sin(2 * torch.pi * y[0]),
                     lambda x, y: 1.0)
    f = lambda y: torch.stack([torch.cos(2 * torch.pi * y[1]), torch.sin(2 * torch.pi * y[0])])
    u_ref = je.solve_periodic(jA, rhs=lambda y: jnp.array(
        [jnp.cos(2 * jnp.pi * y[1]), jnp.sin(2 * jnp.pi * y[0])]))
    u_dense = te.solve_periodic(tA, rhs=f)
    monkeypatch.setattr(percell, "_DENSE_MAX", 8)
    u = te.solve_periodic(tA, rhs=f)
    assert _rel(u.numpy(), u_dense.numpy()) < 1e-8
    assert _rel(u.numpy(), u_ref) < 1e-8


def test_float32_coarsest_solve_is_floored():
    """The float32 V-cycle's coarsest solve: on an SPD operator the floored
    inverse is the inverse (5e-6); on one whose rounding-level modes went
    negative (as float32 Galerkin products leave them on contrast-1e5
    cells) it stays symmetric positive definite with eigenvalues at most
    1/floor, where a Cholesky factor fails."""
    from hommx_tpu_torch.micro.mg_prec import _floored_inverse

    rng = np.random.default_rng(3)
    Q, _ = np.linalg.qr(rng.standard_normal((2, 12, 12)))
    lam = np.stack([np.geomspace(1e-3, 2.0, 12), np.r_[-1.4e-6, np.geomspace(1e-3, 2.0, 11)]])
    K = torch.as_tensor(np.einsum("cij,cj,ckj->cik", Q, lam, Q), dtype=torch.float32)
    floor = torch.full((2,), 1e-6, dtype=torch.float32)
    Kinv = _floored_inverse(K, floor)
    assert Kinv.dtype == torch.float64
    assert _rel(Kinv[0].numpy(), np.linalg.inv(K[0].double().numpy())) < 5e-6
    assert torch.linalg.cholesky_ex(K[1]).info > 0
    ev = np.linalg.eigvalsh(Kinv[1].double().numpy())
    assert ev.min() > 0 and ev.max() <= 1.0 / 1e-6 * (1 + 1e-5)
