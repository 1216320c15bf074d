"""P2 micro cell problems (``MicroEngine(micro_degree=2)``) in the port,
mirroring tests/test_strategy_matrix.py's P2 cases and
tests/test_micro_engine.py's P2 tests: the chunk PCG and Cholesky routes,
scalar and tensor4, constant-coefficient exactness, P2 against P1 near a
fine reference, ``solve_periodic`` and an HMM end to end — each held to
the JAX package in this process, in float64, at 1e-10."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hommx_tpu as hx
import hommx_tpu_torch as ht
from hommx_tpu.micro.engine import MicroEngine as JaxEngine
from hommx_tpu.utils.validation import hooke_tensor as jax_hooke
from hommx_tpu_torch.utils.validation import hooke_tensor as torch_hooke
from tests._torch_parity import port_mesh

torch.set_num_threads(1)


def _smooth(lib):
    return lambda x, y: 2.0 + lib.sin(2 * np.pi * y[0]) * lib.cos(2 * np.pi * y[1]) + x[0]


def _lame(lib, dim):
    hooke = torch_hooke if lib is torch else jax_hooke
    return hooke(dim, lambda x, y: 1.0 + 0.5 * lib.sin(2 * np.pi * y[0]), lambda x, y: 1.0)


def _rel(a, ref) -> float:
    a, ref = np.asarray(a), np.asarray(ref)
    return float(np.abs(a - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("kind,kw", [
    ("scalar", dict(solver="pcg")), ("scalar", dict(solver="cholesky")),
    ("tensor4", dict(solver="pcg", pcg_strategy="matfree")), ("tensor4", dict(solver="cholesky")),
])
def test_p2_micro_routes_match_reference(kind, kw):
    """P2 cells (8x8 square; effective elements nE = ne·nq) through the
    chunk PCG (the matrix-free gather: no stencil, no K1) and the Cholesky
    routes: the reference's A* of the same route to 1e-10."""
    bs = 1 if kind == "scalar" else 2
    jm = hx.create_unit_square(8, 8) if kind == "scalar" else hx.create_unit_square(4, 4)
    c = np.random.default_rng(7).uniform(0, 1, (12, 2))
    je = JaxEngine(jm, bs=bs, coeff_kind=kind, dtype=jnp.float64, micro_degree=2, **kw)
    te = ht.MicroEngine(port_mesh(jm), bs=bs, coeff_kind=kind, micro_degree=2, device="cpu", **kw)
    assert te.nE == je.nE == 3 * jm.num_cells and te.n_reduced == je.n_reduced
    assert not te._k1_route() and te._get_stencil() is None and te._get_block_stencil() is None
    jA, tA = (_smooth(jnp), _smooth(torch)) if bs == 1 else (_lame(jnp, 2), _lame(torch, 2))
    A_ref = np.asarray(je.tensors_for_centers(jA, jnp.asarray(c)))
    A = te.tensors_for_centers(tA, torch.as_tensor(c)).numpy()
    assert _rel(A, A_ref) < 1e-10


def test_p2_micro_constant_coefficient_exact():
    """Constant coefficients: zero correctors and A* = A to 1e-13, scalar
    (2D, 3D) and elasticity, as the reference's."""
    eng = ht.MicroEngine(ht.create_unit_square(4), micro_degree=2, device="cpu")
    A, X = eng.cell_tensor(eng.element_coeff(lambda x, y: 3.0, torch.zeros(2)))
    assert float((A - 3 * torch.eye(2)).abs().max()) < 1e-13 and float(X.abs().max()) < 1e-13
    e3 = ht.MicroEngine(ht.create_unit_cube(2), micro_degree=2, device="cpu")
    A3, _ = e3.cell_tensor(e3.element_coeff(lambda x, y: 2.0, torch.zeros(3)))
    assert float((A3 - 2 * torch.eye(3)).abs().max()) < 1e-13
    C = torch_hooke(2, lambda x, y: 1.0, lambda x, y: 1.25)
    ee = ht.MicroEngine(ht.create_unit_square(3), bs=2, coeff_kind="tensor4", micro_degree=2,
                        device="cpu")
    x0 = torch.zeros(2, dtype=torch.float64)
    Ast, _ = ee.cell_tensor(ee.element_coeff(C, x0))
    assert float((Ast - C(x0, x0).reshape(4, 4)).abs().max()) < 1e-13
    # the stratified identity map reproduces the unmapped tensors (to
    # rounding: the mapped route multiplies by the identity)
    es = ht.MicroEngine(ht.create_unit_square(6), micro_degree=2, device="cpu")
    Ae = es.element_coeff(_smooth(torch), torch.zeros(2, dtype=torch.float64))
    assert _rel(es.cell_tensor(Ae, torch.eye(2))[0], es.cell_tensor(Ae)[0]) < 1e-14


def test_p2_micro_beats_p1():
    """A smooth coefficient: P2 at an 8x8 micro mesh is over 10x closer to
    a fine P1 tensor (32x32) than P1 at 8x8, and its tensor is the
    reference's to 1e-10."""
    A = _smooth(torch)
    x0 = torch.zeros(2, dtype=torch.float64)

    def astar(n, degree):
        e = ht.MicroEngine(ht.create_unit_square(n), micro_degree=degree, quad_degree=4,
                           device="cpu")
        return e.cell_tensor(e.element_coeff(A, x0))[0].numpy()

    truth = astar(32, 1)
    p1, p2 = astar(8, 1), astar(8, 2)
    assert _rel(p2, truth) < _rel(p1, truth) / 10, (_rel(p1, truth), _rel(p2, truth))
    je = JaxEngine(hx.create_unit_square(8), dtype=jnp.float64, micro_degree=2, quad_degree=4)
    ref, _ = je.cell_tensor(je.element_coeff(_smooth(jnp), jnp.zeros(2)))
    assert _rel(p2, ref) < 1e-10


@pytest.mark.parametrize("bs", [1, 2])
def test_p2_solve_periodic(bs):
    """``solve_periodic`` on the P2 space (loads through the P2 basis
    values at the effective elements' points): the reference's solution on
    the full periodic node set to 1e-10."""
    jm = hx.create_unit_square(4)
    if bs == 1:
        kind, jA, tA = "scalar", _smooth(jnp), _smooth(torch)
        jr = lambda y: jnp.cos(2 * jnp.pi * y[0])  # noqa: E731
        tr = lambda y: torch.cos(2 * torch.pi * y[0])  # noqa: E731
    else:
        kind, jA, tA = "tensor4", _lame(jnp, 2), _lame(torch, 2)
        jr = lambda y: jnp.array([jnp.cos(2 * jnp.pi * y[0]), jnp.sin(2 * jnp.pi * y[1])])  # noqa
        tr = lambda y: torch.stack([torch.cos(2 * torch.pi * y[0]),  # noqa: E731
                                    torch.sin(2 * torch.pi * y[1])])
    je = JaxEngine(jm, bs=bs, coeff_kind=kind, dtype=jnp.float64, micro_degree=2)
    te = ht.MicroEngine(port_mesh(jm), bs=bs, coeff_kind=kind, micro_degree=2, device="cpu")
    u_ref = np.asarray(je.solve_periodic(jA, rhs=jr))
    u = te.solve_periodic(tA, rhs=tr).numpy()
    assert u.shape == u_ref.shape == (te.pmap.reduced_index.size * bs,)
    assert _rel(u, u_ref) < 1e-10


def test_p2_micro_hmm_end_to_end():
    """PoissonHMM with P2 cell problems through ``engine_kwargs`` (8x8
    macro, 8x8 micro, quad_degree_micro=4): the reference's u to 1e-10."""
    def coeff(lib):
        return lambda x, y: (2.0 + lib.sin(2 * np.pi * y[0]) * lib.cos(2 * np.pi * y[1])) * (
            1.1 + x[0])

    kw = dict(quad_degree_micro=4, engine_kwargs={"micro_degree": 2})
    jmac, jmic = hx.create_unit_square(8), hx.create_unit_square(8)
    u_ref = np.asarray(hx.PoissonHMM(jmac, coeff(jnp), lambda x: 1.0, jmic, 2**-4,
                                     dtype=jnp.float64, **kw).solve().array)
    h = ht.PoissonHMM(port_mesh(jmac), coeff(torch), lambda x: 1.0, port_mesh(jmic), 2**-4,
                      device="cpu", **kw)
    u = h.solve().array.numpy()
    assert h._engine.micro_degree == 2 and h._engine.nE == 3 * jmic.num_cells * 2
    assert _rel(u, u_ref) < 1e-10
