"""Cross-strategy sweep of the port's micro engine (the reference's
``tests/test_strategy_matrix.py`` at its sizes): every route the
constructor arguments select — the K1 stencil route, the MG, block-stencil,
matrix-free gather and low-rank chunk routes, the per-cell Cholesky and
densek routes, matrix coefficients — gives the JAX package's float64
direct-solve tensors, and its float32 run lands near them."""

import functools

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


def _coeff(dim, kind, lib):
    """The reference sweep's coefficients, in framework ``lib``."""
    sin = torch.sin if lib is torch else jnp.sin
    pi = np.pi
    if kind == "scalar":
        return lambda x, y: 1.5 + x[0] + sin(2 * pi * y[0]) * 0.8
    if kind == "matrix":
        if lib is torch:
            return lambda x, y: torch.stack([
                torch.stack([2.0 + sin(2 * pi * y[0]), 0.3 * x[0]]),
                torch.stack([0.3 * x[0], 1.5 + 0.5 * torch.cos(2 * pi * y[1])])])
        return lambda x, y: jnp.array([[2.0 + sin(2 * pi * y[0]), 0.3 * x[0]],
                                       [0.3 * x[0], 1.5 + 0.5 * jnp.cos(2 * pi * y[1])]])
    hooke = torch_hooke if lib is torch else jax_hooke
    return hooke(dim, lambda x, y: 1.0 + 0.5 * sin(2 * pi * y[0]), lambda x, y: 1.0)


def _mesh(dim, flat=False):
    """The sweep's micro mesh; ``flat`` drops the structured-grid metadata
    (the matrix-free gather route)."""
    jm = hx.create_unit_square(8, 8) if dim == 2 else hx.create_unit_cube(3)
    if flat:
        jm = hx.SimplexMesh(np.asarray(jm.vertices), np.asarray(jm.cells))
    return jm


def _centers(dim):
    return np.random.default_rng(7).uniform(0, 1, (12, dim))


@functools.lru_cache(maxsize=None)
def _reference(dim, bs, kind):
    """The JAX package's float64 tensors on its default (direct) route."""
    eng = JaxEngine(_mesh(dim), bs=bs, coeff_kind=kind, dtype=jnp.float64)
    return np.asarray(eng.tensors_for_centers(_coeff(dim, kind, jnp), jnp.asarray(_centers(dim))))


CASES = [
    # (dim, bs, kind, flat mesh, engine kwargs)
    (2, 1, "scalar", False, dict()),
    (2, 1, "scalar", False, dict(solver="pcg")),
    (2, 1, "scalar", False, dict(solver="pcg", diag_scale=False)),
    (2, 1, "scalar", False, dict(solver="pcg", coeff_rank=2)),
    (2, 1, "scalar", False, dict(solver="pcg", cell_prec="mg")),
    (2, 1, "scalar", False, dict(solver="pcg", pcg_strategy="densek")),
    (2, 1, "scalar", True, dict(solver="pcg")),
    (2, 1, "scalar", True, dict(solver="pcg", coeff_rank=2)),
    (2, 1, "matrix", False, dict()),
    (2, 1, "matrix", False, dict(solver="pcg")),
    (2, 1, "matrix", False, dict(solver="pcg", pcg_strategy="matfree")),
    (2, 1, "matrix", False, dict(solver="pcg", cell_prec="mg")),
    (2, 2, "tensor4", False, dict(solver="pcg")),
    (2, 2, "tensor4", False, dict(solver="pcg", pcg_strategy="matfree")),
    (2, 2, "tensor4", False, dict(solver="pcg", pcg_strategy="matfree", cell_prec="mg")),
    (2, 2, "tensor4", True, dict(solver="pcg", pcg_strategy="matfree")),
    (3, 1, "scalar", False, dict(solver="pcg")),
    (3, 1, "scalar", False, dict(solver="pcg", cell_prec="mg")),
    (3, 3, "tensor4", False, dict(solver="pcg")),
    (3, 3, "tensor4", False, dict(solver="pcg", pcg_strategy="matfree")),
]


def _ids(case):
    dim, bs, kind, flat, kw = case
    parts = [f"{dim}d", kind] + (["flat"] if flat else []) + [f"{k}={v}" for k, v in kw.items()]
    return "-".join(parts)


def _run(case, dtype):
    dim, bs, kind, flat, kw = case
    eng = ht.MicroEngine(port_mesh(_mesh(dim, flat)), bs=bs, coeff_kind=kind, dtype=dtype,
                         device="cpu", **kw)
    return eng, eng.tensors_for_centers(_coeff(dim, kind, torch), _centers(dim))


@pytest.mark.parametrize("case", CASES, ids=[_ids(c) for c in CASES])
def test_strategy_matches_reference_direct(case):
    """Float64: every route within 1e-8 of the reference's direct solve."""
    dim, bs, kind, _, _ = case
    _, A = _run(case, torch.float64)
    ref = _reference(dim, bs, kind)
    assert A.shape == ref.shape
    assert np.abs(A.numpy() - ref).max() / np.abs(ref).max() < 1e-8


@pytest.mark.parametrize("case", CASES, ids=[_ids(c) for c in CASES])
def test_strategy_f32_close_to_f64(case):
    """Float32 (the plain versions on the CPU): within the reference
    sweep's 5e-4 of the float64 direct solve."""
    dim, bs, kind, _, _ = case
    _, A = _run(case, torch.float32)
    ref = _reference(dim, bs, kind)
    assert A.dtype == torch.float32
    assert np.abs(A.numpy() - ref).max() / np.abs(ref).max() < 5e-4


@pytest.mark.parametrize("kind,dtype,route", [
    ("scalar", torch.float64, "percell"), ("scalar", torch.float32, "k1"),
    ("matrix", torch.float32, "percell"), ("tensor4", torch.float64, "chol"),
    ("tensor4", torch.float32, "chol"),
])
def test_auto_solver_picks_the_reference_route(kind, dtype, route):
    """solver='auto' is the reference's rule: the chunk PCG for scalar
    float32 problems, Cholesky for every other dtype and coefficient kind
    (the chunk Cholesky for vector problems, the per-cell route for scalar
    ones); pcg_strategy defaults by coefficient kind."""
    bs = 2 if kind == "tensor4" else 1
    eng = ht.MicroEngine(ht.create_unit_square(4), bs=bs, coeff_kind=kind, dtype=dtype,
                         device="cpu")
    jeng = JaxEngine(hx.create_unit_square(4), bs=bs, coeff_kind=kind,
                     dtype=jnp.float32 if dtype == torch.float32 else jnp.float64)
    assert eng.solver == jeng.solver and eng.pcg_strategy == jeng.pcg_strategy
    assert eng.matmul_precision == jeng.matmul_precision
    assert (eng._k1_route(), eng._chol_route()) == (route == "k1", route == "chol")


def test_matfree_switch_lowrank_matches_reference(monkeypatch):
    """HOMMX_MICRO_MATVEC=matfree with a declared rank takes the low-rank
    shared-Gram matvec (no stencil): A* within 1e-8 of the reference's same
    route."""
    monkeypatch.setenv("HOMMX_MICRO_MATVEC", "matfree")
    kw = dict(solver="pcg", coeff_rank=2)
    c = _centers(2)
    je = JaxEngine(_mesh(2), dtype=jnp.float64, **kw)
    ref = np.asarray(je.tensors_for_centers(_coeff(2, "scalar", jnp), jnp.asarray(c)))
    te = ht.MicroEngine(port_mesh(_mesh(2)), device="cpu", **kw)
    assert te._get_stencil() is None and te.D is not None
    A = te.tensors_for_centers(_coeff(2, "scalar", torch), c).numpy()
    assert np.abs(A - ref).max() / np.abs(ref).max() < 1e-8


@pytest.mark.parametrize("rank", [1, 2])
def test_check_coeff_rank_matches_reference(rank):
    """check_coeff_rank: the rank-2 coefficient 1.5 + x₀ + 0.8 sin 2πy₀ is
    not covered at rank 1, where the port's residual is the reference's
    within 1e-12; at rank 2 both residuals are rounding noise (the
    pseudo-inverse of VVᵀ squares its condition), below 1e-9."""
    c = _centers(2)
    je = JaxEngine(_mesh(2), dtype=jnp.float64, solver="pcg")
    te = ht.MicroEngine(port_mesh(_mesh(2)), device="cpu", solver="pcg")
    ref = je.check_coeff_rank(_coeff(2, "scalar", jnp), jnp.asarray(c), rank=rank)
    got = te.check_coeff_rank(_coeff(2, "scalar", torch), c, rank=rank)
    if rank == 1:
        assert abs(got - ref) <= 1e-12 and got > 1e-2, (got, ref)
    else:
        assert got < 1e-9 and ref < 1e-9, (got, ref)
    with pytest.raises(ValueError, match="scalar"):
        ht.MicroEngine(ht.create_unit_square(4), bs=2, coeff_kind="tensor4",
                       device="cpu").check_coeff_rank(_coeff(2, "tensor4", torch), c)
