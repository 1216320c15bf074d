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
    (2, 1, "scalar", False, dict(solver="pcg", cell_prec="fft")),
    (2, 1, "scalar", False, dict(solver="pcg", coeff_rank=2, cell_prec="fft")),
    (3, 1, "scalar", False, dict(solver="pcg", cell_prec="fft")),
]
FFT_CASES = [c for c in CASES if c[4].get("cell_prec") == "fft"]


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


@pytest.mark.parametrize("case", FFT_CASES, ids=[_ids(c) for c in FFT_CASES])
def test_fft_route_matches_reference_route(case):
    """The FFT cell preconditioner on the chunk PCG (the stencil matvec, the
    scaling by congruence, no K1): the reference's tensors of the same
    route to 1e-10."""
    dim, bs, kind, flat, kw = case
    eng, A = _run(case, torch.float64)
    assert not eng._k1_route() and eng._use_chunk()
    jeng = JaxEngine(_mesh(dim, flat), bs=bs, coeff_kind=kind, dtype=jnp.float64, **kw)
    ref = np.asarray(jeng.tensors_for_centers(_coeff(dim, kind, jnp), jnp.asarray(_centers(dim))))
    assert np.abs(A.numpy() - ref).max() / np.abs(ref).max() < 1e-10


@pytest.mark.parametrize("dim,bs", [(2, 1), (3, 1), (2, 2), (3, 3)])
def test_fft_symbols_match_reference(dim, bs):
    """``_get_fft_symbols``: the real scalar symbols and the complex
    Hermitian block symbols equal the reference's tables to 1e-12."""
    jm = hx.create_unit_square(4, 6) if dim == 2 else hx.create_unit_cube(3)
    kind = "scalar" if bs == 1 else "tensor4"
    kw = dict(bs=bs, coeff_kind=kind, solver="pcg", cell_prec="fft")
    eng = ht.MicroEngine(port_mesh(jm), device="cpu", **kw)
    syms, grid = eng._get_fft_symbols()
    jsyms, jgrid = JaxEngine(jm, dtype=jnp.float64, **kw)._get_fft_symbols()
    assert tuple(grid) == tuple(jgrid) and syms.dtype == (
        torch.float64 if bs == 1 else torch.complex128)
    jsyms = np.asarray(jsyms)
    assert syms.shape == jsyms.shape
    assert np.abs(syms.numpy() - jsyms).max() <= 1e-12 * np.abs(jsyms).max()


def test_block_fft_dense_k_and_block_stencil():
    """The block FFT symbol on 3D elasticity with the stratified map
    (test_mg_prec.py's configuration): the dense-K and the block-stencil
    matvecs agree to 1e-9 and both give the Cholesky route's A* to 1e-8."""
    def mu(x, y):
        return torch.where(y[1] < 0.5, 20.0 * (1 + 0.1 * x[0]), 0.05).to(y.dtype)

    A_el = torch_hooke(3, mu, lambda x, y: 1.0)

    def G_fn(x):
        g = 0.5 * torch.pi * x[1] / 0.4
        c, s = torch.cos(g), torch.sin(g)
        z, o = torch.zeros_like(g), torch.ones_like(g)
        return torch.stack([torch.stack([c, z, s]), torch.stack([z, o, z]),
                            torch.stack([-s, z, c])]).T

    mesh = ht.create_unit_cube(4)
    centers = torch.as_tensor(np.random.default_rng(0).uniform(0, 1, (4, 3)))
    kw = dict(bs=3, coeff_kind="tensor4", solver="pcg", cell_prec="fft", pcg_tol=1e-11,
              pcg_maxiter=3000, device="cpu")
    out = {}
    for strategy in ("densek", "matfree"):
        eng = ht.MicroEngine(mesh, pcg_strategy=strategy, **kw)
        assert eng._get_block_stencil() is not None and not eng._k1_route()
        out[strategy] = eng.tensors_chunk_pcg(A_el, centers, G_fn=G_fn,
                                              implicit_diff=False).numpy()
    scale = np.abs(out["densek"]).max()
    assert np.abs(out["matfree"] - out["densek"]).max() / scale < 1e-9
    chol = ht.MicroEngine(mesh, bs=3, coeff_kind="tensor4", device="cpu")
    A_chol = chol.tensors_for_centers(A_el, centers, G_fn=G_fn).numpy()
    for A in out.values():
        assert np.abs(A - A_chol).max() / np.abs(A_chol).max() < 1e-8


def test_stratified_fft_matches_reference():
    """PoissonStratifiedHMM (8x8 macro, 8x8 micro, the wavy-laminate map G)
    with ``cell_prec='fft'`` on the chunk PCG: the reference's A* and u to
    1e-10."""
    jA = lambda x, y: jnp.where(jnp.cos(2 * jnp.pi * y[0]) < 0, 5.0, 0.05)  # noqa: E731

    def tA(x, y):  # both values in y's dtype: 0.05 is not rounded to float32
        one = torch.ones((), dtype=y.dtype)
        return torch.where(torch.cos(2 * torch.pi * y[0]) < 0, 5.0 * one, 0.05 * one)

    def jG(x):
        return jnp.array([[-2 * jnp.pi * jnp.cos(2 * jnp.pi * x[0]), 1.0], [1.0, 0.0]])

    def tG(x):
        o, z = torch.ones_like(x[0]), torch.zeros_like(x[0])
        return torch.stack([torch.stack([-2 * torch.pi * torch.cos(2 * torch.pi * x[0]), o]),
                            torch.stack([o, z])])

    kw = dict(dedup_cells=False, engine_kwargs={"cell_prec": "fft", "solver": "pcg"})
    jmac, jmic = hx.create_unit_square(8), hx.create_unit_square(8)
    hj = hx.PoissonStratifiedHMM(jmac, jA, lambda x: 1.0, jmic, 2**-4, jG,
                                 dtype=jnp.float64, **kw)
    ht_ = ht.PoissonStratifiedHMM(port_mesh(jmac), tA, lambda x: 1.0, port_mesh(jmic), 2**-4,
                                  tG, device="cpu", **kw)
    u_ref, u = np.asarray(hj.solve().array), ht_.solve().array.numpy()
    assert ht_._engine.cell_prec == "fft" and not ht_._engine._k1_route()
    A_ref = np.asarray(hj.homogenized_tensors())
    A = ht_.homogenized_tensors().numpy()
    assert np.abs(A - A_ref).max() / np.abs(A_ref).max() < 1e-10
    assert np.abs(u - u_ref).max() / np.abs(u_ref).max() < 1e-10
