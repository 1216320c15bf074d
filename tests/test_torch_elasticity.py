"""The elasticity slice through the port on the CPU: the validation
helpers, the vector branch of the micro engine's static operators, the
chunk-Cholesky A* route, the vector macro system, and
``LinearElasticity(Stratified)HMM`` against the frozen goldens and the JAX
package solved in the same process; plus the default device of every
entry point."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hommx_tpu as hx
import hommx_tpu_torch as ht
from hommx_tpu.micro.engine import MicroEngine as JaxEngine
from hommx_tpu.models.common import MacroSystem as JaxMacroSystem
from hommx_tpu.models.common import assemble_macro_system as jax_assemble
from hommx_tpu.models.common import merge_bcs as jax_merge_bcs
from hommx_tpu.models.common import strain_coefficients as jax_strain_coefficients
from hommx_tpu.ops.assembly import assemble_load_vector as jax_load
from hommx_tpu.ops.function_space import FunctionSpace as JaxFunctionSpace
from hommx_tpu.ops.function_space import boundary_dofs as jax_boundary_dofs
from hommx_tpu.utils import validation as jval
from hommx_tpu_torch.models.common import (
    MacroSystem,
    assemble_macro_system,
    merge_bcs,
    strain_coefficients,
)
from hommx_tpu_torch.models.hmm import _as_source
from hommx_tpu_torch.ops.assembly import assemble_load_vector
from hommx_tpu_torch.ops.function_space import boundary_dofs
from hommx_tpu_torch.utils import validation as tval
from tests._torch_parity import port_mesh
from tests.test_golden import GOLDEN, RTOL

torch.set_num_threads(1)

BEAM_W = 0.4


# -- coefficients, written once in jnp and once in torch --------------------


def jax_mu2(x, y):  # the inclusion of tests/test_chol_kernel.py
    inc = (y[0] - 0.5) ** 2 + (y[1] - 0.5) ** 2 < 0.09
    return jnp.where(inc, 50.0 * (1.0 + 0.2 * x[0]), 0.5 + 0.3 * jnp.sin(2 * jnp.pi * y[1]))


def torch_mu2(x, y):
    inc = (y[0] - 0.5) ** 2 + (y[1] - 0.5) ** 2 < 0.09
    return torch.where(inc, 50.0 * (1.0 + 0.2 * x[0]), 0.5 + 0.3 * torch.sin(2 * torch.pi * y[1]))


def jax_fibre(a, b):
    da = jnp.arccos(jnp.cos(2 * jnp.pi * (a - 0.5)))
    db = jnp.arccos(jnp.cos(2 * jnp.pi * (b - 0.5)))
    return (da**2 + db**2) < ((2 * jnp.pi) ** 2 / 16)


def torch_fibre(a, b):
    da = torch.arccos(torch.cos(2 * torch.pi * (a - 0.5)))
    db = torch.arccos(torch.cos(2 * torch.pi * (b - 0.5)))
    return (da**2 + db**2) < ((2 * torch.pi) ** 2 / 16)


def jax_mu3(x, y):  # the bench row's x-dependent fibre modulus
    return jnp.where(jax_fibre(y[1], y[2]), 100.0 * (1.0 + 0.001 * x[0]), 0.001)


def torch_mu3(x, y):
    one = torch.ones((), dtype=y.dtype)
    return torch.where(torch_fibre(y[1], y[2]), 100.0 * (1.0 + 0.001 * x[0]) * one, 0.001 * one)


def jax_rotation(x):  # Dθᵀ(x) of the rotated-fiber beam
    g = 0.5 * jnp.pi * x[1] / BEAM_W
    c, s = jnp.cos(g), jnp.sin(g)
    return jnp.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]]).T


def torch_rotation(x):
    g = 0.5 * torch.pi * x[1] / BEAM_W
    c, s = torch.cos(g), torch.sin(g)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, z, s]), torch.stack([z, o, z]),
                        torch.stack([-s, z, c])]).T


ONE = (lambda x, y: 1.0)
JAX_A2, TORCH_A2 = jval.hooke_tensor(2, jax_mu2, ONE), tval.hooke_tensor(2, torch_mu2, ONE)
JAX_A3, TORCH_A3 = jval.hooke_tensor(3, jax_mu3, ONE), tval.hooke_tensor(3, torch_mu3, ONE)


# -- validation helpers -----------------------------------------------------


def test_hooke_tensor_matches_reference():
    rng = np.random.default_rng(0)
    for d, ja, ta in ((2, JAX_A2, TORCH_A2), (3, JAX_A3, TORCH_A3)):
        for x, y in rng.uniform(0, 1, (5, 2, d)):
            ref = np.asarray(ja(jnp.asarray(x), jnp.asarray(y)))
            got = ta(torch.as_tensor(x), torch.as_tensor(y))
            assert got.dtype == torch.float64 and got.shape == (d,) * 4
            np.testing.assert_allclose(got.numpy(), ref, rtol=1e-15, atol=0)


def test_validation_norms_and_bcs_match_reference():
    """L2 and H1 norms and errors of vector P1 functions, the cross-mesh
    comparisons and the zero box-boundary BC, on the same arrays."""
    rng = np.random.default_rng(1)
    jc, jf = hx.create_unit_square(4), hx.create_unit_square(8)
    tc, tf = port_mesh(jc), port_mesh(jf)
    Vjc, Vjf = JaxFunctionSpace(jc, 2), JaxFunctionSpace(jf, 2)
    Vtc, Vtf = ht.FunctionSpace(tc, 2), ht.FunctionSpace(tf, 2)
    a, b = rng.standard_normal(Vjc.num_dofs), rng.standard_normal(Vjc.num_dofs)
    fine = rng.standard_normal(Vjf.num_dofs)
    pairs = [
        (jval.calc_l2_norm(jc, jnp.asarray(a), bs=2), tval.calc_l2_norm(tc, torch.as_tensor(a), bs=2)),
        (jval.calc_l2_error(jc, jnp.asarray(a), jnp.asarray(b), bs=2),
         tval.calc_l2_error(tc, torch.as_tensor(a), torch.as_tensor(b), bs=2)),
        (jval.calc_h1_error(jc, jnp.asarray(a), jnp.asarray(b), bs=2),
         tval.calc_h1_error(tc, torch.as_tensor(a), torch.as_tensor(b), bs=2)),
        (jval.relative_l2_vs_reference(hx.Function(Vjc, a), hx.Function(Vjf, fine)),
         tval.relative_l2_vs_reference(ht.Function(Vtc, torch.as_tensor(a)),
                                       ht.Function(Vtf, torch.as_tensor(fine)))),
        (jval.relative_h1_vs_reference(hx.Function(Vjc, a), hx.Function(Vjf, fine)),
         tval.relative_h1_vs_reference(ht.Function(Vtc, torch.as_tensor(a)),
                                       ht.Function(Vtf, torch.as_tensor(fine)))),
    ]
    for ref, got in pairs:
        assert got == pytest.approx(ref, rel=1e-12)
    for Vj, Vt in ((Vjc, Vtc), (JaxFunctionSpace(jc, 1), ht.FunctionSpace(tc, 1))):
        (jbc,), (tbc,) = jval.zero_dirichlet_bcs(Vj), tval.zero_dirichlet_bcs(Vt)
        np.testing.assert_array_equal(tbc.dofs, np.asarray(jbc.dofs))
        np.testing.assert_array_equal(tbc.values, np.asarray(jbc.values))


def test_vector_source_and_load_vector_match_reference():
    """A constant (bs,) right-hand side becomes f(x) → (bs,), and its load
    vector equals the reference's."""
    jm = hx.create_rectangle([[0.0, 0.0], [1.0, 0.25]], [8, 2])
    tm = port_mesh(jm)
    f = _as_source([0.0, -0.01], 2)
    assert torch.equal(f(torch.zeros(2)), torch.tensor([0.0, -0.01], dtype=torch.float64))
    verts, cells = torch.as_tensor(tm.vertices), torch.as_tensor(tm.cells)
    b = assemble_load_vector(verts, cells, f, bs=2)
    b_ref = np.asarray(jax_load(jnp.asarray(jm.vertices), jnp.asarray(jm.cells),
                                lambda x: jnp.array([0.0, -0.01]), bs=2))
    np.testing.assert_allclose(b.numpy(), b_ref, rtol=1e-13, atol=1e-17)


# -- micro engine -----------------------------------------------------------


@pytest.mark.parametrize("name", ["square4", "cube3"])
def test_vector_operators_equal_reference(name):
    """build_operators, vector branch: Draw, loc2red, the Voigt generators,
    their expansion map and the pin mask equal the reference exactly; the
    strain maps and diag(K0) to rounding."""
    jm = hx.create_unit_square(4) if name == "square4" else hx.create_unit_cube(3)
    d = jm.dim
    je = JaxEngine(jm, bs=d, coeff_kind="tensor4", dtype=jnp.float64, solver="cholesky")
    te = ht.MicroEngine(port_mesh(jm), bs=d, coeff_kind="tensor4", device="cpu")
    assert (te.r, te.s, te.s_full, te.n_reduced) == (je.r, je.s, d * d, je.n_reduced)
    np.testing.assert_array_equal(te.Draw.numpy(), np.asarray(je.Draw))
    np.testing.assert_array_equal(te.loc2red.numpy(), np.asarray(je.loc2red))
    np.testing.assert_array_equal(te.E.numpy(), np.asarray(je.E))
    np.testing.assert_array_equal(te.sym_expand, np.asarray(je.sym_expand))
    np.testing.assert_array_equal(te.pin_mask.numpy(), np.asarray(je.pin_mask))
    np.testing.assert_allclose(te._eye_sym.numpy(), np.asarray(je._eye_sym), rtol=0, atol=1e-15)
    G = np.linalg.qr(np.random.default_rng(2).standard_normal((d, d)))[0]
    np.testing.assert_allclose(te._grad_map(torch.as_tensor(G)).numpy(),
                               np.asarray(je._grad_map(jnp.asarray(G))), rtol=0, atol=1e-15)
    np.testing.assert_allclose(te._get_K0diag().numpy(), np.asarray(je._get_K0diag()), rtol=1e-13)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_engine_astar_2d_matches_reference(dtype):
    """A* of 6 cells on the 5² micro square with the inclusion coefficient:
    float32 against the reference's float32 chunk-Cholesky route within
    5e-6, float64 against its per-cell route within 1e-10."""
    jm = hx.create_unit_square(5, 5)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    centers = np.random.default_rng(3).uniform(0, 1, (6, 2))
    je = JaxEngine(jm, bs=2, coeff_kind="tensor4", dtype=jdt, solver="cholesky")
    te = ht.MicroEngine(port_mesh(jm), bs=2, coeff_kind="tensor4", dtype=tdt,
                        solver="cholesky", device="cpu")
    assert te.assembly == ("scatter" if dtype == "float32" else "dense")
    ref = np.asarray(je.tensors_for_centers(JAX_A2, jnp.asarray(centers, jdt), chunk=6))
    got = te.tensors_for_centers(TORCH_A2, torch.as_tensor(centers, dtype=tdt), chunk=6)
    assert got.dtype == tdt and got.shape == (6, 4, 4)
    tol = 5e-6 if dtype == "float32" else 1e-10
    assert np.abs(got.numpy() - ref).max() / np.abs(ref).max() < tol


def test_engine_astar_3d_rotated_matches_reference():
    """A* on the 3³ micro cube with the rotated stiff fibre (G_fn), float64,
    within 1e-10; the zero-corrector tensors and contrast of the guard
    too."""
    jm = hx.create_unit_cube(3)
    c = np.random.default_rng(4).uniform(0, 1, (4, 3))
    je = JaxEngine(jm, bs=3, coeff_kind="tensor4", dtype=jnp.float64, solver="cholesky")
    te = ht.MicroEngine(port_mesh(jm), bs=3, coeff_kind="tensor4", device="cpu")
    ref = np.asarray(je.tensors_for_centers(JAX_A3, jnp.asarray(c), G_fn=jax_rotation))
    got = te.tensors_for_centers(TORCH_A3, torch.as_tensor(c), G_fn=torch_rotation).numpy()
    assert got.shape == (4, 9, 9)
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-10
    A0_ref, con_ref = je.nocorrector_tensors(JAX_A3, jnp.asarray(c))
    A0, con = te.nocorrector_tensors(TORCH_A3, torch.as_tensor(c), G_fn=torch_rotation)
    np.testing.assert_allclose(A0.numpy(), np.asarray(A0_ref), rtol=1e-13, atol=1e-15)
    np.testing.assert_allclose(con.numpy(), np.asarray(con_ref), rtol=1e-13)


@pytest.mark.parametrize("name", ["square13", "cube5"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_engine_astar_above_small_k3_matches_reference(name, dtype):
    """Cells above the small K3 instance's reach (n = 338 on the 13² micro
    square, n = 375 on the 5³ cube with the rotated fibre), which K3's large
    instance solves on the card: the port's chunk-Cholesky A* (the plain
    version here) against the reference in the same process, float32
    against its float32 chunk solve within 5e-5, float64 against its route
    within 1e-10 (the chunk-against-per-cell divergence)."""
    from hommx_tpu_torch.ops import chol_kernel

    jm = hx.create_unit_square(13, 13) if name == "square13" else hx.create_unit_cube(5)
    d = jm.dim
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    coeff = (JAX_A2, TORCH_A2) if d == 2 else (JAX_A3, TORCH_A3)
    G = (None, None) if d == 2 else (jax_rotation, torch_rotation)
    centers = np.random.default_rng(12).uniform(0, 1, (3, d))
    je = JaxEngine(jm, bs=d, coeff_kind="tensor4", dtype=jdt, solver="cholesky")
    te = ht.MicroEngine(port_mesh(jm), bs=d, coeff_kind="tensor4", dtype=tdt, device="cpu")
    assert te._chol_route() and te.n_reduced == (338 if d == 2 else 375)
    assert chol_kernel.chol_launch_config(te.n_reduced, te.s).large
    ref = np.asarray(je.tensors_for_centers(coeff[0], jnp.asarray(centers, jdt), G_fn=G[0],
                                            chunk=3))
    got = te.tensors_for_centers(coeff[1], torch.as_tensor(centers, dtype=tdt), G_fn=G[1],
                                 chunk=3)
    assert got.dtype == tdt and got.shape == (3, d * d, d * d)
    tol = 5e-5 if dtype == "float32" else 1e-10
    assert np.abs(got.numpy() - ref).max() / np.abs(ref).max() < tol
    assert chol_kernel.KERNEL.launches == 0  # the CPU takes the plain version


def test_k3_workspace_in_chunk_and_batch_guards():
    """Where K3's large instance runs (a float32 CUDA engine on the
    Cholesky route above n = 288), the engine counts its workspace: the
    6³ cube's per-cell bytes, (16·nE·r·s + 10·n·s + 4n² + nE·nbl²)·4 =
    12,099,456, grow by 978,432, so a 4320-cell batch takes 14 chunks of
    309 instead of 13 of 333; and the whole-batch route's guard counts it:
    300 cells of the 8³ cube take 300 · 2 · 1536² · 4 = 5.66 GB without it
    and 300 · 4,890,624 B more with it, over 6 GB, so the in-chunk route
    takes them instead of running out of memory (a whole 8³ beam batch of
    4320 cells is refused either way).  The device is set after
    construction, so nothing touches a card."""
    e6 = ht.MicroEngine(ht.create_unit_cube(6), bs=3, coeff_kind="tensor4",
                        dtype=torch.float32, device="cpu")
    assert e6._k3_workspace_bytes() == 0 and e6._auto_chunk(4320) == 333
    e6.device = torch.device("cuda")
    assert e6._k3_workspace_bytes() == 978_432 and e6._auto_chunk(4320) == 309
    e8 = ht.MicroEngine(ht.create_unit_cube(8), bs=3, coeff_kind="tensor4",
                        dtype=torch.float32, device="cpu")
    assert e8._chol_batch_fits(300) and not e8._chol_batch_fits(4320)
    e8.device = torch.device("cuda")
    assert e8._k3_workspace_bytes() == 4_890_624
    assert not e8._chol_batch_fits(300) and e8._chol_batch_fits(20)


def test_chunking_does_not_change_elasticity_results():
    """A ragged last chunk (padded by _map_chunked) gives the same A*."""
    te = ht.MicroEngine(ht.create_unit_square(4), bs=2, coeff_kind="tensor4", device="cpu")
    c = torch.as_tensor(np.random.default_rng(5).uniform(0, 1, (7, 2)))
    A_a = te.tensors_for_centers(TORCH_A2, c, chunk=3)
    A_b = te.tensors_for_centers(TORCH_A2, c, chunk=7)
    np.testing.assert_allclose(A_a.numpy(), A_b.numpy(), rtol=1e-12, atol=0)


def test_dfree_loads_match_dense():
    """The loads built by the per-element scatter (micro meshes too large
    for the dense D) give the same A* as the dense D product."""
    mesh = ht.create_unit_cube(3)
    c = torch.as_tensor(np.random.default_rng(7).uniform(0, 1, (3, 3)))
    te = ht.MicroEngine(mesh, bs=3, coeff_kind="tensor4", device="cpu")
    A_ref = te.tensors_for_centers(TORCH_A3, c, G_fn=torch_rotation)
    te.D = None  # what build_operators leaves above its size cap
    A_dfree = te.tensors_for_centers(TORCH_A3, c, G_fn=torch_rotation)
    np.testing.assert_allclose(A_dfree.numpy(), A_ref.numpy(), rtol=0,
                               atol=1e-12 * A_ref.abs().max().item())


# -- macro system -----------------------------------------------------------


def test_vector_macro_system_matches_reference():
    """Strain coefficients, per-cell stiffness |T|·P A*ᵀ Pᵀ, ELL assembly
    and Dirichlet lifting of a vector space on seeded tensors."""
    jm = hx.create_rectangle([[0.0, 0.0], [1.0, 0.25]], [8, 2])
    V = JaxFunctionSpace(jm, 2)
    jsys = JaxMacroSystem(V, jnp.float64)
    tsys = MacroSystem(ht.FunctionSpace(port_mesh(jm), 2), torch.float64, "cpu")
    np.testing.assert_allclose(tsys.strain_P64.numpy(),
                               np.asarray(jax_strain_coefficients(jsys.grads64, 2)),
                               rtol=0, atol=1e-15)
    np.testing.assert_array_equal(strain_coefficients(tsys.grads64, 2).numpy(),
                                  tsys.strain_P64.numpy())
    rng = np.random.default_rng(6)
    G = rng.standard_normal((jm.num_cells, 4, 4))
    A_star = np.einsum("cij,ckj->cik", G, G) + np.eye(4)
    b = rng.standard_normal(V.num_dofs)
    dofs = jax_boundary_dofs(V, lambda x: np.isclose(x[0], 0))
    np.testing.assert_array_equal(boundary_dofs(tsys.V, lambda x: np.isclose(x[0], 0)), dofs)
    jmask, jvals = jax_merge_bcs([hx.dirichletbc(np.zeros(2), dofs, V)], V.num_dofs, jnp.float64)
    tmask, tvals = merge_bcs([ht.dirichletbc(np.zeros(2), dofs, tsys.V)], V.num_dofs,
                             torch.float64, "cpu")
    jv, jb = jax_assemble(jsys, jnp.asarray(A_star), jnp.asarray(b), jmask, jvals, bs=2,
                          macro_f64=True)
    tv, tb = assemble_macro_system(tsys, torch.as_tensor(A_star), torch.as_tensor(b), tmask,
                                   tvals, macro_f64=True)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-13 * np.abs(jv).max())
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=0, atol=1e-13 * np.abs(jb).max())


# -- the slice --------------------------------------------------------------


def _configs(name):
    """(model, macro, A, f, micro, eps[, Dθᵀ]) of a golden configuration
    for the JAX package and for the port (same meshes, same numbers)."""
    if name == "elasticity_2d":
        jmac = hx.create_rectangle([[0.0, 0.0], [1.0, 0.25]], [8, 2])
        jmic = hx.create_unit_square(4, 4)
        jmu = lambda x, y: jnp.where(jnp.sin(2 * jnp.pi * y[1]) > 0, 10.0, 1.0)

        def tmu(x, y):
            one = torch.ones((), dtype=y.dtype)
            return torch.where(torch.sin(2 * torch.pi * y[1]) > 0, 10.0 * one, one)

        f = [0.0, -0.01]
        return (
            (hx.LinearElasticityHMM, jmac, jval.hooke_tensor(2, jmu, ONE),
             lambda x: jnp.array(f), jmic, 2**-4),
            (ht.LinearElasticityHMM, port_mesh(jmac), tval.hooke_tensor(2, tmu, ONE),
             lambda x: torch.tensor(f, dtype=torch.float64), port_mesh(jmic), 2**-4),
        )
    jmac = hx.create_box([[0, 0, 0], [1.0, BEAM_W, 0.1]], [5, 2, 2])
    jmic = hx.create_unit_cube(3)
    jmu = lambda x, y: jnp.where(jax_fibre(y[1], y[2]), 100.0, 0.001)

    def tmu(x, y):
        one = torch.ones((), dtype=y.dtype)
        return torch.where(torch_fibre(y[1], y[2]), 100.0 * one, 0.001 * one)

    f = [0.0, 0.0, -0.008]
    return (
        (hx.LinearElasticityStratifiedHMM, jmac, jval.hooke_tensor(3, jmu, ONE),
         lambda x: jnp.array(f), jmic, 2**-5, jax_rotation),
        (ht.LinearElasticityStratifiedHMM, port_mesh(jmac), tval.hooke_tensor(3, tmu, ONE),
         lambda x: torch.tensor(f, dtype=torch.float64), port_mesh(jmic), 2**-5,
         torch_rotation),
    )


@pytest.mark.parametrize("name", ["elasticity_2d", "elasticity_stratified_3d"])
def test_golden_elasticity_f64(name):
    """The golden configuration through the port in float64 on the CPU
    (chunk-Cholesky micro route, float64 direct macro solve): the frozen
    functionals at RTOL = 1e-8, and the JAX package's solution in this
    process to 1e-9 relative."""
    (jcls, jmac, *jargs), (tcls, tmac, *targs) = _configs(name)
    clamp = lambda x: np.isclose(x[0], 0)
    hj = jcls(jmac, *jargs)
    Vj = hj.function_space
    hj.set_boundary_conditions(hx.dirichletbc(np.zeros(Vj.bs), jax_boundary_dofs(Vj, clamp), Vj))
    u_ref = np.asarray(hj.solve().array)
    hmm = tcls(tmac, *targs, device="cpu")
    V = hmm.function_space
    hmm.set_boundary_conditions(ht.dirichletbc(np.zeros(V.bs), boundary_dofs(V, clamp), V))
    u = hmm.solve()
    assert u.array.dtype == torch.float64 and hmm._macro_method == "direct"
    assert hmm._engine.solver == "cholesky"
    got = (tval.calc_l2_norm(tmac, u), float(u.array.abs().max()))
    for g, w in zip(got, GOLDEN[name]):
        assert g == pytest.approx(w, rel=RTOL), (got, GOLDEN[name])
    assert np.abs(u.array.numpy() - u_ref).max() / np.abs(u_ref).max() < 1e-9
    dg = hmm.diagnostics
    assert dg["diverged_cells"].size == dg["fallback_cells"].size == dg["nan_cells"].size == 0


def test_elasticity_error_probes():
    """What the port lacks raises instead of running: a scalar coefficient
    on a vector problem; a shard_mesh that is not a ShardMesh is a
    TypeError.  The elasticity CG macro solve runs (float64 assembly,
    float64 multigrid CG), on two CPU shards too, where it equals the
    unsharded solve; and so do the routes this test once pinned as
    unported: the block FFT cell preconditioner and P2 micro elements give
    the reference's A* (1e-10)."""
    args = (ht.create_rectangle([[0.0, 0.0], [1.0, 0.25]], [4, 2]), TORCH_A2, [0.0, -0.01],
            ht.create_unit_square(4), 0.1)
    cg = ht.SolverOptions(method="cg", rtol=1e-12, atol=0.0)
    h = ht.LinearElasticityHMM(*args, options_global_solve=cg, device="cpu")
    assert h._macro_method == "cg" and h._macro_f64 and h._sys.mg is not None
    with pytest.raises(TypeError, match="ShardMesh"):
        ht.LinearElasticityHMM(*args, shard_mesh=object(), device="cpu")
    hs = ht.LinearElasticityHMM(*args, options_global_solve=cg, device="cpu",
                                shard_mesh=ht.ShardMesh(["cpu"] * 2))
    for m in (h, hs):
        V = m.function_space
        m.set_boundary_conditions(ht.dirichletbc(
            np.zeros(2), boundary_dofs(V, lambda x: np.isclose(x[0], 0.0)), V))
    u = h.solve().array
    assert hs._use_sharded_macro()
    assert float((hs.solve().array - u).abs().max()) <= 1e-10 * float(u.abs().max())
    jm = hx.create_unit_square(4)
    c = np.random.default_rng(5).uniform(0, 1, (4, 2))
    for kw in (dict(solver="pcg", cell_prec="fft"), dict(micro_degree=2)):
        je = JaxEngine(jm, bs=2, coeff_kind="tensor4", dtype=jnp.float64, **kw)
        te = ht.MicroEngine(port_mesh(jm), bs=2, coeff_kind="tensor4", device="cpu", **kw)
        A_ref = np.asarray(je.tensors_for_centers(JAX_A2, jnp.asarray(c)))
        A = te.tensors_for_centers(TORCH_A2, torch.as_tensor(c)).numpy()
        assert np.abs(A - A_ref).max() / np.abs(A_ref).max() < 1e-10, kw
    with pytest.raises(NotImplementedError):
        ht.MicroEngine(ht.create_unit_square(4), bs=2, device="cpu")


def test_entry_points_default_to_the_card():
    """Every public constructor takes ``device="cuda"`` by default; without
    a card, constructing on the default raises torch's own error instead of
    carrying on on the CPU."""
    for cls in (ht.BaseHMM, ht.MicroEngine, ht.Function):
        assert inspect.signature(cls).parameters["device"].default == "cuda", cls
    for cls in (ht.PoissonHMM, ht.PoissonStratifiedHMM, ht.LinearElasticityHMM,
                ht.LinearElasticityStratifiedHMM):
        # the models pass ``device`` on to BaseHMM unless they name it
        param = inspect.signature(cls).parameters.get("device")
        assert issubclass(cls, ht.BaseHMM) and (param is None or param.default == "cuda")
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            ht.MicroEngine(ht.create_unit_square(4))
        with pytest.raises((RuntimeError, AssertionError)):
            ht.Function(ht.FunctionSpace(ht.create_unit_square(2)))


# -- the fixed-order Kc assembly and the whole-batch route --------------------


def _cube_engines(dtype="float64", solver_kw=True):
    """(JAX engine, port engine) on the 3³ micro cube."""
    jm = hx.create_unit_cube(3)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    je = JaxEngine(jm, bs=3, coeff_kind="tensor4", dtype=jdt, solver="cholesky")
    te = ht.MicroEngine(port_mesh(jm), bs=3, coeff_kind="tensor4", dtype=tdt, device="cpu")
    return je, te


def test_kc_gather_tables_equal_reference(monkeypatch):
    """With HOMMX_KC_ASSEMBLY=gather both packages invert the Kc scatter
    map into the same tables, entry for entry; the CPU default is the
    scatter (no tables), and an unknown mode raises."""
    from hommx_tpu.micro.chunk import _get_kc_gather as jax_kc_gather
    from hommx_tpu_torch.micro.chunk import _get_kc_gather, kc_assembly_mode

    assert kc_assembly_mode("cpu") == "scatter" and kc_assembly_mode("cuda") == "gather"
    _, te = _cube_engines()
    assert _get_kc_gather(te) is None
    monkeypatch.setenv("HOMMX_KC_ASSEMBLY", "gather")
    je, te = _cube_engines()
    ref = jax_kc_gather(je)
    got = _get_kc_gather(te)
    assert ref is not None and got is not None
    # the reference places the nonzeros by their inverse map, the port at nz
    inv_map = np.full(got.n * got.n, got.nz.size, dtype=np.int64)
    inv_map[got.nz] = np.arange(got.nz.size)
    for g, r in zip((got.tab, inv_map, got.keep_vec, got.pin_vec), ref):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(r))
    monkeypatch.setenv("HOMMX_KC_ASSEMBLY", "sideways")
    with pytest.raises(ValueError):
        kc_assembly_mode("cpu")


@pytest.mark.parametrize("dfree", [False, True])
def test_kc_gather_assembly_matches_scatter_and_reference(monkeypatch, dfree):
    """A* of the rotated fibre on the 3³ cube with the gather assembly (Kc,
    and with no dense D the loads F too): equal to the scatter's and to the
    reference's float64 route within 1e-12."""
    c = np.random.default_rng(8).uniform(0, 1, (5, 3))
    je, te_s = _cube_engines()
    A_ref = np.asarray(je.tensors_for_centers(JAX_A3, jnp.asarray(c), G_fn=jax_rotation))
    if dfree:
        te_s.D = None
    # the mode is read at an engine's first assembly
    A_s = te_s.tensors_for_centers(TORCH_A3, torch.as_tensor(c), G_fn=torch_rotation).numpy()
    monkeypatch.setenv("HOMMX_KC_ASSEMBLY", "gather")
    _, te_g = _cube_engines()
    if dfree:
        te_g.D = None
    A_g = te_g.tensors_for_centers(TORCH_A3, torch.as_tensor(c), G_fn=torch_rotation).numpy()
    assert te_g._kc_gather is not None and te_s._kc_gather is None
    scale = np.abs(A_ref).max()
    assert np.abs(A_g - A_s).max() / scale < 1e-12
    assert np.abs(A_g - A_ref).max() / scale < 1e-12


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_tensors_chol_batched_matches_reference(monkeypatch, dtype):
    """HOMMX_CHOL_SOLVE_BATCH=1 in both packages: the port's
    tensors_for_centers takes the whole-batch route (one solve over every
    cell, a ragged last chunk padded), and its A* equals the reference's
    whole-batch route (float64: called directly, as the reference routes
    float64 elsewhere) within 1e-10, float32 within 5e-6; with correctors
    the in-chunk route takes the batch."""
    import hommx_tpu.micro.chunk as jax_chunk
    import hommx_tpu_torch.micro.chunk as chunk
    from hommx_tpu_torch.ops import chol_kernel

    c = np.random.default_rng(9).uniform(0, 1, (7, 3))
    monkeypatch.setenv("HOMMX_CHOL_SOLVE_BATCH", "1")
    je, te = _cube_engines(dtype)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    if dtype == "float64":
        je._get_K0diag()  # built on the host before the route traces it
        ref = jax_chunk.tensors_chol_batched(je, JAX_A3, jnp.asarray(c), jax_rotation, 3)
    else:
        ref = je.tensors_for_centers(JAX_A3, jnp.asarray(c, jdt), G_fn=jax_rotation, chunk=3)
    calls, solves = [], []
    batched, solve = chunk.tensors_chol_batched, chunk.fused_chol_solve
    monkeypatch.setattr(chunk, "tensors_chol_batched",
                        lambda *a, **k: calls.append(1) or batched(*a, **k))
    monkeypatch.setattr(chunk, "fused_chol_solve",
                        lambda *a, **k: solves.append(a[0].shape[0]) or solve(*a, **k))
    got = te.tensors_for_centers(TORCH_A3, torch.as_tensor(c, dtype=tdt), G_fn=torch_rotation,
                                 chunk=3)
    assert calls == [1] and solves == [9]  # 7 cells padded to 3 chunks of 3
    assert got.shape == (7, 9, 9) and got.dtype == tdt
    tol = 1e-10 if dtype == "float64" else 5e-6
    ref = np.asarray(ref)
    assert np.abs(got.numpy() - ref).max() / np.abs(ref).max() < tol
    te.tensors_for_centers(TORCH_A3, torch.as_tensor(c, dtype=tdt), G_fn=torch_rotation,
                           chunk=3, with_correctors=True)
    assert calls == [1]
    assert chol_kernel.KERNEL.launches == 0  # the CPU takes the plain version
