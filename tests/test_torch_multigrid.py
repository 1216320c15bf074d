"""The macro multigrid slice through the port, held against the JAX
package in float64 on the CPU: the grid transfers, the static hierarchy
(equal arrays), the Galerkin coarse operator, ``mg_setup`` and one V-cycle,
the MG- and Jacobi-preconditioned CG with its on-device stop test,
``solve_ell``'s dispatch, and ``PoissonHMM`` / ``LinearElasticityHMM`` with
the multigrid CG macro solve end to end.  Mirrors ``tests/test_multigrid.py``
and ``tests/test_macro_f64_cg.py``."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hommx_tpu as hx
import hommx_tpu_torch as ht
from hommx_tpu.ops import multigrid as jmg
from hommx_tpu.ops.dia import dia_spmv as jax_dia_spmv
from hommx_tpu.ops.dia import ell_vals_to_dia as jax_ell_vals_to_dia
from hommx_tpu.ops.function_space import boundary_dofs as jax_boundary_dofs
from hommx_tpu.ops.solvers import _ell_diag as jax_ell_diag
from hommx_tpu.ops.solvers import cg_matfree as jax_cg_matfree
from hommx_tpu.ops.solvers import pcg_prec as jax_pcg_prec
from hommx_tpu.ops.solvers import solve_ell as jax_solve_ell
from hommx_tpu.utils import validation as jval
from hommx_tpu_torch.ops import multigrid as tmg
from hommx_tpu_torch.ops import solvers as tsolvers
from hommx_tpu_torch.ops.dia import DIAOperator, build_dia_from_ell, ell_vals_to_dia
from hommx_tpu_torch.ops.function_space import boundary_dofs
from hommx_tpu_torch.ops.sparse import build_ell_pattern, ell_to_dense
from hommx_tpu_torch.utils import validation as tval
from tests._torch_parity import port_mesh
from tests.test_multigrid import _assembled_system, _iso_hooke

torch.set_num_threads(1)

T = lambda a: torch.as_tensor(np.array(a))  # noqa: E731


# -- transfers --------------------------------------------------------------


@pytest.mark.parametrize(
    "d,diagonal,caxes",
    [(2, "right", (0, 1)), (2, "left", (0, 1)), (2, "right", (0,)),
     (3, "right", (0, 1, 2)), (3, "right", (1, 2)), (3, "right", (2,))],
)
def test_transfers_match_reference(d, diagonal, caxes):
    """Prolongation and restriction equal the reference's on seeded grids,
    and restriction is the exact adjoint of prolongation."""
    rng = np.random.default_rng(3)
    gc = (5, 7) if d == 2 else (3, 5, 4)
    gf = tuple(2 * (g - 1) + 1 if ax in caxes else g for ax, g in enumerate(gc))
    xc, yf = rng.standard_normal(gc + (2,)), rng.standard_normal(gf + (2,))
    P = tmg._prolong_grid(T(xc), d, diagonal, caxes)
    R = tmg._restrict_grid(T(yf), d, diagonal, caxes)
    np.testing.assert_array_equal(
        P.numpy(), np.asarray(jmg._prolong_grid(jnp.asarray(xc), d, diagonal, caxes)))
    np.testing.assert_array_equal(
        R.numpy(), np.asarray(jmg._restrict_grid(jnp.asarray(yf), d, diagonal, caxes)))
    assert abs(float((P * T(yf)).sum() - (T(xc) * R).sum())) < 1e-12


def test_prolongation_reproduces_linears():
    lin = lambda X: 1.0 + 2.0 * X[..., 0] - 0.7 * X[..., 1] + 0.3 * X[..., 2]  # noqa: E731
    grid = lambda n: np.stack(np.meshgrid(*[np.linspace(0, 1, n)] * 3, indexing="ij"), axis=-1)  # noqa: E731
    out = tmg._prolong_grid(T(lin(grid(3)))[..., None], 3, "right", (0, 1, 2))
    np.testing.assert_allclose(out[..., 0].numpy(), lin(grid(5)), rtol=0, atol=1e-14)


# -- hierarchy, setup and V-cycle -------------------------------------------

SYSTEMS = {
    # (mesh, bs, coefficient, kind, Dirichlet marker)
    "square32": lambda: (hx.create_unit_square(32, 32), 1,
                         lambda x: 1.0 + 0.9 * jnp.sin(4 * x[0]) * jnp.cos(4 * x[1]), "scalar",
                         lambda x: np.isclose(x[0], 0) | np.isclose(x[1], 1)),
    "odd15_left": lambda: (hx.create_unit_square(15, 15, diagonal="left"), 1,
                           lambda x: 1.0 + 0.5 * jnp.sin(3 * x[0]) * x[1], "scalar",
                           lambda x: np.isclose(x[0], 0.0)),
    "box4_semi": lambda: (hx.create_box([[0, 0, 0], [1, 0.4, 0.1]], [4, 4, 4]), 1,
                          lambda x: 1.0 + x[0], "scalar", lambda x: np.isclose(x[0], 0.0)),
    "beam8x4x4": lambda: (hx.create_box([[0, 0, 0], [1, 0.4, 0.1]], [8, 4, 4]), 3,
                          _iso_hooke(3, lambda x: 1.0 + 5.0 * x[1], lambda x: 0.5 + 2.0 * x[0]),
                          "tensor4", lambda x: np.isclose(x[0], 0.0)),
}


def _both(name):
    """The BC-applied float64 system of case ``name`` assembled by the JAX
    package, with both packages' hierarchies and DIA values."""
    mesh, bs, coeff, kind, marker = SYSTEMS[name]()
    V, sys, vals_bc, b_bc = _assembled_system(mesh, bs, coeff, kind, marker)
    jstruct = jmg.build_mg_structure(mesh.structure, bs, sys.dia)
    tp = build_ell_pattern(V.cell_dofs_unrolled(), V.num_dofs)
    td = build_dia_from_ell(tp)
    tstruct = tmg.build_mg_structure(port_mesh(mesh).structure, bs, td)
    return dict(sys=sys, vals=np.asarray(vals_bc), b=np.asarray(b_bc), td=td,
                cols=T(tp.cols.astype(np.int64)), jstruct=jstruct, tstruct=tstruct,
                jdvals=jax_ell_vals_to_dia(sys.dia, vals_bc),
                tdvals=ell_vals_to_dia(td, T(vals_bc)))


def _assert_levels_equal(ts, js):
    assert (ts.d, ts.bs, ts.diagonal, ts.fine_offsets) == (js.d, js.bs, js.diagonal, js.fine_offsets)
    for name in ("fine_src", "fine_dst", "real_idx", "ghost_diag_dst"):
        a, b = getattr(ts, name), getattr(js, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a, b)
    assert ts.num_levels == js.num_levels
    for lt, lj in zip(ts.levels, js.levels):
        assert (lt.intervals, lt.grid, lt.node_offsets, lt.coarsen_axes) == (
            lj.intervals, lj.grid, lj.node_offsets, lj.coarsen_axes)
        for name in ("res_masks", "perms", "power_vec"):
            a, b = getattr(lt, name), getattr(lj, name)
            assert (a is None) == (b is None), name
            if a is not None:
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_structure_equals_reference(name):
    """Every array of the hierarchy equals the reference's exactly, the
    seeded power vectors included: the 32² grid, the odd 15² grid (ghost
    padding, 'left' diagonals), a thin 4³ box and the thin 8×4×4 beam at
    bs = 3 (both semicoarsened)."""
    c = _both(name)
    ts, js = c["tstruct"], c["jstruct"]
    assert ts is not None
    _assert_levels_equal(ts, js)
    assert (ts.real_idx is not None) == (name == "odd15_left")
    if name in ("box4_semi", "beam8x4x4"):
        assert ts.levels[1].coarsen_axes != (0, 1, 2)


def _unstructured(mesh):
    return ht.SimplexMesh(mesh.vertices, mesh.cells, None)


@pytest.mark.parametrize("case", ["unstructured", "no_dia", "layout", "too_small"])
def test_structure_none_cases(case):
    """Where the reference declines multigrid, so does the port."""
    m = hx.create_unit_square(2 if case == "too_small" else 16)
    pm = port_mesh(m)
    tdia = build_dia_from_ell(build_ell_pattern(pm.cells, pm.num_vertices))
    jsys = hx.models.common.MacroSystem(hx.FunctionSpace(m, 1), jnp.float64)
    structure, bs, jd, td = m.structure, 1, jsys.dia, tdia
    if case == "unstructured":
        structure = None
        tsys = ht.models.common.MacroSystem(ht.FunctionSpace(_unstructured(pm)), torch.float64, "cpu")
        assert tsys.mg is None
    elif case == "no_dia":
        jd = td = None
    elif case == "layout":
        bs = 2  # the dofs are not the vector grid of this pattern
    assert jmg.build_mg_structure(structure, bs, jd) is None
    assert tmg.build_mg_structure(None if structure is None else pm.structure, bs, td) is None


def _galerkin_ref(struct, state, vals, cols, d):
    """The dense P̃ᵀAP̃ of level 1 (P̃ the BC-masked prolongation, identity
    at the coarse Dirichlet dofs), from the port's own prolongation."""
    bs = struct.bs
    lev_c = struct.levels[1]
    n_f = int(np.prod(struct.levels[0].grid)) * bs
    n_c = int(np.prod(lev_c.grid)) * bs
    A = ell_to_dense(T(vals), cols).numpy()
    if struct.real_idx is not None:  # the padded operator is block-diag(A, I)
        Ap = np.eye(n_f)
        Ap[np.ix_(struct.real_idx, struct.real_idx)] = A
        A = Ap
    zf, zc = state[0]["zmask"].numpy(), state[1]["zmask"].numpy()
    eye = torch.eye(n_c, dtype=torch.float64)
    P = tmg._to_flat(tmg._prolong_grid(tmg._to_grid(eye, lev_c.grid, bs), d, struct.diagonal,
                                       lev_c.coarsen_axes), n_f, d).numpy()
    Pt = zf[:, None] * P * zc[None, :]
    Ac = Pt.T @ A @ Pt
    np.fill_diagonal(Ac, np.where(zc == 0, 1.0, np.diag(Ac)))
    return Ac


@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_setup_and_vcycle_match_reference(name):
    """The probed coarse operator equals the dense Galerkin product to
    1e-12; every level of ``mg_setup`` (stencil blocks, keep-masks, λmax)
    equals the reference's to 1e-12 relative, and so do the bottom inverse
    and one ``mg_vcycle``, where the bottom matrix allows it: two correct
    inverses of a matrix of condition κ differ by up to ~κ·eps, so those
    two are held to max(1e-12, 1e-16·κ) (κ ≈ 3e5 on the beam's bottom
    level, where they differ by 3.6e-12)."""
    c = _both(name)
    ts, js = c["tstruct"], c["jstruct"]
    tstate = tmg.mg_setup(ts, c["tdvals"])
    jstate = jmg.mg_setup(js, c["jdvals"])
    d = ts.d
    Ac_ref = _galerkin_ref(ts, tstate, c["vals"], c["cols"], d)
    Ac = tmg._dense_from_stencil(ts, 1, tstate[1]["bvals"]).numpy()
    assert np.abs(Ac - Ac_ref).max() / np.abs(Ac_ref).max() < 1e-12

    def rel(a, b):
        b = np.asarray(b)
        return np.abs(a.numpy() - b).max() / max(np.abs(b).max(), 1e-300)

    assert len(tstate) == len(jstate) == ts.num_levels
    for st, sj in zip(tstate, jstate):
        assert rel(st["bvals"], sj["bvals"]) < 1e-12
        np.testing.assert_array_equal(st["zmask"].numpy(), np.asarray(sj["zmask"]))
        if "lmax" in sj:
            assert rel(st["lmax"], sj["lmax"]) < 1e-12
            assert st["lmax"].ndim == 0
    bottom = tmg._dense_from_stencil(ts, ts.num_levels - 1, tstate[-1]["bvals"]).numpy()
    tol = max(1e-12, 1e-16 * np.linalg.cond(bottom))
    assert rel(tstate[-1]["binv"], jstate[-1]["binv"]) < tol
    r = np.random.default_rng(5).standard_normal(c["b"].shape[0])
    z = tmg.mg_vcycle(ts, tstate, T(r))
    assert rel(z, jmg.mg_vcycle(js, jstate, jnp.asarray(r))) < tol
    # the static index arrays went to the device once: a second setup
    # reuses the cached tensors
    cached = dict(ts._dev)
    tmg.mg_setup(ts, c["tdvals"])
    assert all(ts._dev[k] is v for k, v in cached.items())


@pytest.mark.parametrize("name", ["square32", "beam8x4x4"])
def test_f32_bottom_guard_matches_reference(name):
    """The float32 setup with ``f32_bottom_guard`` (equilibrated, shifted
    bottom inverse) against the reference's in float32: the bottom inverse
    and one V-cycle within 1e-4, far inside what the guard itself moves."""
    c = _both(name)
    ts, js = c["tstruct"], c["jstruct"]
    tstate = tmg.mg_setup(ts, c["tdvals"].float(), f32_bottom_guard=True)
    jstate = jmg.mg_setup(js, jnp.asarray(np.asarray(c["jdvals"]), dtype=jnp.float32),
                          f32_bottom_guard=True)
    binv, binv_ref = tstate[-1]["binv"].numpy(), np.asarray(jstate[-1]["binv"])
    assert binv.dtype == binv_ref.dtype == np.float32
    scale = np.abs(binv_ref).max()
    diff = np.abs(binv - binv_ref).max() / scale
    unguarded = tmg.mg_setup(ts, c["tdvals"].float())[-1]["binv"].numpy()
    assert diff < 1e-4 and np.abs(unguarded - binv_ref).max() / scale > 10 * diff
    r = np.random.default_rng(5).standard_normal(c["b"].shape[0]).astype(np.float32)
    z = tmg.mg_vcycle(ts, tstate, T(r)).numpy()
    z_ref = np.asarray(jmg.mg_vcycle(js, jstate, jnp.asarray(r)))
    assert np.abs(z - z_ref).max() / np.abs(z_ref).max() < 1e-4


# -- the CG loop ------------------------------------------------------------


@pytest.mark.parametrize("check_every", [1, 16])
@pytest.mark.parametrize("pc", ["mg", "jacobi"])
def test_pcg_prec_matches_reference(monkeypatch, pc, check_every):
    """MG- and Jacobi-preconditioned CG on the 32² system: x within 1e-10
    of the reference's and the same iteration count, whatever the host's
    check interval; the host reads the stop flag at most
    ⌈iterations / _CHECK_EVERY⌉ + 2 times."""
    c = _both("square32")
    ts, js = c["tstruct"], c["jstruct"]
    b = c["b"]
    op = DIAOperator(c["tdvals"], c["td"].offsets)
    if pc == "mg":
        tstate, jstate = tmg.mg_setup(ts, c["tdvals"]), jmg.mg_setup(js, c["jdvals"])
        tprec = lambda r: tmg.mg_vcycle(ts, tstate, r)  # noqa: E731
        jprec = lambda r: jmg.mg_vcycle(js, jstate, r)  # noqa: E731
    else:
        tdiag = tsolvers._ell_diag(T(c["vals"]), c["cols"])
        tprec = lambda r: torch.where(tdiag.abs() > 0, 1.0 / tdiag, 1.0) * r  # noqa: E731
        jdiag = jax_ell_diag(jnp.asarray(c["vals"]), c["sys"].cols)
        jprec = lambda r: jnp.where(jnp.abs(jdiag) > 0, 1.0 / jdiag, 1.0) * r  # noqa: E731
    jmatvec = lambda v: jax_dia_spmv(c["jdvals"], c["sys"].dia.offsets, v)  # noqa: E731
    x_ref, k_ref, _ = jax_pcg_prec(jmatvec, jprec, jnp.asarray(b), rtol=1e-10, atol=0.0)
    monkeypatch.setattr(tsolvers, "_CHECK_EVERY", check_every)
    tsolvers.STOP_TEST.readbacks = 0
    x, k, res = tsolvers.pcg_prec(lambda v: op(v, out=op.out), tprec, T(b), rtol=1e-10, atol=0.0)
    assert k == int(k_ref) and k > 0
    assert np.abs(x.numpy() - np.asarray(x_ref)).max() < 1e-10 * np.abs(np.asarray(x_ref)).max()
    assert tsolvers.STOP_TEST.readbacks <= math.ceil(k / check_every) + 2
    assert float(res) <= 1e-10 * np.linalg.norm(b)
    if pc == "mg":
        assert k < 20


def test_pcg_prec_frozen_iterate_and_maxiter():
    """A solve whose rhs is already solved stops before its first step;
    ``maxiter`` caps the count exactly, with the host check interval not a
    divisor of it."""
    c = _both("square32")
    op = DIAOperator(c["tdvals"], c["td"].offsets)
    mv = lambda v: op(v)  # noqa: E731
    x, k, res = tsolvers.pcg_prec(mv, lambda r: r, torch.zeros(c["b"].shape[0], dtype=torch.float64))
    assert k == 0 and float(res) == 0.0 and not x.abs().max() > 0
    x, k, _ = tsolvers.pcg_prec(mv, lambda r: r, T(c["b"]), rtol=1e-14, atol=0.0, maxiter=21)
    x_ref, k_ref, _ = jax_pcg_prec(lambda v: jax_dia_spmv(c["jdvals"], c["sys"].dia.offsets, v),
                                   lambda r: r, jnp.asarray(c["b"]), rtol=1e-14, atol=0.0,
                                   maxiter=21)
    assert k == int(k_ref) == 21
    np.testing.assert_allclose(x.numpy(), np.asarray(x_ref), rtol=0,
                               atol=1e-11 * np.abs(np.asarray(x_ref)).max())


def _poisson64():
    """A 64² Poisson system (4225 dofs, above ``direct_threshold``)."""
    return _assembled_system(hx.create_unit_square(64, 64), 1,
                             lambda x: 1.0 + 0.9 * jnp.sin(4 * x[0]) * jnp.cos(4 * x[1]),
                             "scalar", lambda x: np.isclose(x[0], 0) | np.isclose(x[1], 0))


def test_solve_ell_auto_takes_mg_above_threshold():
    """Default options above ``direct_threshold``: MG-PCG, as the
    reference dispatches it; the same x to 1e-10 and the same iterations;
    a CUDA-free CPU run makes one DIA operator and reads the host a
    bounded number of times."""
    mesh = hx.create_unit_square(64, 64)
    V, sys, vals_bc, b_bc = _poisson64()
    opts_j, opts_t = hx.SolverOptions(), ht.SolverOptions()
    assert V.num_dofs > opts_t.direct_threshold and opts_t.pc == "auto"
    x_ref, k_ref, _ = jax_solve_ell(vals_bc, sys.cols, b_bc, opts_j, dia=sys.dia, mg=sys.mg)
    pm = port_mesh(mesh)
    tsys = ht.models.common.MacroSystem(ht.FunctionSpace(pm), torch.float64, "cpu")
    mg, amg = ht.models.common.macro_precs(tsys, opts_t)
    assert mg is tsys.mg and mg is not None and amg is None
    tsolvers.STOP_TEST.readbacks = 0
    x, k, _ = tsolvers.solve_ell(T(vals_bc), tsys.cols, T(b_bc), opts_t, dia=tsys.dia, mg=mg)
    assert k == int(k_ref) and 0 < k < 20
    assert np.abs(x.numpy() - np.asarray(x_ref)).max() < 1e-10 * np.abs(np.asarray(x_ref)).max()
    assert tsolvers.STOP_TEST.readbacks <= math.ceil(k / tsolvers._CHECK_EVERY) + 2
    # the direct and Jacobi routes build no hierarchy
    assert ht.models.common.macro_precs(tsys, ht.SolverOptions(method="direct")) == (None, None)
    assert ht.models.common.macro_precs(tsys, ht.SolverOptions(pc="jacobi")) == (None, None)


def test_solve_ell_without_hierarchy_raises_a10():
    """With no geometric hierarchy and no AMG hierarchy, ``pc`` 'auto'/'mg'
    take Jacobi CG, as the reference does (this case raised before the
    aggregation AMG was ported): the same x to 1e-10 and the same
    iterations on the 64² system's DIA view; and an unstructured 4² HMM
    (25 dofs, below the AMG bottom size) with method='cg' solves to the
    reference's u (1e-10) in its iterations."""
    V, sys, vals_bc, b_bc = _poisson64()
    tp = build_ell_pattern(V.cell_dofs_unrolled(), V.num_dofs)
    cols, td = T(tp.cols.astype(np.int64)), build_dia_from_ell(tp)
    for pc in ("auto", "mg"):
        opts = dict(method="cg", pc=pc, rtol=1e-10, atol=0.0)
        x, k, _ = tsolvers.solve_ell(T(vals_bc), cols, T(b_bc), ht.SolverOptions(**opts), dia=td)
        x_ref, k_ref, _ = jax_solve_ell(vals_bc, sys.cols, b_bc, hx.SolverOptions(**opts),
                                        dia=sys.dia)
        assert k == int(k_ref) and k > 20
        np.testing.assert_allclose(x.numpy(), np.asarray(x_ref), rtol=0,
                                   atol=1e-10 * np.abs(np.asarray(x_ref)).max())
    jm = hx.create_unit_square(4)
    jm = hx.SimplexMesh(jm.vertices, jm.cells, None)
    opts = dict(method="cg", rtol=1e-12, atol=0.0)
    hmm = ht.PoissonHMM(_unstructured(port_mesh(jm)), lambda x, y: 1.0 + 0.5 * x[0] + 0.0 * y[0],
                        1.0, ht.create_unit_square(4), 0.1, ht.SolverOptions(**opts),
                        device="cpu")
    u = hmm.solve()
    ref = hx.PoissonHMM(jm, lambda x, y: 1.0 + 0.5 * x[0] + 0.0 * y[0], lambda x: 1.0,
                        hx.create_unit_square(4), 0.1, hx.SolverOptions(**opts))
    u_ref = np.asarray(ref.solve().array)
    assert hmm._sys.mg is None and hmm._sys.amg is None
    assert hmm.diagnostics["macro_iterations"] == ref.diagnostics["macro_iterations"] > 0
    assert hmm.diagnostics["macro_amg_levels"] is None
    np.testing.assert_allclose(u.array.numpy(), u_ref, rtol=0, atol=1e-10 * np.abs(u_ref).max())


# -- end to end -------------------------------------------------------------


def test_poisson_hmm_mg_cg_matches_reference():
    """``PoissonHMM`` on a 32² macro mesh with an 8² micro mesh, float64,
    multigrid CG to rtol 1e-11: u within 1e-10 of the reference's and the
    same iteration count."""
    jmac, jmic = hx.create_unit_square(32), hx.create_unit_square(8)
    opts = dict(method="cg", rtol=1e-11)
    hj = hx.PoissonHMM(jmac, lambda x, y: 1.1 + x[0] + jnp.sin(2 * jnp.pi * y[0]), 1.0, jmic,
                       2**-5, options_global_solve=hx.SolverOptions(**opts),
                       dedup_cells=False, engine_kwargs={"solver": "pcg", "pcg_tol": 1e-13})
    u_ref = np.asarray(hj.solve().array)
    h = ht.PoissonHMM(port_mesh(jmac), lambda x, y: 1.1 + x[0] + torch.sin(2 * torch.pi * y[0]),
                      1.0, port_mesh(jmic), 2**-5, ht.SolverOptions(**opts), device="cpu",
                      dedup_cells=False, engine_kwargs={"pcg_tol": 1e-13})
    u = h.solve().array.numpy()
    assert h._macro_method == "cg" and h._sys.mg is not None
    assert h.diagnostics["macro_iterations"] == hj.diagnostics["macro_iterations"]
    assert 0 < h.diagnostics["macro_iterations"] < 20
    assert np.abs(u - u_ref).max() / np.abs(u_ref).max() < 1e-10


def test_elasticity_hmm_mg_cg_matches_reference(monkeypatch):
    """``LinearElasticityHMM`` on the 6×4×2 box forced onto the CG route:
    float64 assembly and a float64 MG-PCG, against the reference's
    native-float64 V-cycle (``HOMMX_MG_PREC=native``) to 1e-9 relative,
    and against the port's own direct route."""
    monkeypatch.setenv("HOMMX_MG_PREC", "native")

    def jfib(a, b):
        da = jnp.arccos(jnp.cos(2 * jnp.pi * (a - 0.5)))
        db = jnp.arccos(jnp.cos(2 * jnp.pi * (b - 0.5)))
        return (da**2 + db**2) < (2 * jnp.pi) ** 2 / 16

    def tfib(a, b):
        da = torch.arccos(torch.cos(2 * torch.pi * (a - 0.5)))
        db = torch.arccos(torch.cos(2 * torch.pi * (b - 0.5)))
        return (da**2 + db**2) < (2 * torch.pi) ** 2 / 16

    def tmu(x, y):
        one = torch.ones((), dtype=y.dtype)
        return torch.where(tfib(y[1], y[2]), 100.0 * (1 + 0.001 * x[0]) * one, 0.001 * one)

    jA = jval.hooke_tensor(3, lambda x, y: jnp.where(jfib(y[1], y[2]), 100.0 * (1 + 0.001 * x[0]),
                                                     0.001), lambda x, y: 1.0)
    tA = tval.hooke_tensor(3, tmu, lambda x, y: 1.0)
    jmac, jmic = hx.create_box([[0, 0, 0], [1.0, 0.4, 0.1]], [6, 4, 2]), hx.create_unit_cube(3)
    clamp = lambda x: np.isclose(x[0], 0)  # noqa: E731
    hj = hx.LinearElasticityHMM(jmac, jA, lambda x: jnp.array([0.0, 0.0, -0.01]), jmic, 2**-5,
                                dtype=jnp.float64, options_global_solve=hx.SolverOptions(method="cg"))
    hj.set_boundary_conditions(hx.dirichletbc(np.zeros(3), jax_boundary_dofs(hj.function_space, clamp),
                                              hj.function_space))
    u_ref = np.asarray(hj.solve().array)

    def port(method):
        h = ht.LinearElasticityHMM(port_mesh(jmac), tA,
                                   lambda x: torch.tensor([0.0, 0.0, -0.01], dtype=torch.float64),
                                   port_mesh(jmic), 2**-5, ht.SolverOptions(method=method),
                                   device="cpu")
        V = h.function_space
        h.set_boundary_conditions(ht.dirichletbc(np.zeros(3), boundary_dofs(V, clamp), V))
        return h, h.solve().array.numpy()

    h, u = port("cg")
    assert h._macro_method == "cg" and h._macro_f64 and h._sys.mg is not None
    assert 0 < h.diagnostics["macro_iterations"] < 100
    assert np.linalg.norm(u - u_ref) / np.linalg.norm(u_ref) < 1e-9
    _, u_direct = port("direct")
    assert np.linalg.norm(u - u_direct) / np.linalg.norm(u_direct) < 1e-9
