"""The unstructured macro path through the port on the CPU, mirroring
tests/test_amg.py: Delaunay and file meshes, the aggregation-AMG hierarchy
(equal arrays), ``amg_setup``'s coarse operators, one V-cycle, the
fixed-order gather tables that replace its scatter-adds on CUDA, the
AMG-preconditioned CG, ``macro_precs``' routing, the models end to end on
Delaunay and P2 systems, and ``build_pipeline``'s derivatives through the
AMG-CG.  Each case runs the JAX package and the port on the same input in
this process, in float64, at the tolerance written in the case."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hommx_tpu as hx
import hommx_tpu_torch as ht
from hommx_tpu.meshes import mesh_from_delaunay as jax_mesh_from_delaunay
from hommx_tpu.meshes import mesh_from_file as jax_mesh_from_file
from hommx_tpu.ops import amg as jamg
from hommx_tpu.utils import validation as jval
from hommx_tpu.utils.options import SolverOptions as JaxOptions
from hommx_tpu_torch.models.common import MacroSystem, macro_precs
from hommx_tpu_torch.ops import amg as tamg
from hommx_tpu_torch.ops import solvers as tsolvers
from hommx_tpu_torch.ops.sparse import ell_to_dense
from hommx_tpu_torch.utils import validation as tval
from tests.test_amg import _delaunay_mesh, _system
from tests.test_multigrid import _assembled_system

torch.set_num_threads(1)

T = lambda a: torch.as_tensor(np.array(a))  # noqa: E731
F64 = torch.float64


def _port(jm) -> ht.SimplexMesh:
    return ht.SimplexMesh(np.asarray(jm.vertices), np.asarray(jm.cells), None)


def _hooke2(x):
    lam, mu = 1.0 + 0.3 * x[0], 0.5
    eye = jnp.eye(2)
    return lam * jnp.einsum("ij,kl->ijkl", eye, eye) + mu * (
        jnp.einsum("ik,jl->ijkl", eye, eye) + jnp.einsum("il,jk->ijkl", eye, eye))


@functools.lru_cache(maxsize=None)
def _case(name):
    """A float64 system assembled by the JAX package on a jittered Delaunay
    mesh, Dirichlet on x = 0, with the port's MacroSystem on the same mesh:
    scalar on 40² (1681 dofs) or 56² (3249), elasticity on 40² (3362)."""
    n = {"scalar40": 40, "scalar56": 56, "elastic40": 40}[name]
    bs = 2 if name.startswith("elastic") else 1
    jm = _delaunay_mesh(n)
    if bs == 1:
        V, sys, vals_bc, b_bc = _system(jm)
    else:
        V, sys, vals_bc, b_bc = _assembled_system(jm, 2, _hooke2, "tensor4",
                                                  lambda x: np.isclose(x[0], 0.0))
    tsys = MacroSystem(ht.FunctionSpace(_port(jm), bs), F64, "cpu")
    return dict(jm=jm, sys=sys, tsys=tsys, vals=np.asarray(vals_bc), b=np.asarray(b_bc), bs=bs)


@functools.lru_cache(maxsize=None)
def _structures(name, variant, bottom_max=None):
    """(reference, port) hierarchies of a case: 'smoothed' (translations,
    or the rigid modes on elasticity), 'plain' or 'translations'."""
    c = _case(name)
    smoothed = variant != "plain"
    nk = c["sys"]._rigid_modes() if variant == "smoothed" and c["bs"] > 1 else None
    tnk = c["tsys"]._rigid_modes() if variant == "smoothed" and c["bs"] > 1 else None
    js = jamg.build_amg_structure(c["sys"].pattern, c["bs"], bottom_max=bottom_max,
                                  smoothed=smoothed, near_kernel=nk)
    ts = tamg.build_amg_structure(c["tsys"].pattern, c["bs"], bottom_max=bottom_max,
                                  smoothed=smoothed, near_kernel=tnk)
    return js, ts


VARIANTS = [("scalar40", "smoothed"), ("scalar40", "plain"), ("elastic40", "smoothed")]
IDS = ["smoothed", "plain", "elasticity_rigid"]


# -- meshes -------------------------------------------------------------------


def test_mesh_constructors_match_reference(tmp_path):
    """mesh_from_delaunay (two columns, and three with a zero third column)
    and mesh_from_file (an .npz of points and elements) give the
    reference's arrays exactly, with no BoxStructure."""
    from scipy.spatial import Delaunay

    pts = np.random.default_rng(4).uniform(0, 1, (60, 2))
    tri = Delaunay(pts).simplices
    pts3 = np.concatenate([pts, np.zeros((60, 1))], axis=1)
    np.savez(tmp_path / "mesh.npz", points=pts3, elements=tri)
    for tm, jm in ((ht.mesh_from_delaunay(pts, tri), jax_mesh_from_delaunay(pts, tri)),
                   (ht.mesh_from_delaunay(pts3, tri), jax_mesh_from_delaunay(pts3, tri)),
                   (ht.mesh_from_file(str(tmp_path / "mesh.npz")),
                    jax_mesh_from_file(str(tmp_path / "mesh.npz")))):
        for a, b in ((tm.vertices, jm.vertices), (tm.cells, jm.cells)):
            assert a.dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a, np.asarray(b))
        assert tm.structure is None and tm.dim == 2
    assert ht.helpers.mesh_from_file is ht.mesh_from_file
    assert ht.meshes.mesh_from_delaunay is ht.helpers.mesh_from_delaunay


# -- the hierarchy ------------------------------------------------------------


@pytest.mark.parametrize("name,variant", VARIANTS, ids=IDS)
def test_structure_arrays_equal_reference(name, variant):
    """Every level's arrays equal the reference's exactly (values and
    dtypes), with ``bottom_max`` lowered to 300 so the 40² meshes take 3
    levels; the rigid modes equal the reference's too."""
    c = _case(name)
    if c["bs"] > 1:
        np.testing.assert_array_equal(c["tsys"]._rigid_modes(), c["sys"]._rigid_modes())
    js, ts = _structures(name, variant, bottom_max=300)
    assert ts.num_levels == js.num_levels >= 3 and ts.smoothed == js.smoothed
    assert ts.level_sizes == [lev.n_dofs for lev in js.levels]
    for jl, tl in zip(js.levels, ts.levels):
        for f in dataclasses.fields(jl):
            a, b = getattr(jl, f.name), getattr(tl, f.name)
            if isinstance(a, tuple):
                assert len(a) == len(b)
                for x, y in zip(a, b):
                    assert x.dtype == y.dtype
                    np.testing.assert_array_equal(x, y)
            elif isinstance(a, np.ndarray):
                assert a.dtype == b.dtype, f.name
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b, f.name
    assert set(ts.timings) == {"sweep", "qr", "sa_maps", "total"}


def _dense_P(lev, state):
    """The level's prolongation as a dense (N, Nc) numpy matrix."""
    N = lev.n_dofs
    if "Pv" in state:
        KP = lev.p_cols.shape[1]
        P = np.zeros((N, int(lev.p_cols.max()) + 1))
        np.add.at(P, (np.arange(N * KP) // KP, lev.p_cols.reshape(-1)),
                  np.asarray(state["Pv"]))
        return P
    P = np.zeros((N, int(lev.agg_dof.max()) + 1))
    P[np.arange(N), lev.agg_dof] = np.asarray(state["zmask"])
    return P


def _jitted_setup(js):
    """The reference's amg_setup under jit, as its solvers run it (one
    compile, not an eager dispatch per operation): the state without its
    smoother closures."""
    return jax.jit(lambda v: [{k: x for k, x in d.items() if k != "papply"}
                              for d in jamg.amg_setup(js, v)])


@pytest.mark.parametrize("name,variant", VARIANTS, ids=IDS)
def test_setup_coarse_operators(name, variant):
    """amg_setup's level-1 operator equals the dense PᵀAP (P from the port's
    own P values, or the masked piecewise constants; identity on empty
    diagonals) to 1e-12, and every level's values, P values, masks, λmax
    and the bottom inverse equal the reference's to 1e-12."""
    c = _case(name)
    js, ts = _structures(name, variant, bottom_max=300)
    jst = _jitted_setup(js)(jnp.asarray(c["vals"]))
    tst = tamg.amg_setup(ts, T(c["vals"]))
    lev0, lev1 = ts.levels[0], ts.levels[1]
    A = ell_to_dense(T(c["vals"]), T(lev0.cols.astype(np.int64))).numpy()
    P = _dense_P(lev0, tst[0])
    Ac = P.T @ A @ P
    empty = np.abs(np.diag(Ac)) == 0
    Ac[empty, empty] = 1.0
    got = ell_to_dense(tst[1]["vals"], T(lev1.cols.astype(np.int64))).numpy()
    assert np.abs(got - Ac).max() <= 1e-12 * np.abs(Ac).max()
    for li, (a, b) in enumerate(zip(jst, tst)):
        assert set(a) <= set(b)
        for key in a:
            if key == "cols":
                continue
            ref = np.asarray(a[key])
            err = np.abs(b[key].numpy() - ref).max()
            assert err <= 1e-12 * max(np.abs(ref).max(), 1e-300), (li, key, err)


@pytest.mark.parametrize("name,variant", VARIANTS, ids=IDS)
def test_vcycle_matches_reference(name, variant):
    """One V-cycle on a seeded residual equals the reference's to 1e-12."""
    c = _case(name)
    js, ts = _structures(name, variant, bottom_max=300)
    tst = tamg.amg_setup(ts, T(c["vals"]))
    r = np.random.default_rng(7).standard_normal(c["b"].shape[0])
    z_ref = np.asarray(jax.jit(lambda v, r: jamg.amg_vcycle(js, jamg.amg_setup(js, v), r))(
        jnp.asarray(c["vals"]), jnp.asarray(r)))
    z = tamg.amg_vcycle(ts, tst, T(r)).numpy()
    assert np.abs(z - z_ref).max() <= 1e-12 * np.abs(z_ref).max()


# -- the fixed-order gathers of the CUDA route --------------------------------


@pytest.mark.parametrize("name,variant", VARIANTS, ids=IDS)
def test_gather_tables_equal_scatters(name, variant, monkeypatch):
    """Each scatter-add of the setup and the cycle, inverted into a
    GatherPlan (or the restriction's padded table) and summed by gathers
    on the CPU, equals the in-order index_add_ of seeded sources to 1e-13;
    the whole setup and cycle on the gather route (the CUDA one, forced
    here) equal the scatter route's to 1e-12."""
    c = _case(name)
    _, ts = _structures(name, variant, bottom_max=300)
    rng = np.random.default_rng(11)
    vals = T(c["vals"])
    r = T(rng.standard_normal(c["b"].shape[0]))
    st = tamg.amg_setup(ts, vals)
    z = tamg.amg_vcycle(ts, st, r)
    monkeypatch.setattr(tamg, "_fixed_order", lambda device: True)
    for li in range(ts.num_levels - 1):
        tab = ts.tables(li, "cpu", F64)
        for nm, (targets, n_t) in tamg._sum_targets(ts, li).items():
            fixed = getattr(tab, nm + "_sum")
            assert fixed.targets is None and (fixed.table is None) == (nm != "restrict")
            src = T(rng.standard_normal(np.asarray(targets).size))
            ref = torch.zeros(n_t + 1, dtype=F64).index_add_(
                0, T(np.minimum(targets, n_t)), src)[:n_t]
            got = fixed(src)
            assert got.shape == (n_t,)
            assert (got - ref).abs().max() <= 1e-13 * ref.abs().max(), (li, nm)
    st_g = tamg.amg_setup(ts, vals)
    z_g = tamg.amg_vcycle(ts, st_g, r)
    monkeypatch.undo()
    for a, b in zip(st, st_g):
        for key in ("vals", "Pv", "binv"):
            if key in a:
                assert (a[key] - b[key]).abs().max() <= 1e-12 * a[key].abs().max(), key
    assert (z - z_g).abs().max() <= 1e-12 * z.abs().max()


# -- the AMG-preconditioned CG ------------------------------------------------


def _cg_pair(name, amg_pair, rtol=1e-11):
    """The reference's and the port's solve_ell with pc='auto' and the given
    AMG structures (the reference's jitted, as its models run it)."""
    c = _case(name)
    opts = dict(method="cg", rtol=rtol, atol=0.0, maxiter=600)
    js, ts = amg_pair
    x_ref, k_ref, _ = jax.jit(lambda v, b: hx.ops.solvers.solve_ell(
        v, c["sys"].cols, b, JaxOptions(**opts), dia=c["sys"].dia, amg=js))(
            jnp.asarray(c["vals"]), jnp.asarray(c["b"]))
    x, k, _ = tsolvers.solve_ell(T(c["vals"]), c["tsys"].cols, T(c["b"]),
                                 ht.SolverOptions(**opts), dia=c["tsys"].dia, amg=ts)
    return x.numpy(), k, np.asarray(x_ref), int(k_ref)


@functools.lru_cache(maxsize=None)
def _jacobi_iterations(name):
    c = _case(name)
    _, k, _ = tsolvers.cg_ell(T(c["vals"]), c["tsys"].cols, T(c["b"]), atol=0.0, rtol=1e-11,
                              maxiter=20000)
    return k


@pytest.mark.parametrize(
    "name,variant,max_its",
    [("scalar56", "smoothed", 15), ("scalar56", "plain", 33), ("elastic40", "smoothed", 25),
     ("elastic40", "translations", 35), ("elastic40", "plain", 60)],
    ids=["smoothed", "plain", "elasticity_rigid", "elasticity_translations", "elasticity_plain"],
)
def test_amg_pcg_matches_direct_and_reference(name, variant, max_its):
    """AMG-PCG on the 56² scalar system (3249 dofs, the default bottom size
    1500) and the 40² elasticity system (3362 dofs, bottom size 300: at
    1500 the reference's rigid-mode bottom is NaN, see
    test_semidefinite_bottom_takes_pseudo_inverse): x within 1e-9 of the
    direct solve, the reference's iteration count exactly, the reference's
    bars on the count (set at 56²), and at least 3× (scalar) or 5×
    (elasticity) fewer iterations than Jacobi CG."""
    c = _case(name)
    bottom = 300 if c["bs"] > 1 else None
    x, k, x_ref, k_ref = _cg_pair(name, _structures(name, variant, bottom_max=bottom))
    x_dir = tsolvers.dense_solve_ell(T(c["vals"]), c["tsys"].cols, T(c["b"])).numpy()
    scale = np.abs(x_dir).max()
    assert np.abs(x - x_dir).max() < 1e-9 * scale
    assert np.abs(x - x_ref).max() < 1e-9 * scale
    assert k == k_ref and 0 < k <= max_its
    assert k * (3 if c["bs"] == 1 else 5) < _jacobi_iterations(name)


def test_macro_precs_routing():
    """macro_precs routes an unstructured CG system to AMG (the rigid modes
    on elasticity, equal to a structure built from them), a structured one
    to geometric MG, the direct and Jacobi options to nothing, and a system
    at or below the bottom size to Jacobi (amg None), as the reference
    does."""
    opts = ht.SolverOptions(method="cg", rtol=1e-11, atol=0.0)
    for name in ("scalar56", "elastic40"):
        c = _case(name)
        mg, amg = macro_precs(c["tsys"], opts)
        jmg, jamg_ = hx.models.common.macro_precs(c["sys"], JaxOptions(method="cg"))
        assert mg is None and jmg is None and amg is c["tsys"].amg and amg.smoothed
        assert amg.level_sizes == [lev.n_dofs for lev in jamg_.levels]
        for jl, tl in zip(jamg_.levels, amg.levels):
            np.testing.assert_array_equal(tl.p_cols, jl.p_cols)
            np.testing.assert_array_equal(tl.p0_w, jl.p0_w)
    c = _case("scalar40")
    assert macro_precs(c["tsys"], ht.SolverOptions(method="direct")) == (None, None)
    assert macro_precs(c["tsys"], ht.SolverOptions(pc="jacobi")) == (None, None)
    tsys = MacroSystem(ht.FunctionSpace(ht.create_unit_square(24, 24)), F64, "cpu")
    mg, amg = macro_precs(tsys, opts)
    assert mg is not None and amg is None
    small = MacroSystem(ht.FunctionSpace(_port(_delaunay_mesh(30))), F64, "cpu")
    assert small.V.num_dofs == 961 and macro_precs(small, opts) == (None, None)


def test_semidefinite_bottom_takes_pseudo_inverse():
    """The 40² elasticity system with the rigid modes at the default bottom
    size coarsens once (3362 -> 1419) to a bottom operator with 7 null
    eigenvalues: the reference's Cholesky inverse is NaN there (a known
    fault of the reference), the port's bottom is the pseudo-inverse, and
    its PCG solves to the direct solve within 1e-9 in at most 40
    iterations, 5x fewer than Jacobi."""
    c = _case("elastic40")
    js, ts = _structures("elastic40", "smoothed")
    assert ts.level_sizes == [3362, 1419]
    assert not np.isfinite(np.asarray(_jitted_setup(js)(jnp.asarray(c["vals"]))[-1]["binv"])).all()
    st = tamg.amg_setup(ts, T(c["vals"]))
    assert st[-1]["bottom_pinv"] and bool(torch.isfinite(st[-1]["binv"]).all())
    x, k, _ = tsolvers.solve_ell(T(c["vals"]), c["tsys"].cols, T(c["b"]),
                                 ht.SolverOptions(method="cg", rtol=1e-11, atol=0.0, maxiter=600),
                                 dia=c["tsys"].dia, amg=ts)
    x_dir = tsolvers.dense_solve_ell(T(c["vals"]), c["tsys"].cols, T(c["b"])).numpy()
    assert np.abs(x.numpy() - x_dir).max() < 1e-9 * np.abs(x_dir).max()
    assert 0 < k <= 40 and 5 * k < _jacobi_iterations("elastic40")
    # a Cholesky that succeeds takes no pseudo-inverse
    _, ts300 = _structures("elastic40", "smoothed", bottom_max=300)
    assert not tamg.amg_setup(ts300, T(c["vals"]))[-1]["bottom_pinv"]


# -- the models end to end ----------------------------------------------------


def _jax_A(x, y):
    return 1.1 + x[0] + jnp.sin(2 * jnp.pi * y[0])


def _torch_A(x, y):
    return 1.1 + x[0] + torch.sin(2 * torch.pi * y[0])


CG = dict(method="cg", rtol=1e-12, atol=0.0)


def _rel(a, ref) -> float:
    ref = np.asarray(ref)
    return float(np.abs(np.asarray(a) - ref).max() / np.abs(ref).max())


def test_poisson_hmm_on_delaunay_mesh():
    """PoissonHMM on the 40² Delaunay mesh (1681 dofs, 4² micro) with
    method='cg' takes the AMG-CG in the reference's iterations and gives
    its u to 1e-8; diagnostics carry the levels' sizes."""
    jm = _delaunay_mesh(40)
    ref = hx.PoissonHMM(jm, _jax_A, lambda x: 1.0, hx.create_unit_square(4), 2**-5,
                        JaxOptions(**CG))
    u_ref = np.asarray(ref.solve().array)
    hmm = ht.PoissonHMM(_port(jm), _torch_A, lambda x: 1.0, ht.create_unit_square(4), 2**-5,
                        ht.SolverOptions(**CG), device="cpu")
    u = hmm.solve().array.numpy()
    d = hmm.diagnostics
    assert d["macro_amg_levels"] == hmm._sys.amg.level_sizes
    assert d["macro_amg_levels"][0] == 1681 and len(d["macro_amg_levels"]) >= 2
    assert d["macro_iterations"] == ref.diagnostics["macro_iterations"] > 0
    assert _rel(u, u_ref) < 1e-8


def test_periodic_hmm_on_delaunay_mesh():
    """PoissonPeriodicHMM on the same mesh with zero Dirichlet BCs and
    method='cg': the AMG-CG gives the reference's u to 1e-8 in its
    iterations."""
    jm = _delaunay_mesh(40)
    A_j = lambda y: 2.0 + jnp.sin(2 * jnp.pi * y[0])  # noqa: E731
    A_t = lambda y: 2.0 + torch.sin(2 * torch.pi * y[0])  # noqa: E731
    ref = hx.PoissonPeriodicHMM(jm, A_j, lambda x: 1.0, hx.create_unit_square(4), 0.1,
                                JaxOptions(**CG))
    ref.set_boundary_conditions(jval.zero_dirichlet_bcs(ref.function_space))
    u_ref = ref.solve()
    per = ht.PoissonPeriodicHMM(_port(jm), A_t, lambda x: 1.0, ht.create_unit_square(4), 0.1,
                                ht.SolverOptions(**CG), device="cpu")
    per.set_boundary_conditions(tval.zero_dirichlet_bcs(per.function_space))
    u = per.solve().array.numpy()
    assert per.diagnostics["macro_amg_levels"] == per._sys.amg.level_sizes
    assert per.diagnostics["macro_amg_levels"][0] == 1681
    assert per.diagnostics["macro_iterations"] == u_ref.solver_iterations > 0
    assert _rel(u, u_ref.array) < 1e-8


@pytest.mark.parametrize("n,route", [(20, "amg"), (30, "jacobi")])
def test_fem_on_delaunay_mesh(n, route):
    """PoissonFEM(degree=2) on a 20² Delaunay mesh (1681 P2 dofs) above a
    lowered ``direct_threshold`` takes the AMG-CG; P1 on 30² (961 dofs, at
    or below the AMG bottom size) takes Jacobi CG.  Both give the
    reference's u to 1e-8 in its iterations."""
    jm = _delaunay_mesh(n)
    degree = 2 if route == "amg" else 1
    opts = dict(CG, method="auto", direct_threshold=500)
    A_j = lambda x: 1.0 + 0.5 * jnp.sin(3 * x[0]) * x[1]  # noqa: E731
    A_t = lambda x: 1.0 + 0.5 * torch.sin(3 * x[0]) * x[1]  # noqa: E731
    ref = hx.PoissonFEM(jm, A_j, lambda x: 1.0, JaxOptions(**opts), degree=degree).solve()
    u = ht.PoissonFEM(_port(jm), A_t, lambda x: 1.0, ht.SolverOptions(**opts), degree=degree,
                      device="cpu").solve()
    levels = u.diagnostics["macro_amg_levels"]
    assert u.macro_method == "cg" and (levels is None) == (route == "jacobi")
    if route == "amg":
        assert levels[0] == u.function_space.num_dofs == 1681 and len(levels) >= 2
    assert u.solver_iterations == int(ref.solver_iterations) > 0
    assert _rel(u.array.numpy(), ref.array) < 1e-8


# -- derivatives through the AMG-CG ------------------------------------------


PIPE_N, PIPE_BOTTOM = 16, 100  # 289 dofs, a 2-level hierarchy under bottom_max 100


def _pipe_options(method="cg"):
    return dict(method=method, rtol=1e-12, atol=0.0) if method == "cg" else dict(method=method)


def _port_pipeline_loss(method="cg"):
    jm = _delaunay_mesh(PIPE_N)

    def loss(theta):
        A = lambda x, y: 1.1 + theta * x[0] + 0.5 * torch.sin(2 * torch.pi * y[0])  # noqa: E731
        hmm = ht.PoissonHMM(_port(jm), A, lambda x: 1.0, ht.create_unit_square(4), 2**-4,
                            ht.SolverOptions(**_pipe_options(method)), device="cpu")
        step, centers = hmm.build_pipeline()
        loss.iterations = step.macro_solve.iterations
        loss.amg = hmm._sys.amg
        return (step(centers) ** 2).sum()

    return loss


def _grad(loss, theta, order=1):
    th = torch.tensor(float(theta), dtype=F64, requires_grad=True)
    (g,) = torch.autograd.grad(loss(th), th, create_graph=order > 1)
    if order > 1:
        (g,) = torch.autograd.grad(g, th)
    return float(g)


def _detached(fn):
    def wrapped(*a, **k):
        x, it, res = fn(*a, **k)
        return x.detach(), it, res

    return wrapped


def test_pipeline_gradient_through_amg_cg(monkeypatch):
    """build_pipeline on the 16² Delaunay mesh with bottom_max lowered to 100
    in both packages (289 -> 78 dofs): dJ/dθ through the AMG-CG,
    forward and adjoint, equals the reference's jax.grad to 1e-7.
    d²J/dθ² with the raw solve detached (the implicit rule alone carries
    it) equals the undetached one to 1e-8 and the port's direct path to
    1e-6."""
    from hommx_tpu.ops import multigrid as jmg

    monkeypatch.setattr(jamg, "_BOTTOM_MAX", PIPE_BOTTOM)
    monkeypatch.setattr(jmg, "_BOTTOM_MAX", PIPE_BOTTOM)
    monkeypatch.setattr(tamg, "_BOTTOM_MAX", PIPE_BOTTOM)
    held = [1.0]  # θ, read by the coefficient when the pipeline is traced
    A = lambda x, y: 1.1 + held[0] * x[0] + 0.5 * jnp.sin(2 * jnp.pi * y[0])  # noqa: E731
    hmm = hx.PoissonHMM(_delaunay_mesh(PIPE_N), A, lambda x: 1.0, hx.create_unit_square(4),
                        2**-4, options_global_solve=JaxOptions(**_pipe_options()))
    step, centers = hmm.build_pipeline()

    def jax_loss(theta):
        held[0] = theta
        return jnp.sum(step(centers) ** 2)

    g_ref = float(jax.jit(jax.grad(jax_loss))(1.0))
    loss = _port_pipeline_loss()
    g = _grad(loss, 1.0)
    assert loss.amg is not None and loss.amg.num_levels == 2
    assert len(loss.iterations) == 2 and min(loss.iterations) > 0  # forward, adjoint
    assert abs(g - g_ref) < 1e-7 * max(1.0, abs(g_ref))
    h2 = _grad(loss, 1.0, order=2)
    h2_direct = _grad(_port_pipeline_loss("direct"), 1.0, order=2)
    monkeypatch.setattr(tsolvers, "solve_ell", _detached(tsolvers.solve_ell))
    h2_opaque = _grad(loss, 1.0, order=2)
    assert abs(h2_opaque - h2) < 1e-8 * max(1.0, abs(h2))
    assert abs(h2_opaque - h2_direct) < 1e-6 * max(1.0, abs(h2_direct))
