"""Multi-device solves of the port on the CPU, mirroring tests/test_sharding.py:
the port shards over ``ShardMesh(["cpu"] * 8)``, the counterpart of the
reference's eight virtual host devices (tests/conftest.py), and is held
against the JAX package's own sharded results on that mesh and against its
own unsharded solve, in float64, at the reference tests' tolerances.  The
macro-level cases feed both packages the same system, assembled once by
the port."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hommx_tpu as hx
import hommx_tpu_torch as ht
from hommx_tpu.meshes.simplex import mesh_from_delaunay as jax_mesh_from_delaunay
from hommx_tpu.micro.engine import MicroEngine as JaxEngine
from hommx_tpu.models.common import MacroSystem as JaxMacroSystem
from hommx_tpu.ops import amg as jamg
from hommx_tpu.ops import multigrid as jmg
from hommx_tpu.ops.dia import build_dia_from_ell as jax_build_dia_from_ell
from hommx_tpu.ops.dia import ell_vals_to_dia as jax_ell_vals_to_dia
from hommx_tpu.ops.function_space import boundary_dofs as jax_boundary_dofs
from hommx_tpu.ops.solvers import _ell_diag as jax_ell_diag
from hommx_tpu.ops.sparse import build_ell_pattern as jax_build_ell_pattern
from hommx_tpu.parallel import device_mesh as jax_device_mesh
from hommx_tpu.parallel import macro as jmacro
from hommx_tpu.parallel import shard_cells as jax_shard_cells
from hommx_tpu.utils import validation as jval
from hommx_tpu_torch.models.common import MacroSystem, merge_bcs
from hommx_tpu_torch.models.fem import _load_vector, fem_assemble_values
from hommx_tpu_torch.ops import amg as tamg
from hommx_tpu_torch.ops import multigrid as tmg
from hommx_tpu_torch.ops import solvers
from hommx_tpu_torch.ops.assembly import apply_dirichlet
from hommx_tpu_torch.ops.dia import DIAOperator, dia_spmv, ell_vals_to_dia
from hommx_tpu_torch.ops.function_space import boundary_dofs
from hommx_tpu_torch.ops.sparse import spmv
from hommx_tpu_torch.parallel import macro as tmacro
from hommx_tpu_torch.utils import validation as tval
from tests._torch_parity import port_mesh

torch.set_num_threads(1)

F64 = torch.float64
MESH = ht.ShardMesh(["cpu"] * 8)
T = lambda a: torch.as_tensor(np.array(a))  # noqa: E731


def A_torch(x, y):
    return 1.1 + x[0] + torch.sin(2 * torch.pi * y[0])


def A_jax(x, y):
    return 1.1 + x[0] + jnp.sin(2 * jnp.pi * y[0])


def _max(a) -> float:
    return float(np.abs(np.asarray(a)).max())


def _jax_mesh():
    return jax_device_mesh()


def _assembled(jm):
    """The reference tests' float64 system on the mesh ``jm`` (coefficient
    1 + 0.5 sin(3x)·y, f = 1, Dirichlet on x = 0), assembled by the port,
    with the port's MacroSystem on that mesh (the reference's:
    :func:`_reference_system`)."""
    tsys = MacroSystem(ht.FunctionSpace(port_mesh(jm), 1), F64, "cpu")
    vals = fem_assemble_values(tsys, lambda x: 1.0 + 0.5 * torch.sin(3 * x[0]) * x[1],
                               "scalar", 2)
    b = _load_vector(tsys, lambda x: 1.0, 2)
    bc = ht.dirichletbc(0.0, ht.locate_dofs_geometrical(tsys.V, lambda x: np.isclose(x[0], 0.0)),
                        tsys.V)
    mask, bvals = merge_bcs([bc], tsys.V.num_dofs, F64, "cpu")
    vals, b = apply_dirichlet(vals, tsys.cols, tsys.diag_slots, b, mask, bvals, dia=tsys.dia)
    return dict(jm=jm, tsys=tsys, vals=vals, b=b)


def _reference_system(s):
    """The reference's MacroSystem of the system ``s``, built once."""
    if "sys" not in s:
        s["sys"] = JaxMacroSystem(hx.FunctionSpace(s["jm"], 1), jnp.float64)
    return s["sys"]


def _reference_dia(jm, bs=1):
    """The reference's DIA pattern of the mesh ``jm``, as its MacroSystem
    builds it."""
    V = hx.FunctionSpace(jm, bs)
    return jax_build_dia_from_ell(jax_build_ell_pattern(V.cell_dofs_unrolled(), V.num_dofs))


@functools.lru_cache(maxsize=None)
def _structured_system(n):
    return _assembled(hx.create_unit_square(n, n))


@functools.lru_cache(maxsize=None)
def _unstructured_system():
    """The reference test's Delaunay mesh: a 72-point ring and random
    interior points (no DIA view), AMG above the bottom size."""
    from scipy.spatial import Delaunay

    rng = np.random.default_rng(3)
    m = 72
    edge = np.linspace(0, 1, m)
    ring = np.concatenate([
        np.stack([edge, np.zeros(m)], 1), np.stack([edge, np.ones(m)], 1),
        np.stack([np.zeros(m - 2), edge[1:-1]], 1), np.stack([np.ones(m - 2), edge[1:-1]], 1),
    ])
    pts = np.concatenate([ring, rng.uniform(0.02, 0.98, (m * m - ring.shape[0], 2))])
    return _assembled(jax_mesh_from_delaunay(pts, Delaunay(pts).simplices))


def test_eight_devices_available():
    """The port's eight-shard CPU mesh beside the reference's eight virtual
    devices; a mesh is frozen, takes repeated devices, and the default
    ``device_mesh()`` never falls back to the CPU."""
    assert len(jax.devices()) == 8 and MESH.size == 8
    assert MESH.devices == (torch.device("cpu"),) * 8 and MESH.axis_names == ("cells",)
    assert ht.device_mesh(["cpu"] * 3) == ht.ShardMesh(["cpu"] * 3)
    with pytest.raises(Exception):
        MESH.devices = ()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ht.device_mesh()


def test_sharded_tensors_match_unsharded():
    """shard_cells over 8 shards (37 cells: 3 padding rows) equals the
    unsharded micro stage and the reference's shard_cells (1e-12), and
    keeps autograd through its copies."""
    A = lambda x, y: 1.1 + x[0] + 0.5 * torch.sin(2 * torch.pi * y[0])  # noqa: E731
    Aj = lambda x, y: 1.1 + x[0] + 0.5 * jnp.sin(2 * jnp.pi * y[0])  # noqa: E731
    c = np.stack([np.linspace(0.0, 1.0, 37), np.linspace(0.0, 2.0, 37)], axis=1)
    jm = hx.create_unit_square(8)
    je = JaxEngine(jm, bs=1, coeff_kind="scalar")
    ref = np.asarray(jax_shard_cells(
        _jax_mesh(), lambda cs: jax.vmap(lambda x: je.cell_tensor(je.element_coeff(Aj, x))[0])(cs),
        jnp.asarray(c)))
    te = ht.MicroEngine(port_mesh(jm), bs=1, coeff_kind="scalar", device="cpu")
    centers = T(c).requires_grad_()
    out = ht.shard_cells(MESH, lambda cs: te.tensors_for_centers(A, cs), centers)
    single = te.tensors_for_centers(A, centers)
    assert out.shape == (37, 2, 2)
    assert _max(out.detach() - single.detach()) < 1e-12
    assert _max(out.detach().numpy() - ref) < 1e-12
    (g,) = torch.autograd.grad(out.sum(), centers)
    (g1,) = torch.autograd.grad(single.sum(), centers)
    assert _max(g - g1) < 1e-12


def test_sharded_hmm_solve_matches():
    """PoissonHMM with the micro stage sharded over 8 shards equals the
    unsharded solve (1e-12) and the reference's sharded solve (1e-12)."""
    jmac, jmic = hx.create_unit_square(10, 10), hx.create_unit_square(8, 8)
    h2 = hx.PoissonHMM(jmac, A_jax, lambda x: 1.0, jmic, 0.01)
    h2._A_star = jax_shard_cells(
        _jax_mesh(),
        lambda c: jax.vmap(lambda x: h2._engine.cell_tensor(h2._engine.element_coeff(A_jax, x))[0])(c),
        h2._sys.centers)
    u_jax = np.asarray(h2.solve().array)
    args = (port_mesh(jmac), A_torch, lambda x: 1.0, port_mesh(jmic), 0.01)
    u_single = ht.PoissonHMM(*args, device="cpu").solve().array
    u_sh = ht.PoissonHMM(*args, device="cpu", shard_mesh=MESH).solve().array
    assert _max(u_single - u_sh) < 1e-12
    assert _max(u_sh.numpy() - u_jax) < 1e-12


@pytest.mark.parametrize("mode", ["auto", "shard_map"])
def test_sharded_pipeline_strategy_stack(mode):
    """build_pipeline(shard_mesh) runs the engine's strategy stack shard by
    shard: the low-rank chunk PCG and the FFT-preconditioned stratified
    chunk PCG equal the unsharded pipeline (1e-12) and the reference's
    sharded pipeline (1e-12)."""
    jmesh = jax.sharding.Mesh(np.array(jax.devices()), ("cells",))
    kw1 = {"coeff_rank": 2, "solver": "pcg"}
    s1 = ht.PoissonHMM(ht.create_unit_square(8, 8), A_torch, lambda x: 1.0,
                       ht.create_unit_square(8, 8), 2**-4, engine_kwargs=kw1, device="cpu")
    st_u, c = s1.build_pipeline()
    st_s, _ = s1.build_pipeline(shard_mesh=MESH, shard_mode=mode)
    u_s = st_s(c)
    assert _max(st_u(c) - u_s) < 1e-12
    j1 = hx.PoissonHMM(hx.create_unit_square(8, 8), A_jax, lambda x: 1.0,
                       hx.create_unit_square(8, 8), 2**-4, engine_kwargs=kw1)
    jst, jc = j1.build_pipeline(shard_mesh=jmesh, shard_mode=mode)
    assert _max(u_s.numpy() - np.asarray(jax.jit(jst)(jc))) < 1e-12

    def Dt(x):
        z, o = torch.zeros_like(x[0]), torch.ones_like(x[0])
        return torch.stack([torch.stack([o, z]),
                            torch.stack([-0.4 * torch.cos(2 * torch.pi * x[0]) * 2 * torch.pi, o])]).T

    def Dt_jax(x):
        return jnp.array([[1.0, 0.0], [-0.4 * jnp.cos(2 * jnp.pi * x[0]) * 2 * jnp.pi, 1.0]]).T

    def Aw(x, y):
        one = torch.ones((), dtype=y.dtype)
        return torch.where(torch.cos(2 * torch.pi * y[0]) < 0, 5.0 * one, 0.05 * one)

    Aw_jax = lambda x, y: jnp.where(jnp.cos(2 * jnp.pi * y[0]) < 0, 5.0, 0.05)  # noqa: E731
    kw2 = {"cell_prec": "fft"}
    s2 = ht.PoissonStratifiedHMM(ht.create_unit_square(8, 8), Aw, lambda x: 1.0,
                                 ht.create_unit_square(12, 12), 2**-4, Dt, engine_kwargs=kw2,
                                 device="cpu")
    p_u, c2 = s2.build_pipeline()
    p_s, _ = s2.build_pipeline(shard_mesh=MESH, shard_mode=mode)
    u2 = p_s(c2)
    assert _max(p_u(c2) - u2) < 1e-12
    j2 = hx.PoissonStratifiedHMM(hx.create_unit_square(8, 8), Aw_jax, lambda x: 1.0,
                                 hx.create_unit_square(12, 12), 2**-4, Dt_jax, engine_kwargs=kw2)
    jp, jc2 = j2.build_pipeline(shard_mesh=jmesh, shard_mode=mode)
    assert _max(u2.numpy() - np.asarray(jax.jit(jp)(jc2))) < 1e-12


def test_sharded_macro_cg_matches_replicated():
    """The row-sharded DIA CG (Jacobi) on a 32² system equals the
    replicated CG (1e-9, iterations within 2) and the reference's sharded
    CG (1e-9, the same iteration count)."""
    s = _structured_system(32)
    sys, tsys = _reference_system(s), s["tsys"]
    assert tmacro.can_shard_macro(tsys.dia, 8) and jmacro.can_shard_macro(sys.dia, 8)
    dvals_j = jax_ell_vals_to_dia(sys.dia, jnp.asarray(s["vals"].numpy()))
    x_j, it_j, _ = jmacro.sharded_solve_dia(_jax_mesh(), sys.dia, dvals_j, jnp.asarray(s["b"].numpy()),
                                            jax_ell_diag(jnp.asarray(s["vals"].numpy()), sys.cols),
                                            0.0, 1e-12, 10000)
    vals, b = s["vals"], s["b"]
    dvals = ell_vals_to_dia(tsys.dia, vals)
    diag = solvers._ell_diag(vals, tsys.cols)
    x_s, it_s, _ = tmacro.sharded_solve_dia(MESH, tsys.dia, dvals, b, diag, 0.0, 1e-12, 10000)
    x_r, it_r, _ = solvers.cg_matfree(lambda v: dia_spmv(dvals, tsys.dia.offsets, v), diag, b,
                                      atol=0.0, rtol=1e-12)
    assert _max(x_s - x_r) < 1e-9 and abs(it_s - it_r) <= 2
    assert _max(x_s.numpy() - np.asarray(x_j)) < 1e-9 and it_s == int(it_j)


@pytest.mark.parametrize("mode", ["auto", "shard_map"])
def test_sharded_macro_in_pipeline(mode):
    """build_pipeline(shard_mesh) with a forced CG macro routes through the
    row-sharded CG and equals the unsharded pipeline (1e-8)."""
    opts = ht.SolverOptions(method="cg", rtol=1e-11)
    hmm = ht.PoissonHMM(ht.create_unit_square(24, 24), A_torch, lambda x: 1.0,
                        ht.create_unit_square(4, 4), 2**-5, options_global_solve=opts,
                        device="cpu")
    step_s, centers = hmm.build_pipeline(shard_mesh=MESH, shard_mode=mode)
    step_r, _ = hmm.build_pipeline()
    assert hmm._shards_macro(MESH)
    assert _max(step_s(centers) - step_r(centers)) < 1e-8
    assert len(step_s.macro_solve.iterations) == 1


def test_sharded_macro_mg_matches_replicated():
    """The row-sharded CG with the multigrid V-cycle applied to the gathered
    residual, on a 72² system above direct_threshold: equal to the
    replicated MG-PCG (1e-8, iterations within 1, under 30) and to the
    reference's sharded MG-CG (1e-8, the same iteration count)."""
    s = _structured_system(72)
    sys, tsys = _reference_system(s), s["tsys"]
    vals_j = jnp.asarray(s["vals"].numpy())
    dvals_j = jax_ell_vals_to_dia(sys.dia, vals_j)
    # the setup inside the compiled cycle: 5x faster than an eager setup
    vcycle_j = functools.partial(
        jax.jit(lambda v, r: jmg.mg_vcycle(sys.mg, jmg.mg_setup(sys.mg, v), r)), dvals_j)
    x_j, it_j, _ = jmacro.sharded_solve_dia(_jax_mesh(), sys.dia, dvals_j, jnp.asarray(s["b"].numpy()),
                                            jax_ell_diag(vals_j, sys.cols), 0.0, 1e-10, 200,
                                            prec_full=vcycle_j)
    vals, b = s["vals"], s["b"]
    dvals = ell_vals_to_dia(tsys.dia, vals)
    state = tmg.mg_setup(tsys.mg, dvals)
    vcycle = lambda r: tmg.mg_vcycle(tsys.mg, state, r)  # noqa: E731
    x_s, it_s, _ = tmacro.sharded_solve_dia(MESH, tsys.dia, dvals, b,
                                            solvers._ell_diag(vals, tsys.cols), 0.0, 1e-10, 200,
                                            prec_full=vcycle)
    x_r, it_r, _ = solvers.pcg_prec(lambda v: dia_spmv(dvals, tsys.dia.offsets, v), vcycle, b,
                                    atol=0.0, rtol=1e-10, maxiter=200)
    assert _max(x_s - x_r) < 1e-8 and abs(it_s - it_r) <= 1 and it_s < 30
    assert _max(x_s.numpy() - np.asarray(x_j)) < 1e-8 and it_s == int(it_j)


def test_sharded_pipeline_differentiable():
    """torch.autograd.grad through build_pipeline(shard_mesh): the shards'
    cell solves under the implicit rule and the sharded macro CG's rule
    give the unsharded gradient (1e-6) and a central difference (1e-5)."""
    macro, micro = ht.create_unit_square(24, 24), ht.create_unit_square(6, 6)
    opts = ht.SolverOptions(method="cg", rtol=1e-12, atol=0.0)
    kw = {"solver": "pcg", "pcg_strategy": "matfree", "pcg_tol": 1e-13}

    def loss(theta, shard):
        A = lambda x, y: 1.1 + theta * x[0] + 0.5 * torch.sin(2 * torch.pi * y[0])  # noqa: E731
        hmm = ht.PoissonHMM(macro, A, lambda x: 1.0, micro, 2**-4, options_global_solve=opts,
                            engine_kwargs=kw, device="cpu")
        step, centers = hmm.build_pipeline(shard_mesh=shard)
        u = step(centers)
        return (u * u).sum(), step

    def grad(shard):
        th = torch.tensor(1.0, dtype=F64, requires_grad=True)
        J, step = loss(th, shard)
        (g,) = torch.autograd.grad(J, th)
        return float(g), step

    g_ref, _ = grad(None)
    g_sh, step = grad(MESH)
    # the sharded macro solve ran forward and adjoint
    assert hasattr(step.macro_solve, "full") and len(step.macro_solve.iterations) == 2
    assert abs(g_sh - g_ref) < 1e-6 * max(1.0, abs(g_ref)), (g_sh, g_ref)
    h = 1e-5
    with torch.no_grad():
        fd = float(loss(torch.tensor(1.0 + h, dtype=F64), None)[0]
                   - loss(torch.tensor(1.0 - h, dtype=F64), None)[0]) / (2 * h)
    assert abs(g_sh - fd) < 1e-5 * max(1.0, abs(fd)), (g_sh, fd)


def test_shard_mesh_class_api():
    """PoissonHMM(..., shard_mesh=mesh).solve() equals the unsharded solve
    on both macro paths (the replicated direct solve and the sharded CG;
    1e-9), and the reference's sharded class solve on the CG path (1e-9,
    the same iteration count)."""
    jmac, jmic = hx.create_unit_square(20, 20), hx.create_unit_square(6, 6)
    args = (port_mesh(jmac), A_torch, lambda x: 1.0, port_mesh(jmic), 2**-4)
    cg = dict(method="cg", rtol=1e-12, atol=0.0)
    for opts in (None, cg):
        kw = {"options_global_solve": ht.SolverOptions(**opts)} if opts else {}
        u_ref = ht.PoissonHMM(*args, device="cpu", **kw).solve().array
        h = ht.PoissonHMM(*args, device="cpu", shard_mesh=MESH, **kw)
        assert h._use_sharded_macro() == (opts is not None)
        u = h.solve().array
        assert _max(u_ref - u) < 1e-9, opts
    jmesh = jax.sharding.Mesh(np.array(jax.devices()), ("cells",))
    u_j = hx.PoissonHMM(jmac, A_jax, lambda x: 1.0, jmic, 2**-4, shard_mesh=jmesh,
                        options_global_solve=hx.SolverOptions(**cg)).solve()
    assert _max(u.numpy() - np.asarray(u_j.array)) < 1e-9
    assert h.diagnostics["macro_iterations"] == u_j.solver_iterations


def test_sharded_macro_f64_elasticity_matches_replicated():
    """The float64 elasticity CG macro (stratified beam, multigrid) runs
    row-sharded and equals the replicated solve and the reference's
    sharded solve (relative 1e-8)."""
    W = 0.4
    def mu(x, y):
        one = torch.ones((), dtype=y.dtype)
        return torch.where(y[1] < 0.5, 20.0 * one, 0.05 * one)

    def Dt3(x):
        g = 0.5 * torch.pi * x[1] / W
        c, s = torch.cos(g), torch.sin(g)
        z, o = torch.zeros_like(g), torch.ones_like(g)
        return torch.stack([torch.stack([c, z, s]), torch.stack([z, o, z]),
                            torch.stack([-s, z, c])]).T

    def Dt3_jax(x):
        g = 0.5 * jnp.pi * x[1] / W
        c, s = jnp.cos(g), jnp.sin(g)
        return jnp.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]]).T

    box = ([[0, 0, 0], [1.0, W, 0.1]], [16, 3, 2])
    f = [0.0, 0.0, -0.01]

    def run(hx_or_ht, bdofs, A_el, Dt, shard, **kw):
        h = hx_or_ht.LinearElasticityStratifiedHMM(
            hx_or_ht.create_box(*box), A_el, f, hx_or_ht.create_unit_cube(2), 2**-5, Dt,
            options_global_solve=hx_or_ht.SolverOptions(method="cg", rtol=1e-11),
            shard_mesh=shard, **kw)
        V = h.function_space
        h.set_boundary_conditions(hx_or_ht.dirichletbc(
            np.zeros(3), bdofs(V, lambda x: np.isclose(x[0], 0)), V))
        return h.solve().array, h

    A_el = tval.hooke_tensor(3, mu, lambda x, y: 1.0)
    u_r, _ = run(ht, boundary_dofs, A_el, Dt3, None, device="cpu")
    u_s, h_s = run(ht, boundary_dofs, A_el, Dt3, MESH, device="cpu")
    assert h_s._macro_f64 and h_s._macro_method == "cg" and h_s._use_sharded_macro()
    assert _max(u_s - u_r) / _max(u_r) < 1e-8
    A_jax = jval.hooke_tensor(3, lambda x, y: jnp.where(y[1] < 0.5, 20.0, 0.05),
                              lambda x, y: 1.0)
    jmesh = jax.sharding.Mesh(np.array(jax.devices()), ("cells",))
    u_j, _ = run(hx, jax_boundary_dofs, A_jax, Dt3_jax, jmesh)
    u_j = np.asarray(u_j)
    assert _max(u_s.numpy() - u_j) / _max(u_j) < 1e-8


def test_sharded_macro_amg_unstructured_matches_replicated():
    """A sharded unstructured system (no DIA view: the gathered ELL
    product) with the AMG V-cycle equals the replicated AMG-PCG (1e-8,
    iterations within 1, under 40) and the reference's sharded AMG-CG
    (1e-8, the same iteration count)."""
    s = _unstructured_system()
    sys, tsys = _reference_system(s), s["tsys"]
    assert tsys.dia is None and tsys.amg is not None
    assert tmacro.can_shard_macro_ell(tsys.V.num_dofs, 8)
    vals_j = jnp.asarray(s["vals"].numpy())
    vcycle_j = functools.partial(
        jax.jit(lambda v, r: jamg.amg_vcycle(sys.amg, jamg.amg_setup(sys.amg, v), r)), vals_j)
    x_j, it_j, _ = jmacro.sharded_solve_ell(_jax_mesh(), vals_j, jnp.asarray(sys.cols),
                                            jnp.asarray(s["b"].numpy()), jax_ell_diag(vals_j, sys.cols),
                                            0.0, 1e-10, 200, prec_full=vcycle_j)
    vals, b = s["vals"], s["b"]
    state = tamg.amg_setup(tsys.amg, vals)
    vcycle = lambda r: tamg.amg_vcycle(tsys.amg, state, r)  # noqa: E731
    diag = solvers._ell_diag(vals, tsys.cols)
    x_s, it_s, _ = tmacro.sharded_solve_ell(MESH, vals, tsys.cols, b, diag, 0.0, 1e-10, 200,
                                            prec_full=vcycle)
    x_r, it_r, _ = solvers.pcg_prec(lambda v: spmv(vals, tsys.cols, v), vcycle, b,
                                    atol=0.0, rtol=1e-10, maxiter=200)
    assert _max(x_s - x_r) < 1e-8 and abs(it_s - it_r) <= 1 and it_s < 40
    assert _max(x_s.numpy() - np.asarray(x_j)) < 1e-8 and it_s == int(it_j)


# -- the port's own cases --------------------------------------------------------


def test_three_shards_with_padding_rows():
    """A 3-shard mesh on a system whose size does not divide by 3 (31² =
    961 dofs: blocks of 321 rows, 2 padding rows): the sharded DIA and ELL
    CGs equal the replicated CG (1e-10), and shard_cells pads its batch
    (10 cells: 2 padding rows) and trims it."""
    mesh3 = ht.ShardMesh(["cpu"] * 3)
    s = _structured_system(30)
    tsys = s["tsys"]
    N = tsys.V.num_dofs
    assert N % 3 != 0 and tmacro.can_shard_macro(tsys.dia, 3)
    vals, b = s["vals"], s["b"]
    dvals = ell_vals_to_dia(tsys.dia, vals)
    diag = solvers._ell_diag(vals, tsys.cols)
    x_r, it_r, _ = solvers.cg_matfree(lambda v: dia_spmv(dvals, tsys.dia.offsets, v), diag, b,
                                      atol=0.0, rtol=1e-12)
    x_d, it_d, _ = tmacro.sharded_solve_dia(mesh3, tsys.dia, dvals, b, diag, 0.0, 1e-12, 10000)
    x_e, it_e, _ = tmacro.sharded_solve_ell(mesh3, vals, tsys.cols, b, diag, 0.0, 1e-12, 10000)
    assert x_d.shape == x_e.shape == (N,)
    assert _max(x_d - x_r) < 1e-10 and _max(x_e - x_r) < 1e-10
    assert abs(it_d - it_r) <= 2 and abs(it_e - it_r) <= 2
    centers = T(np.random.default_rng(0).uniform(0, 1, (10, 2)))
    out = ht.shard_cells(mesh3, lambda c: torch.cat([c, c.new_full((c.shape[0], 1), c.shape[0])],
                                                    dim=1), centers)
    assert out.shape == (10, 3) and bool((out[:, 2] == 4).all())
    assert torch.equal(out[:, :2], centers)


def test_can_shard_macro_matches_reference():
    """The sharding admissibility rules equal the reference's on the
    tested systems (the squares, the elasticity beam's box with bs = 3, the
    Delaunay mesh without a DIA view) and shard counts."""
    systems = [(_structured_system(n)["jm"], _structured_system(n)["tsys"]) for n in (30, 32, 72)]
    systems.append((_unstructured_system()["jm"], _unstructured_system()["tsys"]))
    for jm, bs in ((hx.create_unit_square(4, 4), 1), (hx.create_unit_square(24, 24), 1),
                   (hx.create_box([[0, 0, 0], [1.0, 0.4, 0.1]], [16, 3, 2]), 3)):
        systems.append((jm, MacroSystem(ht.FunctionSpace(port_mesh(jm), bs), F64, "cpu")))
    for jm, tsys in systems:
        jdia = _reference_dia(jm, tsys.V.bs)
        for nd in (1, 2, 3, 8, 64):
            assert tmacro.can_shard_macro(tsys.dia, nd) == jmacro.can_shard_macro(jdia, nd)
            N = tsys.V.num_dofs
            assert tmacro.can_shard_macro_ell(N, nd) == jmacro.can_shard_macro_ell(N, nd)
    assert not tmacro.can_shard_macro(None, 8)
    assert tmacro.can_shard_macro_ell(8, 8) and not tmacro.can_shard_macro_ell(7, 8)


@pytest.mark.parametrize("shard", [0, 3, 7])
def test_shard_operator_on_extended_vector(shard):
    """A shard's DIAOperator over its values zero-extended by the halo,
    applied to [left halo, x_shard, right halo], gives exactly the full
    system's DIA product on the shard's rows (the CPU runs the plain
    version, so the equality is exact)."""
    s = _structured_system(32)
    tsys = s["tsys"]
    N, offsets = tsys.V.num_dofs, tsys.dia.offsets
    dvals = ell_vals_to_dia(tsys.dia, s["vals"])
    x = T(np.random.default_rng(shard).standard_normal(N))
    halo = max(abs(o) for o in offsets)
    block = -(-N // 8)
    lo, hi = shard * block, min((shard + 1) * block, N)
    y_full = dia_spmv(dvals, offsets, x)[lo:hi]
    padded = torch.nn.functional.pad(dvals, (0, block * 8 - N))
    ext_vals = torch.nn.functional.pad(padded[:, shard * block:(shard + 1) * block], (halo, halo))
    xp = torch.nn.functional.pad(x, (halo, block * 8 - N + halo))
    x_ext = xp[shard * block:(shard + 1) * block + 2 * halo].contiguous()
    op = DIAOperator(ext_vals, offsets)
    y = op(x_ext, out=op.out)[halo:halo + block]
    assert torch.equal(y[:hi - lo], y_full)
