"""The port's entry points (torch counterparts of ``__graft_entry__.py``):
``entry``, the flagship model's whole solve as a differentiable function,
and ``dryrun_multichip``, the sharded pipeline's six checks.

The flagship is the configuration of the reference's ``examples/hmm.py``:
a PoissonHMM on an 8×8 macro mesh with an 8×8 micro mesh, the laminate
coefficient A(x, y) = 1.1 + x₀ + sin 2πy₀, f = 1, ε = 1/32; float32 on the
card, float64 on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from hommx_tpu_torch.config import as_device, default_dtype
from hommx_tpu_torch.meshes import create_box, create_unit_cube, create_unit_square
from hommx_tpu_torch.meshes.simplex import mesh_from_delaunay
from hommx_tpu_torch.models.hmm import LinearElasticityStratifiedHMM, PoissonHMM
from hommx_tpu_torch.ops.function_space import boundary_dofs, dirichletbc
from hommx_tpu_torch.parallel.macro import can_shard_macro
from hommx_tpu_torch.parallel.sharding import ShardMesh
from hommx_tpu_torch.utils.options import SolverOptions
from hommx_tpu_torch.utils.validation import hooke_tensor

__all__ = ["entry", "dryrun_multichip"]


def _coefficient(x, y):
    return 1.1 + x[0] + torch.sin(2 * torch.pi * y[0])


def _flagship(device, dtype=None, macro_n=8, micro_n=8, options=None, theta=None, **kw):
    """The flagship PoissonHMM; with ``theta`` (a tensor) the coefficient is
    1.1 + θx₀ + sin 2πy₀."""
    A = _coefficient if theta is None else (
        lambda x, y: 1.1 + theta * x[0] + torch.sin(2 * torch.pi * y[0]))
    return PoissonHMM(create_unit_square(macro_n, macro_n), A, lambda x: 1.0,
                      create_unit_square(micro_n, micro_n), 1 / 2**5,
                      options_global_solve=options, dtype=dtype, device=as_device(device), **kw)


def entry(device="cuda"):
    """(step, (centers,)): the flagship's full solve ``step(centers) -> u``
    (micro cell problems, homogenized tensors, macro assembly, macro
    solve) from ``BaseHMM.build_pipeline``, and its example argument."""
    step, centers = _flagship(device).build_pipeline()
    return step, (centers,)


def _rel(u, u0) -> float:
    return float((u - u0).abs().max()) / float(u0.abs().max())


def _check(name, err, bar, out):
    out[name] = err
    if not err < bar:
        raise AssertionError(f"dryrun_multichip {name}: sharded/unsharded mismatch {err:.3e} "
                             f"(bar {bar:.0e})")


def _grad(make_step, dev):
    """dJ/dθ at θ = 1 of J = Σ u², u from the pipeline ``make_step(θ)``."""
    theta = torch.tensor(1.0, dtype=torch.float64, device=dev, requires_grad=True)
    step, centers = make_step(theta)
    (g,) = torch.autograd.grad((step(centers).double() ** 2).sum(), theta)
    return float(g)


def _beam(dev, micro, theta=None, shard=None):
    """Phase 5's stratified rotated-fibre beam (16x3x2 box, float32 engine,
    float64 CG macro), the fibre modulus scaled by ``theta``."""
    W = 0.4

    def mu(x, y):
        one = torch.ones((), dtype=y.dtype, device=y.device)
        s = one if theta is None else theta.to(y.dtype)
        return torch.where(y[1] < 0.5, 20.0 * s * one, 0.05 * one)

    def Dt3(x):
        g = 0.5 * torch.pi * x[1] / W
        c, s = torch.cos(g), torch.sin(g)
        z, o = torch.zeros_like(g), torch.ones_like(g)
        return torch.stack([torch.stack([c, z, s]), torch.stack([z, o, z]),
                            torch.stack([-s, z, c])]).T

    h = LinearElasticityStratifiedHMM(
        create_box([[0, 0, 0], [1.0, W, 0.1]], [16, 3, 2]), hooke_tensor(3, mu, lambda x, y: 1.0),
        [0.0, 0.0, -0.01], micro, 2**-5, Dt3, dtype=torch.float32, device=dev,
        options_global_solve=SolverOptions(method="cg", rtol=1e-11), shard_mesh=shard)
    V = h.function_space
    h.set_boundary_conditions(
        dirichletbc(np.zeros(3), boundary_dofs(V, lambda x: np.isclose(x[0], 0)), V))
    return h


def _delaunay_macro():
    """Phase 6's unstructured macro mesh: a 72-point ring and random
    interior points (seed 7), 5184 vertices."""
    from scipy.spatial import Delaunay

    rng = np.random.default_rng(7)
    m = 72
    edge = np.linspace(0, 1, m)
    ring = np.concatenate([
        np.stack([edge, np.zeros(m)], 1), np.stack([edge, np.ones(m)], 1),
        np.stack([np.zeros(m - 2), edge[1:-1]], 1), np.stack([np.ones(m - 2), edge[1:-1]], 1),
    ])
    pts = np.concatenate([ring, rng.uniform(0.02, 0.98, (m * m - ring.shape[0], 2))])
    return mesh_from_delaunay(pts, Delaunay(pts).simplices)


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """The sharded pipeline on ``ShardMesh([device] * n_devices)`` in the
    reference's six phases, each checked against the unsharded pipeline
    (the counterpart of ``__graft_entry__.py::dryrun_multichip``):

    1. the flagship at 8x8 macro, 4x4 micro, direct macro solve, in both
       shard modes;
    2. a forced CG macro at 24x24 (row-sharded CG), both modes;
    3. 66x66 (4489 dofs, above ``direct_threshold``): the sharded CG with
       the multigrid V-cycle;
    4. dJ/dθ through the sharded pipeline (the shards' cell solves and the
       sharded CG under their implicit rules);
    5. the stratified rotated-fibre beam (16x3x2 box, 4³ micro cube, the
       float32 chunk-Cholesky micro stage, the float64 CG macro), both
       modes and dJ/dθ;
    6. an unstructured Delaunay macro (no DIA view): the sharded ELL CG
       with the AMG V-cycle.

    The pipeline's dtype follows the device: float32 on the card, float64
    on the CPU.  A float64 run keeps the reference's CG tolerances (1e-10)
    and bars (1e-6 relative to max|u|, 1e-7 for phase 6); a float32 run
    solves its CG to 1e-5 and is held at 1e-4 (the gradient at 1e-3).
    Phase 5 is float32 in the micro stage in both, as in the reference
    (bar 2e-5, its gradient 1e-4).  Raises on a failed check; returns
    each check's relative error."""
    dev = as_device(device)
    dtype = default_dtype(dev)
    mesh = ShardMesh([dev] * n_devices)
    f64 = dtype == torch.float64
    rtol = 1e-10 if f64 else 1e-5
    bar, grad_bar = (1e-6, 1e-6) if f64 else (1e-4, 1e-3)
    cg = SolverOptions(method="cg", rtol=rtol)
    out = {}

    def both_modes(name, hmm, bar):
        step0, centers = hmm.build_pipeline()
        u0 = step0(centers)
        for mode in ("auto", "shard_map"):
            step, _ = hmm.build_pipeline(shard_mesh=mesh, shard_mode=mode)
            u = step(centers)
            if not bool(torch.isfinite(u).all()):
                raise AssertionError(f"dryrun_multichip {name}: non-finite u ({mode})")
            _check(f"{name}_{mode}", _rel(u, u0), bar, out)

    # 1: direct macro (replicated), 128 cells over the shards
    hmm = _flagship(dev, dtype, macro_n=8, micro_n=4)
    assert hmm._sys.centers.shape[0] % n_devices == 0
    both_modes("direct", hmm, bar)

    # 2: forced CG, row-sharded
    hmm_cg = _flagship(dev, dtype, macro_n=24, micro_n=4, options=cg)
    assert can_shard_macro(hmm_cg._sys.dia, n_devices), "halo too wide"
    both_modes("cg", hmm_cg, bar)

    # 3: above direct_threshold: the sharded CG with the multigrid V-cycle
    hmm_mg = _flagship(dev, dtype, macro_n=66, micro_n=4,
                       options=None if f64 else SolverOptions(rtol=rtol))
    assert hmm_mg._V_macro.num_dofs > SolverOptions().direct_threshold
    assert hmm_mg._sys.mg is not None and hmm_mg._shards_macro(mesh)
    step_mg, centers_mg = hmm_mg.build_pipeline(shard_mesh=mesh)
    step_mg0, _ = hmm_mg.build_pipeline()
    _check("mg", _rel(step_mg(centers_mg), step_mg0(centers_mg)), bar, out)

    # 4: the gradient through the sharded pipeline
    def grad_cg(shard):
        return _grad(lambda th: _flagship(dev, dtype, macro_n=24, micro_n=4, options=cg,
                                          theta=th).build_pipeline(shard_mesh=shard), dev)

    g_sh, g_ref = grad_cg(mesh), grad_cg(None)
    _check("grad", abs(g_sh - g_ref) / max(1.0, abs(g_ref)), grad_bar, out)

    # 5: the elasticity beam at the production micro size
    micro_el = create_unit_cube(4)
    h_el = _beam(dev, micro_el)
    eng = h_el._engine
    assert eng.solver == "cholesky" and eng.bs == 3 and eng.dtype == torch.float32
    assert h_el._macro_f64 and h_el._sys.centers.shape[0] % n_devices == 0
    both_modes("elasticity", h_el, 2e-5)
    g_sh = _grad(lambda th: _beam(dev, micro_el, th).build_pipeline(shard_mesh=mesh), dev)
    g_ref = _grad(lambda th: _beam(dev, micro_el, th).build_pipeline(), dev)
    _check("elasticity_grad", abs(g_sh - g_ref) / max(1.0, abs(g_ref)), 1e-4, out)

    # 6: the unstructured macro: the sharded ELL CG with AMG
    macro_un = _delaunay_macro()

    def make_un(shard):
        return PoissonHMM(macro_un, _coefficient, lambda x: 1.0, create_unit_square(4),
                          1 / 2**5, options_global_solve=cg, dtype=dtype, device=dev,
                          shard_mesh=shard)

    h_un = make_un(None)
    assert h_un._sys.dia is None and h_un._sys.amg is not None
    step_un0, centers_un = h_un.build_pipeline()
    h_un_s = make_un(mesh)
    assert h_un_s._use_sharded_macro(), "the sharded ELL macro must engage"
    step_un, _ = h_un_s.build_pipeline()
    _check("unstructured", _rel(step_un(centers_un), step_un0(centers_un)),
           1e-7 if f64 else bar, out)
    return out
