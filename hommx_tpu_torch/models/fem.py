"""Single-scale P1/P2 FEM solvers (torch port of ``hommx_tpu/models/fem.py``):
the fine-mesh references that the examples validate the HMM against, and
the convenience classes ``PoissonFEM`` and ``LinearElasticityFEM``.

Coefficients are torch callables ``A(x)`` returning a scalar, a (d, d)
matrix or a (d, d, d, d) Hooke tensor, evaluated at the element quadrature
points.  The system is assembled in float64 on every path, as the HMM's
macro system is (models/common.py::assemble_macro_system): the direct
solve and every vector system stay float64, a float32 scalar CG system is
rounded to float32 once.  On a structured mesh the CG runs the geometric
multigrid V-cycle and K2's DIA product, on the card by default; on any other
mesh, and on a P2 space, the aggregation-AMG V-cycle (ops/amg.py).

``fem_solve_fn`` is the differentiable solve ``solve(theta) -> x``: its
macro solve carries the implicit-function rule (ops/solvers.py::
make_implicit_solver), whose adjoint is one more solve with the same
options and kernels.

P2 spaces (``degree=2``, ops/p2.py) take per-quadrature-point basis
gradients, with the quadrature raised to degree 3.  They have no geometric
multigrid hierarchy: above ``direct_threshold`` their CG takes aggregation
AMG with ``pc='auto'``/``'mg'``, as the reference does.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from hommx_tpu_torch.config import as_device, default_dtype, sync
from hommx_tpu_torch.models.common import MacroSystem, macro_precs, merge_bcs, probe_coeff_kind
from hommx_tpu_torch.ops.assembly import (
    apply_dirichlet,
    assemble_ell,
    assemble_load_vector,
    gather_sum,
)
from hommx_tpu_torch.ops.elements import quad_points_physical
from hommx_tpu_torch.ops.function_space import (
    DirichletBC,
    Function,
    FunctionSpace,
    boundary_dofs,
    dirichletbc,
    eval_at_points,
)
from hommx_tpu_torch.ops.p2 import p2_basis
from hommx_tpu_torch.ops.quadrature import simplex_rule
from hommx_tpu_torch.ops.solvers import STOP_TEST, make_implicit_solver, solve_ell
from hommx_tpu_torch.utils.options import SolverOptions

__all__ = [
    "fem_assemble_values",
    "fem_system",
    "fem_solve",
    "fem_solve_fn",
    "PoissonFEM",
    "LinearElasticityFEM",
]


def _local_matrices(sys: MacroSystem, coeff: Callable, kind: str, degree: int) -> torch.Tensor:
    """Per-cell stiffness blocks (nc, nb, nb) in float64 for a pointwise
    coefficient A(x): S[a, b] = Σ_q w_q ∇φ_aᵀ A(x_q) ∇φ_b (rows = test),
    or for elasticity S[m, n] = Σ_q w_q P_m Ā(x_q) P_n with P the strain
    coefficients of the vector basis.  P1 gradients are cellwise constant;
    P2 gradients are ∇φ_k(x_q) = Σ_i c[q, k, i] ∇λ_i (ops/p2.py), with the
    quadrature raised to degree 3."""
    V = sys.V
    d = V.mesh.dim
    if V.degree == 2:
        degree = max(degree, 3)  # quadratic basis gradients are degree 1
    xq, wq, _ = quad_points_physical(sys.verts64, sys.cells, degree)  # (nc, nq, d)
    vals = eval_at_points(coeff, xq).to(torch.float64)
    nc, nq = wq.shape
    if kind == "scalar":
        Aq = vals.reshape(nc, nq)[..., None, None] * torch.eye(d, dtype=torch.float64,
                                                                device=wq.device)
    elif kind == "matrix":
        Aq = vals.reshape(nc, nq, d, d)
    else:
        Aq = vals.reshape(nc, nq, d * d, d * d)
    if V.degree == 2:
        xi = torch.as_tensor(simplex_rule(d, degree)[0], dtype=torch.float64, device=wq.device)
        _, dlam = p2_basis(xi, d)  # (nq, nb, d+1)
        B = torch.einsum("qki,cid->cqkd", dlam, sys.grads64)  # ∇φ at the points
        if V.bs == 1:
            return torch.einsum("cq,cqkd,cqde,cqle->ckl", wq, B, Aq, B)
        # vector P2: strain coefficients of basis (a, i) per point,
        # e(v_(a,i))_kl = ½(δ_ik ∂φ_a/∂x_l + δ_il ∂φ_a/∂x_k)
        eye = torch.eye(d, dtype=torch.float64, device=wq.device)
        P = 0.5 * (torch.einsum("ik,cqal->cqaikl", eye, B)
                   + torch.einsum("il,cqak->cqaikl", eye, B))
        P = P.reshape(B.shape[0], B.shape[1], B.shape[2] * d, d * d)
        return torch.einsum("cq,cqmr,cqrt,cqnt->cmn", wq, P, Aq, P)
    if V.bs == 1:
        return torch.einsum("cq,cad,cqde,cbe->cab", wq, sys.grads64, Aq, sys.grads64)
    P = sys.strain_P64
    return torch.einsum("cq,cmr,cqrt,cnt->cmn", wq, P, Aq, P)


def _load_vector(sys: MacroSystem, f_fn: Callable, degree: int) -> torch.Tensor:
    """b_i = ∫ f φ_i dx in float64 (P2: quadrature of degree 3 at least)."""
    V = sys.V
    if V.degree == 1:
        return assemble_load_vector(sys.verts64, sys.cells, f_fn, bs=V.bs, degree=degree,
                                    gather=sys.load_gather)
    degree = max(degree, 3)
    xq, wq, _ = quad_points_physical(sys.verts64, sys.cells, degree)
    xi = torch.as_tensor(simplex_rule(V.mesh.dim, degree)[0], dtype=torch.float64,
                         device=wq.device)
    phi, _ = p2_basis(xi, V.mesh.dim)  # (nq, nb)
    fvals = eval_at_points(f_fn, xq).to(torch.float64).reshape(*wq.shape, V.bs)
    contrib = torch.einsum("cq,cqb,qk->ckb", wq, fvals, phi).reshape(-1)
    if sys.load_gather is not None:
        return gather_sum(contrib, sys.load_gather)
    dofs = torch.as_tensor(V.cell_dofs_unrolled().astype(np.int64), device=wq.device)
    return contrib.new_zeros(V.num_dofs).index_add_(0, dofs.reshape(-1), contrib)


def fem_assemble_values(sys: MacroSystem, coeff: Callable, kind: str, degree: int):
    """The flat ELL values of the stiffness matrix, float64."""
    return assemble_ell(sys.pattern, _local_matrices(sys, coeff, kind, degree), sys.slots,
                        gather=sys.gather_asm)


def _as_source(f, bs: int) -> Callable:
    """Normalize the rhs: a torch callable, a constant scalar, or a
    constant (bs,) vector."""
    if callable(f):
        return f
    if bs == 1:
        val = float(f)
        return lambda x: val
    arr = torch.as_tensor(np.broadcast_to(np.asarray(f, dtype=np.float64), (bs,)).copy())
    return lambda x: arr


def fem_solve(
    V: FunctionSpace,
    coeff: Callable,
    f: Union[Callable, Sequence[float], float],
    bcs: Sequence[DirichletBC],
    options: Optional[SolverOptions] = None,
    quad_degree: int = 2,
    rhs_degree: int = 2,
    dtype: Optional[torch.dtype] = None,
    device="cuda",
) -> Function:
    """Solve ∫ A ∇u·∇v = ∫ f v (or the elasticity analogue) with Dirichlet
    BCs on ``device`` (the card unless the caller passes "cpu").

    The result carries ``solver_iterations``, ``solver_residual`` and
    ``macro_method`` ('direct' or 'cg')."""
    device = as_device(device)
    dtype = dtype or default_dtype(device)
    options = SolverOptions.from_any(options)
    t0 = time.perf_counter()
    kind = probe_coeff_kind(coeff, V.mesh.dim, nargs=1)
    sys = MacroSystem(V, dtype, device)
    mask, bvals = merge_bcs(bcs, V.num_dofs, torch.float64, device)
    mg, amg = macro_precs(sys, options)
    sync(device)
    t1 = time.perf_counter()
    vals_bc, b_bc = fem_system(sys, coeff, kind, f, mask, bvals, quad_degree, rhs_degree)
    method = options.method
    if method == "auto":
        method = "direct" if V.num_dofs <= options.direct_threshold else "cg"
    if method != "direct" and V.bs == 1:
        # a scalar CG system runs in the pipeline dtype, rounded once
        vals_bc, b_bc = vals_bc.to(dtype), b_bc.to(dtype)
    sync(device)
    t2 = time.perf_counter()
    steps0 = STOP_TEST.steps
    x, iters, res = solve_ell(vals_bc, sys.cols, b_bc, options, dia=sys.dia, mg=mg, amg=amg)
    fn = Function(V, x.to(dtype))
    fn.solver_iterations = int(iters)
    fn.solver_residual = float(res)  # the solve's closing host sync
    fn.macro_method = method
    #: host seconds of the set-up (pattern, DIA view, gather tables, the
    #: host build of the multigrid or AMG hierarchy), the float64 assembly
    #: with its Dirichlet lifting, and the solve (the per-operator
    #: multigrid or AMG set-up included); the CG's loop steps; the AMG
    #: hierarchy's level sizes (None off the AMG route)
    fn.diagnostics = {"setup_seconds": t1 - t0, "assembly_seconds": t2 - t1,
                      "solve_seconds": time.perf_counter() - t2,
                      "macro_steps": STOP_TEST.steps - steps0,
                      "macro_amg_levels": None if amg is None else amg.level_sizes}
    fn.system = sys
    return fn


def fem_system(sys: MacroSystem, coeff, kind: str, f, mask, bvals, quad_degree: int = 2,
               rhs_degree: int = 2):
    """The BC-applied float64 ELL system (vals_bc, b_bc) of a single-scale
    problem on ``sys``: stiffness, load vector, symmetric Dirichlet lifting."""
    vals = fem_assemble_values(sys, coeff, kind, quad_degree)
    b = _load_vector(sys, _as_source(f, sys.V.bs), rhs_degree)
    return apply_dirichlet(vals, sys.cols, sys.diag_slots, b, mask, bvals, dia=sys.dia)


def fem_solve_fn(
    V: FunctionSpace,
    coeff: Callable,
    f,
    bcs: Sequence[DirichletBC],
    options: Optional[SolverOptions] = None,
    quad_degree: int = 2,
    rhs_degree: int = 2,
    dtype: Optional[torch.dtype] = None,
    device="cuda",
):
    """The single-scale FEM solve as a differentiable function of a
    coefficient parameter: returns ``solve(theta) -> x``, where
    ``coeff(theta, x_pt)`` and a callable ``f(theta, x_pt)`` receive the
    parameter (a constant ``f`` is taken as it is).

    The system is assembled in float64 and, on a scalar CG path, rounded
    once to ``dtype``, as :func:`fem_solve` does; the macro solve carries
    the implicit-function rule, so ``torch.autograd.grad`` through
    ``solve`` is exact at convergence on every solver path (the adjoint
    CG runs the same multigrid and K2).  ``solve.macro_solve.iterations``
    lists the solves' iteration counts, forward and adjoint."""
    device = as_device(device)
    dtype = dtype or default_dtype(device)
    options = SolverOptions.from_any(options)
    sys = MacroSystem(V, dtype, device)
    mask, bvals = merge_bcs(bcs, V.num_dofs, torch.float64, device)
    method = options.method
    if method == "auto":
        method = "direct" if V.num_dofs <= options.direct_threshold else "cg"
    mg, amg = macro_precs(sys, options)
    macro_solve = make_implicit_solver(sys.cols, options, dia=sys.dia, mg=mg, amg=amg)

    def solve(theta):
        c = lambda x: coeff(theta, x)  # noqa: E731
        kind = probe_coeff_kind(lambda x: c(x.to(device)), V.mesh.dim, nargs=1)
        vals_bc, b_bc = fem_system(sys, c, kind, _as_source_theta(f, theta, V.bs), mask,
                                   bvals, quad_degree, rhs_degree)
        if method != "direct" and V.bs == 1:
            vals_bc, b_bc = vals_bc.to(dtype), b_bc.to(dtype)
        return macro_solve(vals_bc, b_bc).to(dtype)

    solve.macro_solve = macro_solve
    return solve


def _as_source_theta(f, theta, bs: int):
    """The rhs with the parameter bound: ``f(theta, x)`` for a callable."""
    if callable(f):
        return lambda x: f(theta, x)
    return _as_source(f, bs)


class PoissonFEM:
    """Fine-mesh Poisson solver with a zero Dirichlet BC on the whole
    boundary (reference ``helpers.py:212-302``)."""

    def __init__(
        self,
        msh,
        A: Callable,
        f,
        options: Optional[SolverOptions] = None,
        quad_degree: int = 2,
        degree: int = 1,
        *,
        dtype: Optional[torch.dtype] = None,
        device="cuda",
    ):
        self._V = FunctionSpace(msh, 1, degree=degree)
        self._coeff = A
        self._f = f
        self._options = SolverOptions.from_any(options)
        self._quad_degree = quad_degree
        self._dtype = dtype
        self._device = device
        self._bcs = [dirichletbc(0.0, boundary_dofs(self._V), self._V)]
        self._u: Optional[Function] = None

    @property
    def function_space(self) -> FunctionSpace:
        return self._V

    def set_boundary_conditions(self, bcs):
        self._bcs = bcs if isinstance(bcs, list) else [bcs]

    def solve(self) -> Function:
        self._u = fem_solve(self._V, self._coeff, self._f, self._bcs, self._options,
                            quad_degree=self._quad_degree, dtype=self._dtype,
                            device=self._device)
        return self._u

    def plot_solution(self, u: Optional[Function] = None, **kw):
        """Plot ``u`` (the last solution by default) with
        :func:`hommx_tpu_torch.utils.plotting.plot_fem_function`; ``kw``
        are its options (``filename``, ``title``, ``cmap``, ``show``,
        ``warp``).  Returns the figure."""
        from hommx_tpu_torch.utils.plotting import plot_fem_function

        if u is None and self._u is None:
            raise RuntimeError("call solve() first")
        return plot_fem_function(self._V, u if u is not None else self._u, **kw)


class LinearElasticityFEM(PoissonFEM):
    """Fine-mesh linear-elasticity solver: A(x) is a (d, d, d, d) Hooke
    tensor.  No default boundary conditions (like ``LinearElasticityHMM``)."""

    def __init__(
        self,
        msh,
        A: Callable,
        f,
        options: Optional[SolverOptions] = None,
        quad_degree: int = 2,
        degree: int = 1,
        *,
        dtype: Optional[torch.dtype] = None,
        device="cuda",
    ):
        super().__init__(msh, A, f, options, quad_degree, degree, dtype=dtype, device=device)
        self._V = FunctionSpace(msh, msh.dim, degree=degree)
        self._bcs = []
