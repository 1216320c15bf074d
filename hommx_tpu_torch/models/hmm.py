"""HMM solver classes (torch port of ``hommx_tpu/models/hmm.py``:
``BaseHMM``, ``PoissonHMM``, ``LinearElasticityHMM`` and
``LinearElasticityStratifiedHMM``).

``solve()`` runs

    micro stage:  A*(c_T) for every macro cell (micro/engine.py)
    macro stage:  S_loc[c] = |T_c| · P A*(c_T)ᵀ Pᵀ (P the P1 gradients, or
                  the strain coefficients for elasticity), ELL scatter
                  assembly, symmetric Dirichlet lifting, CG / dense-Cholesky
                  solve.

``eps`` is kept for API parity; it cancels exactly in the reference's
scaling chain, so it does not enter the computation.

Divergences from the reference in this slice (ROADMAP C): cell dedup is
off by default and ``dedup_cells=True`` raises (ROADMAP A7); the macro CG
accepts only the Jacobi preconditioner (multigrid: ROADMAP A5), and
elasticity above ``direct_threshold`` (the reference's float64 multigrid
CG) raises.  ``PoissonStratifiedHMM``, ``build_pipeline`` and sharding wait
for later slices.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Optional

import numpy as np
import torch

from hommx_tpu_torch.config import as_device, default_dtype, sync
from hommx_tpu_torch.micro.engine import MicroEngine
from hommx_tpu_torch.models.common import (
    MacroSystem,
    assemble_macro_system,
    macro_precs,
    merge_bcs,
    probe_coeff_kind,
)
from hommx_tpu_torch.ops.assembly import assemble_load_vector
from hommx_tpu_torch.ops.function_space import (
    DirichletBC,
    Function,
    FunctionSpace,
    dirichletbc,
    locate_dofs_geometrical,
)
from hommx_tpu_torch.ops.solvers import solve_ell
from hommx_tpu_torch.utils.options import SolverOptions

__all__ = ["BaseHMM", "PoissonHMM", "LinearElasticityHMM", "LinearElasticityStratifiedHMM"]

logger = logging.getLogger("hommx_tpu_torch")


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


class BaseHMM:
    """Common HMM machinery.

    Args:
        msh: macro SimplexMesh.
        A: coefficient, torch callable ``A(x, y)`` with x the macro cell
            center and y the micro coordinate; 1-periodic in y.  Returns a
            scalar or (d, d) (Poisson) or (d, d, d, d) (elasticity).
        f: right-hand side — torch callable ``f(x)`` or a constant (a (bs,)
            vector for elasticity).
        msh_micro: the unit-cell micro mesh (structured box).
        eps: microscopic scale (API parity; cancels).
        options_global_solve: macro SolverOptions.
        dtype: pipeline dtype (default: float64 on CPU, float32 on CUDA).
        device: torch device of every tensor of the solve (the card by
            default; pass "cpu" for the CPU).
        chunk: cells per micro chunk (0 = auto).
        engine_kwargs: extra MicroEngine options (``pcg_tol``, ...).
        dedup_cells: must be False in this port (ROADMAP A7).
    """

    _bs: int = 1

    def __init__(
        self,
        msh,
        A: Callable,
        f,
        msh_micro,
        eps: float,
        options_global_solve: Optional[SolverOptions] = None,
        options_cell_problem=None,
        *,
        quad_degree_micro: int = 2,
        quad_degree_rhs: int = 2,
        dtype: Optional[torch.dtype] = None,
        device="cuda",
        chunk: int = 0,
        engine_kwargs: Optional[dict] = None,
        dedup_cells: bool = False,
    ):
        if msh.dim not in (2, 3):
            raise ValueError("Topology should be 3D or 2D")
        if msh.dim != msh_micro.dim:
            raise ValueError("Micro and macro mesh should have the same dimensionality.")
        if dedup_cells:
            raise NotImplementedError("cell dedup is not ported yet (ROADMAP A7)")
        if options_cell_problem is not None:
            raise NotImplementedError(
                "options_cell_problem is not ported yet (ROADMAP A13); use "
                "engine_kwargs"
            )
        self._msh = msh
        self._cell_mesh = msh_micro
        self._coeff = A
        self._eps = float(eps)
        self._device = as_device(device)
        self._dtype = dtype or default_dtype(self._device)
        self._tdim = msh.dim
        self._options_global = SolverOptions.from_any(options_global_solve)
        self._chunk = chunk
        self._quad_degree_rhs = quad_degree_rhs

        bs = self._block_size()
        self._V_macro = FunctionSpace(msh, bs)
        self._sys = MacroSystem(self._V_macro, self._dtype, self._device)
        macro_precs(self._sys, self._options_global)  # raises for multigrid
        self._engine = MicroEngine(
            msh_micro,
            bs=bs,
            coeff_kind=self._coeff_kind(),
            quad_degree=quad_degree_micro,
            dtype=self._dtype,
            device=self._device,
            **(engine_kwargs or {}),
        )
        self._f_fn = _as_source(f, bs)
        self._bcs: list = []
        self._A_star: Optional[torch.Tensor] = None
        self._b_load = None
        self._u: Optional[Function] = None
        m = self._options_global.method
        if m == "auto":
            m = (
                "direct"
                if self._V_macro.num_dofs <= self._options_global.direct_threshold
                else "cg"
            )
        self._macro_method = m
        if m == "cg" and bs > 1:
            raise NotImplementedError(
                "elasticity above direct_threshold takes the float64 multigrid "
                "CG, not ported yet (ROADMAP A5)"
            )
        # the dense direct path factorizes in f64, so its assembly runs in
        # f64 too (free: the direct path is size-capped); vector systems
        # reach κ ~ 1e7, where storing the matrix in f32 costs percent-level
        # error, so they assemble in f64 on every path
        self._macro_f64 = m == "direct" or bs > 1
        #: per-solve telemetry: phase timings, solver iterations/residual,
        #: NaN, divergence and zero-corrector-fallback guard results
        self.diagnostics: dict = {}

    # -- subclass hooks ------------------------------------------------------
    def _block_size(self) -> int:
        return self._bs

    def _coeff_kind(self) -> str:
        return probe_coeff_kind(self._coeff, self._tdim, nargs=2)

    def _G_fn(self) -> Optional[Callable]:
        """Gradient map Dθᵀ(x) for stratified variants; None otherwise."""
        return None

    # -- reference API -------------------------------------------------------
    @property
    def function_space(self) -> FunctionSpace:
        return self._V_macro

    def set_boundary_conditions(self, bcs):
        self._bcs = bcs if isinstance(bcs, list) else [bcs]

    def homogenized_tensors(self) -> torch.Tensor:
        """A*(c_T) per macro cell, (nc, s, s) — the micro stage output,
        cached across solves."""
        if self._A_star is None:
            self._A_star = self._engine.tensors_for_centers(
                self._coeff, self._sys.centers, G_fn=self._G_fn(), chunk=self._chunk
            )
        return self._A_star

    def _guard(self, A_star):
        """Divergence and zero-corrector-fallback masks (nc,) and the max
        coefficient contrast, on the device.  Energy minimization bounds
        diag(A*) by the zero-corrector tensor's diagonal; a violation means
        the cell solve diverged.  The reference runs this guard on the PCG
        route only; the port runs the divergence test on the direct route
        too, and the fallback detector (the PCG clamp's signature) on the
        PCG route only."""
        A0, contrast = self._engine.nocorrector_tensors(
            self._coeff, self._sys.centers, G_fn=self._G_fn(), chunk=self._chunk
        )
        d_star = torch.diagonal(A_star, dim1=1, dim2=2)
        d_zero = torch.diagonal(A0, dim1=1, dim2=2)
        diverged = (d_star > 1.05 * d_zero + 1e-9).any(dim=1)
        tiny = torch.finfo(d_zero.dtype).tiny
        ratio = d_star / torch.clamp(d_zero, min=tiny)
        med = torch.quantile(ratio, 0.5, dim=0)
        fallback = ((ratio > 0.999) & (med[None, :] < 0.95)).any(dim=1)
        if self._engine.solver != "pcg":
            fallback = torch.zeros_like(fallback)
        return diverged, fallback, contrast.max()

    def solve(self) -> Function:
        """Assemble the HMM system and solve."""
        sys = self._sys
        dev = self._device
        sync(dev)
        t0 = time.perf_counter()
        A_star = self.homogenized_tensors()
        sync(dev)
        t_micro = time.perf_counter() - t0

        nan_mask = torch.isnan(A_star).any(dim=(1, 2))
        diverged_m, fallback_m, contrast = self._guard(A_star)
        # one host sync for the three flags and the contrast
        stats = torch.stack(
            [nan_mask.any().double(), diverged_m.any().double(),
             fallback_m.any().double(), contrast.double()]
        ).cpu().numpy()
        empty = np.array([], dtype=np.int64)
        nan_cells = torch.nonzero(nan_mask)[:, 0].cpu().numpy() if stats[0] else empty
        diverged_cells = (
            torch.nonzero(diverged_m)[:, 0].cpu().numpy() if stats[1] else empty
        )
        fallback_cells = (
            torch.nonzero(fallback_m)[:, 0].cpu().numpy() if stats[2] else empty
        )
        if nan_cells.size:
            logger.error(
                "Something went wrong when calculating the homogenized tensor "
                "on %d cells (first: %s)", nan_cells.size, nan_cells[:5].tolist()
            )
        if diverged_cells.size:
            logger.error(
                "Cell-problem solve diverged on %d cells (homogenized tensor "
                "exceeds its zero-corrector energy bound; first: %s). Likely "
                "cause: a float32 cell solve on a high-contrast coefficient — pass "
                "dtype=torch.float64.",
                diverged_cells.size, diverged_cells[:5].tolist(),
            )
        elif stats[3] > 1e7 and self._dtype == torch.float32:
            logger.warning(
                "Coefficient contrast ~%.1e approaches the float32 epsilon "
                "scale; verify against dtype=torch.float64.", stats[3],
            )
        if fallback_cells.size:
            logger.warning(
                "%d cells returned the zero-corrector fallback tensor (float32 "
                "cell solve could not descend below the zero-corrector "
                "energy). First cells: %s",
                fallback_cells.size, fallback_cells[:5].tolist(),
            )
        self.diagnostics_contrast = float(stats[3])

        bc_dtype = torch.float64 if self._macro_f64 else self._dtype
        mask, bvals = merge_bcs(self._bcs, self._V_macro.num_dofs, bc_dtype, dev)
        if self._b_load is None:
            verts = sys.verts64 if self._macro_f64 else sys.verts
            self._b_load = assemble_load_vector(
                verts, sys.cells, self._f_fn, bs=self._V_macro.bs,
                degree=self._quad_degree_rhs,
            )
        t0 = time.perf_counter()
        vals_bc, b_bc = assemble_macro_system(
            sys, A_star, self._b_load, mask, bvals, macro_f64=self._macro_f64
        )
        x, iters, res = solve_ell(
            vals_bc, sys.cols, b_bc, self._options_global, dia=sys.dia
        )
        res = float(res)  # the solve's closing host sync
        t_macro = time.perf_counter() - t0
        if iters >= self._options_global.maxiter:
            logger.error(
                "Something went wrong in the global problem solve: CG hit "
                "maxiter=%d with residual %.3e", iters, res,
            )
        n_cells = int(sys.centers.shape[0])
        self.diagnostics = {
            "micro_seconds": t_micro,
            "macro_seconds": t_macro,
            "macro_iterations": int(iters),
            "macro_residual": res,
            "nan_cells": nan_cells,
            "diverged_cells": diverged_cells,
            "fallback_cells": fallback_cells,
            "num_cells": n_cells,
            "unique_cells": n_cells,
        }
        self._u = Function(self._V_macro, x.to(self._dtype))
        self._u.solver_iterations = int(iters)
        self._u.solver_residual = res
        return self._u


class PoissonHMM(BaseHMM):
    r"""HMM for the multiscale Poisson problem  -div(A(x, x/eps) ∇u) = f,
    with a zero Dirichlet BC on the bounding-box boundary installed by
    default."""

    _bs = 1

    def __init__(self, msh, A, f, msh_micro, eps, *args, **kwargs):
        super().__init__(msh, A, f, msh_micro, eps, *args, **kwargs)
        self._bcs = [_box_boundary_zero_bc(self._V_macro)]


class LinearElasticityHMM(BaseHMM):
    r"""HMM for multiscale linear elasticity.  A(x, y) is a fourth-order
    Hooke tensor (d, d, d, d); the cell problems use the strain
    e(u) = ½(∇u + ∇uᵀ) and solve the d(d+1)/2 Voigt generators on the
    chunk Cholesky route (kernel K3 on the card).  No default boundary
    conditions — set them via :meth:`set_boundary_conditions`."""

    def __init__(self, msh, A, f, msh_micro, eps, *args, **kwargs):
        self._bs = msh.dim
        super().__init__(msh, A, f, msh_micro, eps, *args, **kwargs)


class LinearElasticityStratifiedHMM(LinearElasticityHMM):
    r"""Stratified elasticity HMM: corrector strains use the deformed strain
    e_D(u) = ½(Dθᵀ ∇̄u + (Dθᵀ ∇̄u)ᵀ) with ∇̄ = nabla_grad = gradᵀ, from the
    user's ``Dtheta_transpose(x) -> (d, d)``; the macro basis part keeps
    the plain strain e."""

    def __init__(
        self, msh, A, f, msh_micro, eps, Dtheta_transpose: Callable, *args, **kwargs
    ):
        self._Dtheta_t = Dtheta_transpose
        super().__init__(msh, A, f, msh_micro, eps, *args, **kwargs)

    def _G_fn(self):
        return self._Dtheta_t


def _box_boundary_zero_bc(V: FunctionSpace) -> DirichletBC:
    """Zero Dirichlet BC on the bounding-box boundary."""
    mesh = V.mesh
    lo, hi = mesh.bounding_box()

    def marker(x):
        m = np.zeros(x.shape[1], dtype=bool)
        for k in range(mesh.dim):
            m |= np.isclose(x[k], lo[k]) | np.isclose(x[k], hi[k])
        return m

    return dirichletbc(
        0.0 if V.bs == 1 else np.zeros(V.bs), locate_dofs_geometrical(V, marker), V
    )
