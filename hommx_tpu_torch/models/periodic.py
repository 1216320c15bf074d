"""Classical periodic homogenization, A = A(y) with no slow variable (torch
port of ``hommx_tpu/models/periodic.py``).

``compute_effective_tensor`` solves the generator cell problems at one
point through ``MicroEngine.tensors_for_centers`` — the stencil PCG (K1 on
the card) for scalar problems, the chunk Cholesky route (K3 on the card in
float32) for Hooke tensors — and expands the correctors to the full
periodic node set.  ``solve`` then assembles the macro system with the
constant A_hom through the HMM's own assembly
(models/common.py::assemble_macro_system), so PoissonHMM ≡
PoissonPeriodicHMM for A = A(y) holds by construction: the same engine
route, the same per-cell stiffness formula.  ``ElasticityPeriodicHMM``
does the same for Hooke tensors (d(d+1)/2 generator problems).

``A_hom`` is a torch tensor on the model's device, (d, d) or (d, d, d, d).
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Union

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
from hommx_tpu_torch.models.fem import _as_source
from hommx_tpu_torch.ops.assembly import assemble_load_vector
from hommx_tpu_torch.ops.function_space import DirichletBC, Function, FunctionSpace
from hommx_tpu_torch.ops.solvers import STOP_TEST, solve_ell
from hommx_tpu_torch.ops.sparse import ell_to_dense
from hommx_tpu_torch.utils.options import SolverOptions, cell_problem_engine_kwargs

__all__ = ["BasePeriodicHMM", "PoissonPeriodicHMM", "ElasticityPeriodicHMM"]


class BasePeriodicHMM:
    """Shared machinery of the periodic homogenization solvers.

    Args mirror the reference's constructor (``hmm.py:1077-1132``); ``A``
    is a single-argument torch callable ``A(y)``.  ``dtype`` defaults to
    float64 on the CPU and float32 on CUDA; ``device`` is the card unless
    the caller passes "cpu".  Like the reference, no default boundary
    condition is set: call :meth:`set_boundary_conditions` before
    :meth:`solve`.
    """

    _bs = 1

    def __init__(
        self,
        msh,
        A: Callable,
        f,
        msh_micro,
        eps: float = 1.0,
        options_global_solve: Union[SolverOptions, dict, None] = None,
        options_cell_problem: Union[SolverOptions, dict, None] = None,
        *,
        quad_degree_micro: int = 2,
        quad_degree_rhs: int = 2,
        dtype: Optional[torch.dtype] = None,
        device="cuda",
        petsc_options_global_solve: Optional[dict] = None,
        petsc_options_cell_problem: Optional[dict] = None,
        petsc_options_prefix: str = "",
    ):
        if msh_micro.dim not in (2, 3):
            raise ValueError("Only 2D and 3D periodic homogenization supported.")
        if msh_micro.volume() == 0.0:
            raise ValueError("Micro cell volume is zero; check the input mesh.")
        self._msh = msh
        self._cell_mesh = msh_micro
        self._coeff = A
        self._eps = float(eps)
        self._tdim = msh_micro.dim
        self._device = as_device(device)
        self._dtype = dtype or default_dtype(self._device)
        options_global_solve = options_global_solve or petsc_options_global_solve
        options_cell_problem = options_cell_problem or petsc_options_cell_problem
        self._options_global = SolverOptions.from_any(options_global_solve)
        self._options_cell = SolverOptions.from_any(options_cell_problem)
        self._quad_degree_rhs = quad_degree_rhs

        bs = self._bs
        self._V_macro = FunctionSpace(msh, bs)
        self._V_micro = FunctionSpace(msh_micro, bs)
        self._engine = MicroEngine(
            msh_micro,
            bs=bs,
            coeff_kind=probe_coeff_kind(A, self._tdim, nargs=1),
            quad_degree=quad_degree_micro,
            dtype=self._dtype,
            device=self._device,
            **cell_problem_engine_kwargs(options_cell_problem),
        )
        self._f_fn = _as_source(f, bs)
        self._bcs: list[DirichletBC] = []
        self._A_hom: Optional[torch.Tensor] = None
        self._correctors: Optional[list] = None
        self._sys: Optional[MacroSystem] = None
        self._last_vals_bc = None
        self._u: Optional[Function] = None
        #: per-solve telemetry: micro and macro seconds, macro iterations
        self.diagnostics: dict = {}

    # -- reference API -------------------------------------------------------
    @property
    def function_space(self) -> FunctionSpace:
        return self._V_macro

    def set_boundary_conditions(self, bcs):
        self._bcs = bcs if isinstance(bcs, list) else [bcs]

    def set_right_hand_side(self, f):
        self._f_fn = _as_source(f, self._V_macro.bs)

    def compute_effective_tensor(self) -> torch.Tensor:
        """Solve the generator cell problems and return A_hom (reference
        ``hmm.py:1219-1245``): (d, d) for scalar problems, the (d, d, d, d)
        Hooke tensor for elasticity.  Also sets :attr:`correctors`."""
        coeff2 = lambda x, y: self._coeff(y)  # noqa: E731  (engine signature A(x, y))
        centers = torch.zeros((1, self._tdim), dtype=self._dtype, device=self._device)
        Astar, X = self._engine.tensors_for_centers(coeff2, centers, with_correctors=True)
        X = X[0]  # (n_red, s_full) generator correctors in the reduced space
        # expand to full micro dof vectors through the periodic map
        bs = self._V_micro.bs
        red = torch.as_tensor(self._engine.pmap.reduced_index, device=X.device)
        full = X.new_zeros((self._V_micro.num_dofs, X.shape[1]))
        for c in range(bs):
            full[c::bs, :] = X[red * bs + c, :]
        self._correctors = [Function(self._V_micro, full[:, k]) for k in range(X.shape[1])]
        self._A_hom = self._tensor_from_astar(Astar[0])
        return self._A_hom

    def _tensor_from_astar(self, Astar: torch.Tensor) -> torch.Tensor:
        return Astar  # scalar problems: (d, d) directly

    def _astar_matrix(self) -> torch.Tensor:
        """A_hom as the (s, s) block the macro assembly takes per cell."""
        return self._A_hom

    @property
    def correctors(self):
        return self._correctors

    @property
    def A_hom(self) -> Optional[torch.Tensor]:
        return self._A_hom

    def solve(self) -> Function:
        """Macro FEM solve with the constant effective tensor (reference
        ``hmm.py:1247-1256``), assembled in float64 as the HMM's macro
        system is; a float32 scalar CG system is rounded once."""
        dev = self._device
        sync(dev)
        t0 = time.perf_counter()
        if self._A_hom is None:
            self.compute_effective_tensor()
        sync(dev)
        t_micro = time.perf_counter() - t0
        t0 = time.perf_counter()
        if self._sys is None:
            self._sys = MacroSystem(self._V_macro, self._dtype, dev)
        sys = self._sys
        V = self._V_macro
        mask, bvals = merge_bcs(self._bcs, V.num_dofs, torch.float64, dev)
        b = assemble_load_vector(sys.verts64, sys.cells, self._f_fn, bs=V.bs,
                                 degree=self._quad_degree_rhs, gather=sys.load_gather)
        A = self._astar_matrix()
        method = self._options_global.method
        if method == "auto":
            method = "direct" if V.num_dofs <= self._options_global.direct_threshold else "cg"
        vals_bc, b_bc = assemble_macro_system(
            sys, A.expand(sys.centers.shape[0], *A.shape), b, mask, bvals,
            macro_f64=method == "direct" or V.bs > 1,
        )
        mg, amg = macro_precs(sys, self._options_global)
        steps0 = STOP_TEST.steps
        x, iters, res = solve_ell(vals_bc, sys.cols, b_bc, self._options_global, dia=sys.dia,
                                  mg=mg, amg=amg)
        res = float(res)
        self._last_vals_bc = vals_bc
        self.diagnostics = {
            "micro_seconds": t_micro,
            "macro_seconds": time.perf_counter() - t0,
            "macro_method": method,
            "macro_iterations": int(iters),
            "macro_steps": STOP_TEST.steps - steps0,
            "macro_residual": res,
            "macro_amg_levels": None if amg is None else amg.level_sizes,
        }
        self._u = Function(V, x.to(self._dtype))
        self._u.solver_iterations = int(iters)
        self._u.solver_residual = res
        return self._u

    def matrix_dense(self) -> np.ndarray:
        """The BC-applied macro matrix of the last solve as dense numpy."""
        if self._last_vals_bc is None:
            raise RuntimeError("call solve() first")
        return ell_to_dense(self._last_vals_bc, self._sys.cols).cpu().numpy()

    def plot_solution(self, u: Optional[Function] = None, **kw):
        """Plot ``u`` (the last solution by default) with
        :func:`hommx_tpu_torch.utils.plotting.plot_fem_function`; ``kw``
        are its options (``filename``, ``title``, ``cmap``, ``show``,
        ``warp``).  Returns the figure."""
        from hommx_tpu_torch.utils.plotting import plot_fem_function

        if u is None and self._u is None:
            raise RuntimeError("call solve() first")
        return plot_fem_function(self._V_macro, u if u is not None else self._u, **kw)


class PoissonPeriodicHMM(BasePeriodicHMM):
    """Periodic homogenization for scalar diffusion (reference
    ``hmm.py:1259-1279``)."""

    _bs = 1


class ElasticityPeriodicHMM(BasePeriodicHMM):
    """Periodic homogenization for linear elasticity: A(y) is a (d,d,d,d)
    Hooke tensor and ``A_hom`` the homogenized Hooke tensor."""

    def __init__(self, msh, A, f, msh_micro, *args, **kwargs):
        self._bs = msh_micro.dim
        super().__init__(msh, A, f, msh_micro, *args, **kwargs)

    def _tensor_from_astar(self, Astar: torch.Tensor) -> torch.Tensor:
        d = self._tdim
        # engine layout A*[(ij), (kl)] -> Hooke A[i, j, k, l]
        return Astar.reshape(d, d, d, d)

    def _astar_matrix(self) -> torch.Tensor:
        d = self._tdim
        return self._A_hom.reshape(d * d, d * d)
