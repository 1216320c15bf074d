"""HMM solver classes (torch port of ``hommx_tpu/models/hmm.py``:
``BaseHMM``, ``PoissonHMM``, ``PoissonStratifiedHMM``,
``LinearElasticityHMM`` and ``LinearElasticityStratifiedHMM``).

``solve()`` runs

    micro stage:  A*(c_T) for every macro cell (micro/engine.py), one
                  representative per class of identical cell problems
                  (``dedup_cells``, on by default as in the reference)
    macro stage:  S_loc[c] = |T_c| · P A*(c_T)ᵀ Pᵀ (P the P1 gradients, or
                  the strain coefficients for elasticity), ELL scatter
                  assembly, symmetric Dirichlet lifting, CG / dense-Cholesky
                  solve.

``eps`` is kept for API parity; it cancels exactly in the reference's
scaling chain, so it does not enter the computation.

Above ``direct_threshold`` the macro solve is CG preconditioned by the
geometric multigrid V-cycle (the default ``SolverOptions()``), in float32
for a float32 Poisson system and in float64 for every elasticity system.
Every macro system is assembled in float64; a float32 Poisson CG system is
rounded to float32 once, after its assembly (a divergence from the
reference, which accumulates it in float32; ROADMAP C).  On a mesh without a
geometric hierarchy (a Delaunay or file mesh) the CG takes the aggregation-AMG
V-cycle (ops/amg.py).  Both option levels take ``SolverOptions`` or PETSc-style
dicts.  With a ``shard_mesh`` (parallel/sharding.py) the micro stage runs
shard by shard and a CG macro solve row-sharded (parallel/macro.py).

``build_pipeline()`` returns the whole solve as a function of the cell
centers, differentiable end to end: every cell solve and the macro solve
run under the implicit-function rule (ops/solvers.py::
implicit_linear_solve), so ``torch.autograd.grad`` through it launches K1
or K3 and K2 again for the adjoint solves, and never unrolls a loop.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Optional, Union

import numpy as np
import torch

from hommx_tpu_torch.config import as_device, default_dtype, sync
from hommx_tpu_torch.micro.chunk import _map_G
from hommx_tpu_torch.micro.engine import MicroEngine
from hommx_tpu_torch.micro.krylov import _map_chunked
from hommx_tpu_torch.models.common import (
    MacroSystem,
    assemble_macro_system,
    macro_precs,
    merge_bcs,
    probe_coeff_kind,
)
from hommx_tpu_torch.models.fem import _as_source
from hommx_tpu_torch.ops.assembly import assemble_load_vector
from hommx_tpu_torch.ops.function_space import (
    DirichletBC,
    Function,
    FunctionSpace,
    dirichletbc,
    locate_dofs_geometrical,
)
from hommx_tpu_torch.ops.solvers import STOP_TEST, make_implicit_solver, solve_ell
from hommx_tpu_torch.ops.sparse import ell_to_dense
from hommx_tpu_torch.parallel.macro import (
    can_shard_macro,
    can_shard_macro_ell,
    make_sharded_solver,
)
from hommx_tpu_torch.parallel.sharding import ShardMesh, shard_cells
from hommx_tpu_torch.utils.options import SolverOptions, cell_problem_engine_kwargs
from hommx_tpu_torch.utils.profiling import span

__all__ = [
    "BaseHMM",
    "PoissonHMM",
    "PoissonStratifiedHMM",
    "LinearElasticityHMM",
    "LinearElasticityStratifiedHMM",
]

#: random projections per cell in the dedup fingerprint
_FP_PROJECTIONS = 16

logger = logging.getLogger("hommx_tpu_torch")


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
        options_global_solve: macro SolverOptions or PETSc-style dict.
        options_cell_problem: cell-problem SolverOptions or PETSc-style
            dict, translated by ``cell_problem_engine_kwargs`` into the
            micro engine's options.
        dtype: pipeline dtype (default: float64 on CPU, float32 on CUDA).
        device: torch device of every tensor of the solve (the card by
            default; pass "cpu" for the CPU).
        chunk: cells per micro chunk (0 = auto).
        engine_kwargs: extra MicroEngine options (``pcg_tol``, ...); they
            win over ``options_cell_problem``.
        shard_mesh: optional ShardMesh (parallel/sharding.py): ``solve()``
            then runs the micro stage shard by shard over the macro-cell
            batch (the deduplicated representatives, or every cell) and a
            CG macro solve row-sharded (parallel/macro.py), one DIA product
            per shard per step.  Its first device should be ``device``,
            where the shards' results are gathered.
        dedup_cells: solve one representative per class of identical cell
            problems.  Two macro cells whose solve inputs — the reduced
            coefficient A(c_T, y_q) and the stratified map Dθᵀ(c_T) — are
            bitwise equal have the same homogenized tensor; the classes come
            from 16 random projections of those inputs per cell.  Declined
            below a 2× reduction or under 16 cells.  Exact for the direct
            micro solver; on the lockstep PCG results move within solver
            tolerance (the chunks hold other cells).  Pass False to solve
            every cell, as throughput measurements do.
            ``diagnostics["unique_cells"]`` records the class count.
        dedup_verify: re-solve up to this many random non-representative
            class members and raise RuntimeError if they disagree with
            their representative beyond solver tolerance (a fingerprint
            collision).
        petsc_options_global_solve, petsc_options_cell_problem,
        petsc_options_prefix: the reference's aliases of the two option
            levels (the prefix is accepted and unused).
    """

    _bs: int = 1

    def __init__(
        self,
        msh,
        A: Callable,
        f,
        msh_micro,
        eps: float,
        options_global_solve: Union[SolverOptions, dict, None] = None,
        options_cell_problem: Union[SolverOptions, dict, None] = None,
        *,
        quad_degree_micro: int = 2,
        quad_degree_rhs: int = 2,
        dtype: Optional[torch.dtype] = None,
        device="cuda",
        chunk: int = 0,
        engine_kwargs: Optional[dict] = None,
        shard_mesh=None,
        dedup_cells: bool = True,
        dedup_verify: int = 0,
        petsc_options_global_solve: Optional[dict] = None,
        petsc_options_cell_problem: Optional[dict] = None,
        petsc_options_prefix: str = "",
    ):
        if msh.dim not in (2, 3):
            raise ValueError("Topology should be 3D or 2D")
        if msh.dim != msh_micro.dim:
            raise ValueError("Micro and macro mesh should have the same dimensionality.")
        self._shard_mesh = _check_mesh(shard_mesh)
        self._msh = msh
        self._cell_mesh = msh_micro
        self._coeff = A
        self._eps = float(eps)
        self._device = as_device(device)
        self._dtype = dtype or default_dtype(self._device)
        self._tdim = msh.dim
        options_global_solve = options_global_solve or petsc_options_global_solve
        options_cell_problem = options_cell_problem or petsc_options_cell_problem
        self._options_global = SolverOptions.from_any(options_global_solve)
        self._options_cell = SolverOptions.from_any(options_cell_problem)
        self._chunk = chunk
        self._quad_degree_rhs = quad_degree_rhs
        self._dedup_cells = bool(dedup_cells)
        self._dedup_verify = int(dedup_verify)
        self._n_unique: Optional[int] = None
        self._fp_fn = None
        self._dedup_cache = False  # False = not yet computed (None is valid)

        bs = self._block_size()
        self._V_macro = FunctionSpace(msh, bs)
        self._sys = MacroSystem(self._V_macro, self._dtype, self._device)
        cell_kw = cell_problem_engine_kwargs(options_cell_problem)
        cell_kw.update(engine_kwargs or {})
        self._engine = MicroEngine(
            msh_micro,
            bs=bs,
            coeff_kind=self._coeff_kind(),
            quad_degree=quad_degree_micro,
            dtype=self._dtype,
            device=self._device,
            **cell_kw,
        )
        self._f_fn = _as_source(f, bs)
        self._bcs: list = []
        self._A_star: Optional[torch.Tensor] = None
        self._b_load = None
        self._last_vals_bc = None
        self._u: Optional[Function] = None
        m = self._options_global.method
        if m == "auto":
            m = (
                "direct"
                if self._V_macro.num_dofs <= self._options_global.direct_threshold
                else "cg"
            )
        self._macro_method = m
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

    def set_right_hand_side(self, f):
        """Replace the rhs f; the micro stage's tensors stay cached, only
        the load vector is rebuilt at the next solve."""
        self._f_fn = _as_source(f, self._V_macro.bs)
        self._b_load = None

    def _micro(self, centers: torch.Tensor) -> torch.Tensor:
        return _micro_stage(self._engine, self._coeff, self._G_fn(), self._chunk,
                            self._shard_mesh, centers)

    def homogenized_tensors(self) -> torch.Tensor:
        """A*(c_T) per macro cell, (nc, s, s) — the micro stage output,
        cached across solves.  With ``dedup_cells`` one representative per
        class is solved and its tensor scattered to the class; the classes
        come from the whole batch, and with a ``shard_mesh`` the solved
        batch is split over the shards."""
        if self._A_star is None:
            centers = self._sys.centers
            classes = self._dedup_classes(centers) if self._dedup_cells else None
            if classes is not None:
                rep, inverse = classes
                A_u = self._micro(centers[torch.as_tensor(rep, device=self._device)])
                if self._dedup_verify > 0:
                    self._audit_dedup(centers, rep, inverse, A_u)
                self._A_star = A_u[torch.as_tensor(inverse, device=self._device)]
            else:
                self._A_star = self._micro(centers)
        return self._A_star

    def _audit_dedup(self, centers, rep, inverse, A_u):
        """Re-solve up to ``dedup_verify`` random non-representative class
        members and compare them with their representative's tensor.  Class
        members have bitwise-equal inputs, so a re-solve agrees to solver
        accuracy (exactly for the direct micro solver, within PCG tolerance
        for the lockstep chunks); a fingerprint collision between distinct
        cells disagrees at O(1)."""
        rng = np.random.default_rng(0xA0D17)
        members = np.setdiff1d(np.arange(centers.shape[0]), np.asarray(rep))
        if members.size == 0:
            return
        k = min(self._dedup_verify, int(members.size))
        sample = rng.choice(members, size=k, replace=False)
        dev = self._device
        A_resolved = self._micro(centers[torch.as_tensor(sample, device=dev)])
        A_claimed = A_u[torch.as_tensor(np.asarray(inverse)[sample], device=dev)]
        # the engine's effective tolerance: a user-loosened iterative solve
        # legitimately moves re-solves by ~pcg_tol
        tol = 1e-4 if self._dtype == torch.float32 else 1e-8
        if self._engine.solver == "pcg":
            tol = max(tol, 10.0 * self._engine.pcg_tol)
        scale = float(A_u.abs().max())
        diff = float((A_resolved - A_claimed).abs().max()) / (scale + 1e-300)
        if not diff < tol:
            raise RuntimeError(
                f"dedup audit failed: re-solved class members disagree with "
                f"their representatives (rel {diff:.2e} > {tol:.0e}) "
                f"— fingerprint collision between distinct cell problems; "
                f"re-run with dedup_cells=False"
            )
        logger.info("dedup audit: %d re-solved members agree (rel %.2e)", k, diff)

    def _fingerprint(self):
        """The dedup key function, cached: centers (C, d) -> (C, 16), the
        reduced coefficient (and Dθᵀ) of each cell times fixed random
        projections.  W is drawn from one seeded generator in the
        reference's order (coefficient first, then the map), so both
        packages compute the same keys."""
        if self._fp_fn is None:
            eng, coeff, G_fn = self._engine, self._coeff, self._G_fn()
            k = _FP_PROJECTIONS
            rng = np.random.default_rng(0x5EED)
            n_raw = eng.nE if eng.coeff_kind == "scalar" else eng.nE * eng.r * eng.r
            opts = dict(dtype=eng.dtype, device=eng.device)
            W = torch.as_tensor(rng.standard_normal((n_raw, k)), **opts)
            Wg = None
            if G_fn is not None:
                Wg = torch.as_tensor(rng.standard_normal((eng.d * eng.d, k)), **opts)

            def fp(cs):
                C = cs.shape[0]
                raw = torch.func.vmap(lambda x: eng._raw_coeff(coeff, x))(cs)
                out = raw.reshape(C, -1) @ W
                if Wg is not None:
                    out = out + _map_G(eng, G_fn, cs).reshape(C, -1) @ Wg
                return out

            self._fp_fn = fp
        return self._fp_fn

    def _dedup_classes(self, centers):
        """Exact-duplicate classes of the cell batch: (rep_indices, inverse)
        with ``A_star = A_star_unique[inverse]``, or None when dedup does not
        pay (< 2× reduction, or under 16 cells).

        The keys are computed on the device in chunks of one shape (the last
        one padded), so that identical cells get bitwise-identical keys
        whatever chunk they fall in, and read back for ``np.unique``.  The
        result is cached: the coefficient and the centers are fixed at
        construction."""
        if self._dedup_cache is not False:
            return self._dedup_cache
        nc = int(centers.shape[0])
        if nc < 16:
            self._dedup_cache = None
            return None
        chunk = self._chunk or self._engine._auto_chunk(nc)
        keys = _map_chunked(self._fingerprint(), centers, chunk).cpu().numpy()
        uniq, rep, inverse = np.unique(keys, axis=0, return_index=True, return_inverse=True)
        n_unique = int(uniq.shape[0])
        if n_unique * 2 > nc:
            # every cell is solved, so diagnostics report the full count
            self._n_unique = None
            self._dedup_cache = None
            return None
        self._n_unique = n_unique
        logger.info(
            "micro stage deduplicated: %d cells -> %d unique cell problems", nc, n_unique
        )
        self._dedup_cache = (rep.astype(np.int64), inverse.reshape(-1).astype(np.int64))
        return self._dedup_cache

    def cell_correctors(self, cells=None):
        """Generator correctors on the micro mesh for selected macro cells.

        Args:
            cells: macro cell indices (default: all cells).
        Returns:
            (A_star, X_full): homogenized tensors (nc_sel, s, s) and
            correctors (nc_sel, n_micro_nodes·bs, s) expanded to the full
            periodic micro node set.
        """
        centers = self._sys.centers
        if cells is not None:
            centers = centers[torch.as_tensor(np.asarray(cells), device=self._device)]
        A_star, X = self._engine.tensors_for_centers(
            self._coeff, centers, G_fn=self._G_fn(), with_correctors=True
        )
        eng = self._engine
        red = np.asarray(eng.pmap.reduced_index)  # (n_nodes,)
        comp = np.arange(eng.bs)
        idx = (red[:, None] * eng.bs + comp[None, :]).reshape(-1)
        return A_star, X[:, torch.as_tensor(idx, device=X.device), :]

    def local_stiffness(self) -> torch.Tensor:
        """S_loc per cell, (nc, nb, nb) in the pipeline dtype: |T|·P A*ᵀ Pᵀ
        with P the P1 gradients (or the strain coefficients)."""
        A_T = self.homogenized_tensors().transpose(-1, -2)  # reference index order
        sys = self._sys
        if self._V_macro.bs == 1:
            return torch.einsum("c,cad,cde,cbe->cab", sys.vols, sys.grads, A_T, sys.grads)
        return torch.einsum("c,cmr,crt,cnt->cmn", sys.vols, sys.strain_P, A_T, sys.strain_P)

    def build_pipeline(self, shard_mesh=None, shard_mode: str = "auto"):
        """The whole HMM solve as a function of tensors, ``step(centers) ->
        u``: the micro stage over every cell, the load vector, the float64
        macro assembly with its Dirichlet lifting (rounded once to the
        pipeline dtype on a float32 CG path), the macro solve and u in the
        model's dtype.

        ``step`` is differentiable in ``centers`` and in every tensor the
        coefficient, the map Dθᵀ or the rhs close over: the cell solves and
        the macro solve carry the implicit-function rule, whose adjoints are
        solves by the same routes (K1 or K3, and the macro CG through K2 or
        the direct solve); ``torch.autograd.grad(..., create_graph=True)``
        gives second derivatives.  ``step.macro_solve.iterations`` lists the
        macro solves' iteration counts, forward and adjoint, in order.  A
        call is the span ``hommx.step`` around ``hommx.micro``,
        ``hommx.macro.assemble`` and ``hommx.macro.solve``
        (utils/profiling.py).

        The pipeline does not deduplicate cell problems, as in the
        reference: every cell is solved on every call.

        Args:
            shard_mesh: optional ShardMesh (default: the constructor's).  The
                micro stage then runs shard by shard (parallel/sharding.py::
                shard_cells), and a CG macro solve that can be row-sharded
                runs row-sharded (parallel/macro.py), with its implicit rule.
            shard_mode: ``'auto'``: the shards' cell solves keep the
                implicit rule, so the sharded pipeline is differentiable
                like the unsharded one.  ``'shard_map'``: the reference's
                explicit per-shard blocks, whose cell solves drop the rule
                (``implicit_diff=False``; primal only); the macro solve
                keeps its rule in both modes.  Without a mesh both modes
                are the unsharded pipeline.

        Returns: (step, centers), the centers of the macro cells (nc, d).
        """
        if shard_mode not in ("auto", "shard_map"):
            raise ValueError("shard_mode must be 'auto' or 'shard_map'")
        shard_mesh = self._shard_mesh if shard_mesh is None else _check_mesh(shard_mesh)
        engine, sys, coeff, G_fn = self._engine, self._sys, self._coeff, self._G_fn()
        f_fn, bs, chunk, dtype = self._f_fn, self._V_macro.bs, self._chunk, self._dtype
        rhs_degree, macro_f64 = self._quad_degree_rhs, self._macro_f64
        mask, bvals = merge_bcs(self._bcs, self._V_macro.num_dofs, torch.float64, self._device)
        options = self._options_global
        mg, amg = macro_precs(sys, options)
        if self._shards_macro(shard_mesh):
            macro_solve = make_sharded_solver(shard_mesh, sys.dia, sys.cols, options, mg=mg, amg=amg)
        else:
            macro_solve = make_implicit_solver(sys.cols, options, dia=sys.dia, mg=mg, amg=amg)
        # as the reference: only the sharded explicit blocks drop the rule
        implicit_diff = shard_mesh is None or shard_mode == "auto"

        def step(centers):
            with span("hommx.step"):
                A_star = _micro_stage(engine, coeff, G_fn, chunk, shard_mesh, centers,
                                      implicit_diff)
                with span("hommx.macro.assemble"):
                    b = assemble_load_vector(sys.verts64, sys.cells, f_fn, bs=bs,
                                             degree=rhs_degree, gather=sys.load_gather)
                    vals_bc, b_bc = assemble_macro_system(sys, A_star, b, mask, bvals,
                                                          macro_f64=macro_f64)
                return macro_solve(vals_bc, b_bc).to(dtype)

        step.macro_solve = macro_solve
        return step, sys.centers

    def _shards_macro(self, mesh) -> bool:
        """Whether the macro solve runs row-sharded over ``mesh``: a CG
        solve (the direct path's small systems stay replicated) whose rows
        can be split, with halo copies where there is a DIA view and the
        gathered ELL product otherwise."""
        if mesh is None or self._macro_method != "cg":
            return False
        if can_shard_macro(self._sys.dia, mesh.size):
            return True
        return self._sys.dia is None and can_shard_macro_ell(self._V_macro.num_dofs, mesh.size)

    def _use_sharded_macro(self) -> bool:
        """Whether ``solve()`` runs the row-sharded macro CG."""
        return self._shards_macro(self._shard_mesh)

    def _macro_solve(self, vals_bc, b_bc, mg, amg):
        """(x, iterations, residual) of the macro system: the row-sharded CG
        when :meth:`_use_sharded_macro`, else ``solve_ell``."""
        sys = self._sys
        if self._use_sharded_macro():
            solver = make_sharded_solver(self._shard_mesh, sys.dia, sys.cols,
                                         self._options_global, mg=mg, amg=amg)
            return solver.full(vals_bc, b_bc)
        return solve_ell(vals_bc, sys.cols, b_bc, self._options_global, dia=sys.dia,
                         mg=mg, amg=amg)

    def matrix_dense(self) -> np.ndarray:
        """The BC-applied macro matrix of the last solve as dense numpy
        (debugging and parity checks)."""
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

        # the macro chain runs in float64 (models/common.py)
        mask, bvals = merge_bcs(self._bcs, self._V_macro.num_dofs, torch.float64, dev)
        with span("hommx.macro.assemble"):
            if self._b_load is None:
                self._b_load = assemble_load_vector(
                    sys.verts64, sys.cells, self._f_fn, bs=self._V_macro.bs,
                    degree=self._quad_degree_rhs, gather=sys.load_gather,
                )
            t0 = time.perf_counter()
            vals_bc, b_bc = assemble_macro_system(
                sys, A_star, self._b_load, mask, bvals, macro_f64=self._macro_f64
            )
        mg, amg = macro_precs(sys, self._options_global)
        steps0 = STOP_TEST.steps
        x, iters, res = self._macro_solve(vals_bc, b_bc, mg, amg)
        res = float(res)  # the solve's closing host sync
        t_macro = time.perf_counter() - t0
        if iters >= self._options_global.maxiter:
            logger.error(
                "Something went wrong in the global problem solve: CG hit "
                "maxiter=%d with residual %.3e", iters, res,
            )
        n_cells = int(sys.centers.shape[0])
        self._last_vals_bc = vals_bc
        self.diagnostics = {
            "micro_seconds": t_micro,
            "macro_seconds": t_macro,
            "macro_iterations": int(iters),
            # CG loop bodies, the frozen ones after the stop included
            "macro_steps": STOP_TEST.steps - steps0,
            "macro_residual": res,
            # the AMG hierarchy's level sizes (None off the AMG route)
            "macro_amg_levels": None if amg is None else amg.level_sizes,
            "nan_cells": nan_cells,
            "diverged_cells": diverged_cells,
            "fallback_cells": fallback_cells,
            "num_cells": n_cells,
            "unique_cells": self._n_unique or n_cells,
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


class PoissonStratifiedHMM(PoissonHMM):
    r"""Stratified (deformed-laminate) Poisson HMM: the coefficient is
    A(x, θ(x)/eps); the user supplies ``Dtheta_transpose(x) -> (d, d)``
    with entries ∂θ_j/∂x_i, which maps the corrector gradients of the cell
    problems (stencil weights from GᵀG, loads from GᵀE; K1 unchanged)."""

    def __init__(
        self, msh, A, f, msh_micro, eps, Dtheta_transpose: Callable, *args, **kwargs
    ):
        self._Dtheta_t = Dtheta_transpose
        super().__init__(msh, A, f, msh_micro, eps, *args, **kwargs)

    def _G_fn(self):
        return self._Dtheta_t


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


def _micro_stage(engine, coeff, G_fn, chunk, shard_mesh, centers, implicit_diff=True):
    """A*(c_T) of every center, shard by shard over ``shard_mesh`` (gathered
    on the centers' device) or at once: the span ``hommx.micro``."""
    with span("hommx.micro"):
        def fn(cs):
            return engine.tensors_for_centers(coeff, cs, G_fn=G_fn, chunk=chunk,
                                              implicit_diff=implicit_diff)

        if shard_mesh is None:
            return fn(centers)
        return shard_cells(shard_mesh, fn, centers).to(centers.device)


def _check_mesh(mesh):
    if mesh is not None and not isinstance(mesh, ShardMesh):
        raise TypeError(f"shard_mesh must be a ShardMesh or None, not {type(mesh).__name__}")
    return mesh


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
