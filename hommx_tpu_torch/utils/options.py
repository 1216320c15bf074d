"""Solver configuration (torch port of ``hommx_tpu/utils/options.py``).

``SolverOptions`` configures a solve level.  PETSc-style dicts are accepted
too, and their common keys are translated (``ksp_atol``, ``ksp_rtol``,
``ksp_max_it``, ``ksp_type``, ``pc_type``); unknown keys are ignored with a
warning.  ``cell_problem_engine_kwargs`` maps cell-problem options onto the
micro engine's arguments.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional, Union

logger = logging.getLogger(__name__)

__all__ = ["SolverOptions", "cell_problem_engine_kwargs"]


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    """Options for a linear solve level (macro solve or micro cell solves).

    Attributes:
        method: 'auto' | 'direct' | 'cg'.  'auto' takes a dense Cholesky for
            systems up to ``direct_threshold`` unknowns, CG above.
        atol, rtol, maxiter: CG stopping criteria.
        direct_threshold: size cutoff for the 'auto' dense path.
        pc: CG preconditioner — 'auto' and 'mg' take the geometric
            multigrid V-cycle on structured meshes and the aggregation-AMG
            V-cycle on the others (the diagonal at or below its 1500-unknown
            bottom size), 'jacobi' the diagonal.
        dtype: kept for API parity with the reference.
    """

    method: str = "auto"
    atol: float = 1e-12
    rtol: float = 1e-10
    maxiter: int = 10000
    direct_threshold: int = 4096
    pc: str = "auto"
    dtype: Optional[str] = None

    @staticmethod
    def from_any(
        opts: Union["SolverOptions", dict, None], default: "SolverOptions" = None
    ) -> "SolverOptions":
        if opts is None:
            return default if default is not None else SolverOptions()
        if isinstance(opts, SolverOptions):
            return opts
        if isinstance(opts, dict):
            return _from_petsc_dict(opts, default)
        raise TypeError(f"cannot build SolverOptions from {type(opts)}")


def _from_petsc_dict(d: dict, default: Optional[SolverOptions]) -> SolverOptions:
    """SolverOptions from a PETSc-style dict, over ``default``."""
    base = default if default is not None else SolverOptions()
    kw = {}
    for key, val in d.items():
        if key == "ksp_atol":
            kw["atol"] = float(val)
        elif key == "ksp_rtol":
            kw["rtol"] = float(val)
        elif key == "ksp_max_it":
            kw["maxiter"] = int(val)
        elif key == "ksp_type":
            if val in ("preonly",):
                kw["method"] = "direct"
            elif val == "cg":
                kw["method"] = "cg"
            elif val == "gmres":
                # every system of this framework is SPD, so CG is the
                # Krylov method; the mapping is said out loud
                logger.warning(
                    "SolverOptions: mapping ksp_type='gmres' to CG (all "
                    "systems produced by this framework are SPD; a "
                    "nonsymmetric Krylov method is not provided)"
                )
                kw["method"] = "cg"
        elif key == "pc_type":
            if val == "lu":
                kw["method"] = "direct"
            elif val in ("gamg", "mg", "hypre"):
                if val != "mg":
                    logger.info(
                        "SolverOptions: mapping pc_type=%r to the built-in "
                        "geometric/aggregation multigrid preconditioner",
                        val,
                    )
                kw["pc"] = "mg"
            elif val in ("jacobi", "none"):
                kw["pc"] = "jacobi"
        elif key == "pc_factor_mat_solver_type":
            pass  # mumps etc.: the dense direct path covers it
        else:
            logger.warning("SolverOptions: ignoring unknown PETSc option %r", key)
    return dataclasses.replace(base, **kw)


def cell_problem_engine_kwargs(opts: Union[SolverOptions, dict, None]) -> dict:
    """Translate cell-problem solver options into ``MicroEngine`` kwargs.

    - ``ksp_rtol`` (or ``SolverOptions.rtol``) → ``pcg_tol``: both are
      relative-residual criteria.  ``ksp_atol`` alone maps onto ``pcg_tol``
      too, as an approximation (an absolute criterion against the engine's
      relative one), with a warning.  When both are given, ``ksp_rtol``
      wins and ``ksp_atol`` is dropped.
    - ``ksp_max_it`` / ``maxiter`` → ``pcg_maxiter``.
    - ``ksp_type`` ``preonly`` / ``pc_type`` ``lu`` → ``solver='cholesky'``
      (a scalar problem takes the per-cell Cholesky route);
      ``ksp_type`` ``cg``/``gmres`` → ``solver='pcg'``.
    - multigrid-ish ``pc_type`` values are accepted: the engine's own cell
      preconditioner plays that role.

    Only explicitly set fields are mapped (a plain ``SolverOptions()`` or
    ``None`` gives ``{}``), so the engine's per-dtype defaults survive.
    ``engine_kwargs`` entries win over this translation.
    """
    if opts is None:
        return {}
    kw: dict = {}
    if isinstance(opts, SolverOptions):
        base = SolverOptions()
        tol = None
        if opts.rtol != base.rtol:
            tol = float(opts.rtol)
        elif opts.atol != base.atol:
            tol = float(opts.atol)
            logger.warning(
                "cell problem options: atol=%g (an absolute criterion) is "
                "approximated by the engine's relative pcg_tol; set rtol "
                "for an exact mapping", tol,
            )
        if tol is not None:
            kw["pcg_tol"] = tol
        if opts.maxiter != base.maxiter:
            kw["pcg_maxiter"] = int(opts.maxiter)
        if opts.method == "direct":
            kw["solver"] = "cholesky"
        elif opts.method == "cg":
            kw["solver"] = "pcg"
        return kw
    if isinstance(opts, dict):
        if "ksp_rtol" in opts:
            kw["pcg_tol"] = float(opts["ksp_rtol"])
        elif "ksp_atol" in opts:
            kw["pcg_tol"] = float(opts["ksp_atol"])
            logger.warning(
                "cell problem options: ksp_atol=%g (an absolute criterion) "
                "is approximated by the engine's relative pcg_tol; pass "
                "ksp_rtol for an exact mapping", kw["pcg_tol"],
            )
        for key, val in opts.items():
            if key in ("ksp_atol", "ksp_rtol"):
                pass  # handled above (rtol wins; atol approximated)
            elif key == "ksp_max_it":
                kw["pcg_maxiter"] = int(val)
            elif key == "ksp_type":
                if val == "preonly":
                    kw["solver"] = "cholesky"
                elif val == "cg":
                    kw["solver"] = "pcg"
                elif val == "gmres":
                    logger.warning(
                        "cell problem options: mapping ksp_type='gmres' to "
                        "the CG-based micro solver (cell problems are SPD)"
                    )
                    kw["solver"] = "pcg"
            elif key == "pc_type":
                if val == "lu":
                    kw["solver"] = "cholesky"
                elif val in ("jacobi", "none", "gamg", "mg", "hypre"):
                    logger.info(
                        "cell problem options: pc_type=%r is covered by "
                        "the engine's built-in cell preconditioners "
                        "(cell_prec=)", val,
                    )
                else:
                    logger.warning("cell problem options: ignoring pc_type=%r", val)
            elif key == "pc_factor_mat_solver_type":
                kw["solver"] = "cholesky"
            else:
                logger.warning("cell problem options: ignoring unknown option %r", key)
        return kw
    raise TypeError(f"cannot build engine kwargs from {type(opts)}")
