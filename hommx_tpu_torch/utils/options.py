"""Solver configuration (torch port of ``hommx_tpu/utils/options.py``).

The PETSc-style dict translation and ``cell_problem_engine_kwargs`` are not
ported yet (ROADMAP A13).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

__all__ = ["SolverOptions"]


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    """Options for the macro linear solve.

    Attributes:
        method: 'auto' | 'direct' | 'cg'.  'auto' takes a dense Cholesky for
            systems up to ``direct_threshold`` unknowns, CG above.
        atol, rtol, maxiter: CG stopping criteria.
        direct_threshold: size cutoff for the 'auto' dense path.
        pc: CG preconditioner — 'jacobi' in this port; 'auto' and 'mg'
            (geometric multigrid) raise on the CG path until ROADMAP A5.
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
        opts: Union["SolverOptions", None], default: "SolverOptions" = None
    ) -> "SolverOptions":
        if opts is None:
            return default if default is not None else SolverOptions()
        if isinstance(opts, SolverOptions):
            return opts
        if isinstance(opts, dict):
            raise NotImplementedError(
                "PETSc-style option dicts are not ported yet (ROADMAP A13); "
                "pass SolverOptions"
            )
        raise TypeError(f"cannot build SolverOptions from {type(opts)}")
