"""Macro linear solvers: Jacobi-preconditioned CG and the dense direct solve
(torch port of ``hommx_tpu/ops/solvers.py``).

The CG loop is Python; its stop test reads the residual norm back from the
device once per iteration.  On a structured mesh the CG matvec is the DIA
SpMV, one ``DIAOperator`` (ops/dia.py) per solve, dispatched by device
alone: the hand-written CUDA kernel for every CUDA system, whatever its
size, and the plain version on the CPU.
The kernel is float32 only; a float64 CUDA system raises there (ROADMAP C).
Geometric multigrid and AMG preconditioning are not ported yet (ROADMAP
A5, A10): ``pc`` 'auto'/'mg' on the CG path raises.
"""

from __future__ import annotations

import torch

from hommx_tpu_torch.ops.sparse import ell_to_dense, spmv

__all__ = [
    "cg_ell",
    "cg_matfree",
    "pcg_prec",
    "dense_solve_ell",
    "solve_ell",
    "require_jacobi",
]


def require_jacobi(options) -> None:
    """Raise for the CG preconditioners that are not ported yet."""
    if options.pc in ("auto", "mg"):
        raise NotImplementedError(
            f"macro CG with pc={options.pc!r}: geometric multigrid is not "
            "ported yet (ROADMAP A5); pass SolverOptions(pc='jacobi')"
        )


def _ell_diag(vals: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    N, K = cols.shape
    rows = torch.arange(N, device=cols.device)[:, None]
    isdiag = (cols == rows).to(vals.dtype)
    return (vals.reshape(N, K) * isdiag).sum(dim=1)


def pcg_prec(matvec, prec, b, x0=None, atol=1e-12, rtol=1e-12, maxiter=10000):
    """Matrix-free PCG with an SPD preconditioner callable ``prec(r) -> z``.

    Stops when ‖r‖ <= max(atol, rtol·‖b‖) or at ``maxiter``.
    Returns (x, iterations, final residual norm as a 0-d tensor)."""
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    z = prec(r)
    p = z
    rz = torch.dot(r, z)
    tol = max(float(atol), float(rtol) * float(torch.linalg.norm(b)))
    k = 0
    while k < maxiter and float(torch.linalg.norm(r)) > tol:
        Ap = matvec(p)
        alpha = rz / torch.dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = prec(r)
        rz_new = torch.dot(r, z)
        beta = rz_new / rz
        p = z + beta * p
        rz = rz_new
        k += 1
    return x, k, torch.linalg.norm(r)


def cg_matfree(matvec, diag, b, x0=None, atol=1e-12, rtol=1e-12, maxiter=10000):
    """Matrix-free PCG with the Jacobi preconditioner ``diag``."""
    one = torch.ones((), dtype=diag.dtype, device=diag.device)
    dinv = torch.where(diag.abs() > 0, one / diag, one)
    return pcg_prec(matvec, lambda r: dinv * r, b, x0, atol, rtol, maxiter)


def cg_ell(vals, cols, b, x0=None, atol=1e-12, rtol=1e-12, maxiter=10000):
    """Jacobi-preconditioned CG on an ELL matrix (gather SpMV)."""
    return cg_matfree(
        lambda v: spmv(vals, cols, v), _ell_diag(vals, cols), b, x0, atol, rtol, maxiter
    )


def dense_solve_ell(vals, cols, b):
    """Dense direct solve of the ELL system in float64 (small macro
    systems): symmetrize, Cholesky-factor, solve; cast back to b's dtype."""
    A = ell_to_dense(vals.to(torch.float64), cols)
    A = 0.5 * (A + A.T)
    L = torch.linalg.cholesky(A)
    x = torch.cholesky_solve(b.to(torch.float64)[:, None], L)[:, 0]
    return x.to(b.dtype)


def solve_ell(vals, cols, b, options, dia=None):
    """Dispatch on SolverOptions: 'direct', 'cg', or 'auto' (direct up to
    ``direct_threshold`` unknowns).  Returns (x, iterations, residual)."""
    method = options.method
    if method == "auto":
        method = "direct" if b.shape[0] <= options.direct_threshold else "cg"
    if method == "direct":
        x = dense_solve_ell(vals, cols, b)
        return x, 0, torch.zeros((), dtype=b.dtype, device=b.device)
    require_jacobi(options)
    if dia is not None:
        from hommx_tpu_torch.ops import dia as dia_ops

        op = dia_ops.DIAOperator(dia_ops.ell_vals_to_dia(dia, vals), dia.offsets)
        # one buffer for every product: pcg_prec keeps no A·p across
        # iterations, and on the card the stream orders each overwrite
        # after the reads of the one before
        matvec = lambda v: op(v, out=op.out)
        return cg_matfree(
            matvec, _ell_diag(vals, cols), b,
            atol=options.atol, rtol=options.rtol, maxiter=options.maxiter,
        )
    return cg_ell(vals, cols, b, atol=options.atol, rtol=options.rtol, maxiter=options.maxiter)
