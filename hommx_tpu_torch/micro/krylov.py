"""Chunk-level Krylov machinery for the micro engine (torch port of
``hommx_tpu/micro/krylov.py``): the lockstep block-PCG, the zero-corrector
energy clamp, and the chunked map.

The block-PCG runs as a Python loop whose stop test reads one scalar back
from the device per iteration.  On CUDA the main path does not run this
loop: the fused kernel (micro/stencil_pcg.py) keeps the whole iteration on
the card.  This loop is that kernel's plain version, the one CPU tensors
take.  :func:`_solve_linear` wraps either in the implicit-function rule
(ops/solvers.py::implicit_linear_solve).
"""

from __future__ import annotations

import torch

from hommx_tpu_torch.ops.solvers import implicit_linear_solve
from hommx_tpu_torch.utils.profiling import span

__all__ = [
    "_amp_cap",
    "_block_pcg_matfree",
    "_solve_linear",
    "_solve_unclamped",
    "_clamp",
    "_clamp_good",
    "_chunk_pcg_raw",
    "_map_chunked",
    "shared_prec",
]


def shared_prec(Minv: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """One dense (n, n) preconditioner applied to every column of R (n, s, C)."""
    n, s, C = R.shape
    return (Minv @ R.reshape(n, s * C)).reshape(n, s, C)


def _amp_cap(dtype) -> float:
    """Amplification-clamp threshold of the energy clamp (≈1/√eps of the
    working dtype): 1e4 in float32, 1e8 in float64."""
    return 1e4 if dtype == torch.float32 else 1e8


def _block_pcg_matfree(matvec, F, Minv, tol, maxiter):
    """Block-CG with s right-hand sides F (n, s), or a chunk of cells F (n,
    s, C), preconditioned by the explicit shared inverse Minv = K0⁻¹ (the
    reference's ``_block_pcg_matfree``, the per-cell route's PCG, which the
    reference vmaps over cells): the chunk loop's lockstep, freeze and stall
    rules, then the zero-corrector energy clamp.  Returns X shaped as F.
    Autograd records the loop: the per-cell route is differentiable by
    unrolling, which the reference's ``while_loop`` is not."""
    prec = (lambda R: shared_prec(Minv, R)) if F.ndim == 3 else (lambda R: Minv @ R)
    bX, _ = _chunk_pcg_raw(matvec, prec, F, tol, maxiter)
    good = _clamp_good(matvec, prec, F, bX)
    return torch.where(good[None], bX, torch.zeros((), dtype=bX.dtype, device=bX.device))


def _solve_linear(matvec, prec, F, tol, maxiter, with_iters=False, implicit_diff=True,
                  raw=None, operator=None):
    """Chunk PCG followed by the zero-corrector energy clamp, with the
    implicit-function rule (the reference's ``_solve_linear``):
    :func:`_solve_unclamped`, then :func:`_clamp`.  Returns (X, iters), the
    iteration count of the forward solve."""
    bX, iters = _solve_unclamped(matvec, prec, F, tol, maxiter, with_iters, implicit_diff,
                                 raw, operator)
    return _clamp(matvec, prec, F, bX), iters


def _solve_unclamped(matvec, prec, F, tol, maxiter, with_iters=False, implicit_diff=True,
                     raw=None, operator=None):
    """The chunk PCG under the implicit-function rule, before the clamp.

    ``raw`` optionally replaces the Krylov loop with an equivalent solver
    ``raw(B) -> (bX_unclamped, iters)`` for the SAME operator (the fused
    stencil kernel K1, or its plain version).  The raw solve runs inside
    :func:`~hommx_tpu_torch.ops.solvers.implicit_linear_solve`, whose
    adjoint is the same raw solve: neither the loop nor a kernel launch is
    ever differentiated.  Each raw solve, the adjoint's too, is the span
    ``hommx.micro.solve``.  ``operator = (op, params)`` gives the operator
    as a function of the tensors it is differentiable in, ``op(params, P)
    == matvec(P)``; without it the operator is a constant of the rule and
    only F gets a gradient.  With ``with_iters`` or ``implicit_diff=False``
    (the reference's shard_map micro stage) the raw solve runs without the
    rule and its output carries no gradient.  Returns (bX, iters), the
    iteration count of the forward solve."""
    loop = raw if raw is not None else (
        lambda B: _chunk_pcg_raw(matvec, prec, B, tol, maxiter)
    )

    def raw_solve(B):
        with span("hommx.micro.solve"):
            return loop(B)

    if with_iters or not implicit_diff:
        with torch.no_grad():
            return raw_solve(F)
    op, params = operator if operator is not None else (lambda p, P: matvec(P), ())
    its = []

    def solve(p, B):
        X, k = raw_solve(B)
        its.append(k)
        return X

    bX = implicit_linear_solve(op, tuple(params), F, solve)
    return bX, its[0]


def _clamp(matvec, prec, F, bX):
    """The zero-corrector energy clamp ``where(good, bX, 0)``, with ``good``
    (:func:`_clamp_good`) computed from the detached iterate: a clamped
    column has primal 0 and gradient 0."""
    with torch.no_grad():
        good = _clamp_good(matvec, prec, F, bX)
    return torch.where(good[None], bX, torch.zeros((), dtype=bX.dtype, device=bX.device))


def _clamp_good(matvec, prec, F, bX):
    """Energy-clamp acceptance mask (s, C): E(X) = ½⟨X,KX⟩ − ⟨F,X⟩ must beat
    E(0) = 0, the iterate must be finite, and its amplification over the
    preconditioned-RHS scale must stay below the dtype noise floor."""
    eps = 1e-30
    E = 0.5 * (bX * matvec(bX)).sum(dim=0) - (F * bX).sum(dim=0)
    pF = prec(F)
    x0n = torch.sqrt((pF * pF).sum(dim=0))
    return (
        (E < 0)
        & torch.isfinite(bX).all(dim=0)
        & (torch.sqrt((bX * bX).sum(dim=0)) <= _amp_cap(F.dtype) * (x0n + eps))
    )


def _chunk_pcg_raw(matvec, prec, F, tol, maxiter):
    """Block-CG over a whole chunk: work arrays (n, s, C), per-(rhs, cell)
    step sizes in lockstep; converged columns are frozen by the guards.

    Stops when the worst column's relative residual is <= tol, at maxiter,
    or after 60 iterations in which no column improved its best residual.
    Returns the UNCLAMPED best iterate and the iteration count."""
    dt, dev = F.dtype, F.device
    zero = torch.zeros((), dtype=dt, device=dev)
    one = torch.ones((), dtype=dt, device=dev)
    eps = 1e-30
    X = prec(F)
    R = F - matvec(X)
    Z = prec(R)
    P = Z
    rz = (R * Z).sum(dim=0)  # (s, C)
    fnorm = torch.sqrt((F * F).sum(dim=0)) + eps
    rel = torch.sqrt((R * R).sum(dim=0)) / fnorm
    bX, brel = X, rel
    k, stall = 0, 0
    while k < maxiter and stall < 60:
        # lockstep stop on the worst column; a NaN column stops it too
        if not bool(rel.max() > tol):
            break
        KP = matvec(P)
        pkp = (P * KP).sum(dim=0)
        # breakdown guard (pkp <= 0 or non-finite) and converged-column
        # freeze: the column stops stepping instead of drifting
        ok = (pkp > 0) & torch.isfinite(pkp) & torch.isfinite(rz) & (brel >= tol)
        alpha = torch.where(ok, rz / torch.where(ok, pkp, one), zero)
        X = X + P * alpha[None]
        R = R - KP * alpha[None]
        Z = prec(R)
        rz_new = (R * Z).sum(dim=0)
        beta = torch.where(rz > 0, rz_new / torch.where(rz > 0, rz, one), zero)
        P = Z + P * beta[None]
        rel = torch.sqrt((R * R).sum(dim=0)) / fnorm
        # any measurable improvement resets the stall counter
        improved = (rel < brel * (1.0 - 1e-4)) & torch.isfinite(rel)
        bX = torch.where(improved[None], X, bX)
        brel = torch.where(improved, torch.minimum(rel, brel), brel)
        stall = 0 if bool(improved.any()) else stall + 1
        rz = rz_new
        k += 1
    return bX, k


def _map_chunked(fn, xs: torch.Tensor, chunk: int):
    """Apply the chunk-level ``fn`` over ``xs`` in chunks of ``chunk`` rows
    (bounds peak memory).  The batch is padded with copies of its first row
    to a chunk multiple, as the reference does, so every chunk has one
    shape; outputs (a tensor or a tuple of tensors) are concatenated and
    cut back to len(xs)."""
    n = xs.shape[0]
    chunk = max(1, min(chunk, n))
    n_pad = (-n) % chunk
    if n_pad:
        xs = torch.cat([xs, xs[:1].expand(n_pad, *xs.shape[1:])], dim=0)
    outs = [fn(xs[i : i + chunk]) for i in range(0, n + n_pad, chunk)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts, dim=0)[:n] for parts in zip(*outs))
    return torch.cat(outs, dim=0)[:n]
