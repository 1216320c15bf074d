"""Macro linear solvers: preconditioned CG and the dense direct solve
(torch port of ``hommx_tpu/ops/solvers.py``).

The CG loop is Python, and its stop test lives on the device: a 0-d
``active`` flag gates each step, so an iterate that has converged freezes,
and the host reads the flag once every ``_CHECK_EVERY`` loop steps
(``STOP_TEST.readbacks`` counts those reads).  Iterates and counts are
those of a per-iteration test; the steps after the stop and before the
next read are frozen (``STOP_TEST.steps``).  On a structured mesh the CG matvec is the
DIA SpMV, one ``DIAOperator`` (ops/dia.py) per solve: the hand-written CUDA
kernel for a CUDA system (float32 and float64 instances) and the plain
version on the CPU.  With a multigrid hierarchy (``mg``) and ``pc``
'auto'/'mg', CG is preconditioned by the geometric-multigrid V-cycle
(ops/multigrid.py) in the system's own dtype; without one, by the
aggregation-AMG V-cycle (``amg``, ops/amg.py), whose outer matvec is the
DIA product where the system has a DIA view and the ELL gather
otherwise; with neither (a system at or below the AMG bottom size), and
for ``pc='jacobi'``, by the diagonal.

Differentiation: :func:`implicit_linear_solve` is the port's counterpart of
``lax.custom_linear_solve`` — a solve whose backward pass is the adjoint
solve by the same solver (the implicit-function rule), written in
differentiable operations so that it has second derivatives too.  The
micro routes (micro/krylov.py, micro/chunk.py) and the macro solve
(:func:`make_implicit_solver`) are its uses.
"""

from __future__ import annotations

import torch

from hommx_tpu_torch.ops.sparse import ell_to_dense, spmv
from hommx_tpu_torch.utils.profiling import span

__all__ = [
    "implicit_linear_solve",
    "make_implicit_solver",
    "implicit_wrap",
    "cg_ell",
    "cg_matfree",
    "pcg_prec",
    "dense_solve_ell",
    "solve_ell",
    "STOP_TEST",
]

#: loop steps between two host reads of the CG's stop flag.  A read makes
#: the host wait for the device; a frozen step (after the stop, before the
#: read) costs a whole step of enqueue.  The H100 runs both loops
#: host-bound (PERF.md, section 6): a multigrid step is 5-12 ms of enqueue,
#: so 16 wasted up to 15 V-cycles; the Jacobi loop did not move between 1,
#: 4 and 16.  4 wastes at most 3 steps and reads a quarter as often as 1
_CHECK_EVERY = 4


class _StopTest:
    """Counts of :func:`pcg_prec`'s loop, kept the way a kernel counts its
    launches (a run sets them to 0 and reads them back): ``readbacks``, the
    host reads of the stop flag; ``steps``, the loop bodies enqueued, which
    exceed the iterations by the frozen steps run between the last active
    iteration and the check that sees the stop (fewer than
    ``_CHECK_EVERY``).  Each step makes one product and one
    preconditioner application."""

    def __init__(self):
        self.readbacks = 0
        self.steps = 0


STOP_TEST = _StopTest()


def _ell_diag(vals: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    N, K = cols.shape
    rows = torch.arange(N, device=cols.device)[:, None]
    isdiag = (cols == rows).to(vals.dtype)
    return (vals.reshape(N, K) * isdiag).sum(dim=1)


def pcg_prec(matvec, prec, b, x0=None, atol=1e-12, rtol=1e-12, maxiter=10000):
    """Matrix-free PCG with an SPD preconditioner callable ``prec(r) -> z``.

    Stops when ‖r‖ <= max(atol, rtol·‖b‖) or after ``maxiter`` iterations,
    tested on the device before every iteration: a step runs only while
    ``active`` holds (α = β = 0 otherwise, so the iterate freezes) and the
    count adds ``active``.  The host reads the flag and the count once every
    ``_CHECK_EVERY`` steps, so up to ``_CHECK_EVERY`` − 1 frozen steps run
    after the last iteration (``STOP_TEST.steps``).  Returns (x,
    iterations, final residual norm as a 0-d tensor)."""
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    z = prec(r)
    p = z
    rz = torch.dot(r, z)
    tol = torch.clamp(rtol * torch.linalg.vector_norm(b), min=atol)
    k = torch.zeros((), dtype=torch.int64, device=b.device)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    active = (torch.linalg.vector_norm(r) > tol) & (k < maxiter)
    n = 0  # steps enqueued
    while True:
        if n % _CHECK_EVERY == 0 or n >= maxiter:
            STOP_TEST.readbacks += 1
            live, k_host = torch.stack((active.long(), k)).tolist()
            if not live:
                break
        Ap = matvec(p)
        # a frozen step divides by where(active, ·, 1): no 0/0 once r = 0
        alpha = torch.where(active, rz / torch.where(active, torch.dot(p, Ap), one), zero)
        x = x + alpha * p
        r = r - alpha * Ap
        z = prec(r)
        rz_new = torch.dot(r, z)
        beta = torch.where(active, rz_new / torch.where(active, rz, one), zero)
        p = z + beta * p
        rz = torch.where(active, rz_new, rz)
        k = k + active.long()
        n += 1
        STOP_TEST.steps += 1
        active = (torch.linalg.vector_norm(r) > tol) & (k < maxiter)
    return x, k_host, torch.linalg.vector_norm(r)


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


def solve_ell(vals, cols, b, options, dia=None, mg=None, amg=None):
    """Dispatch on SolverOptions: 'direct', 'cg', or 'auto' (direct up to
    ``direct_threshold`` unknowns).  With ``pc`` 'auto'/'mg' the CG is
    preconditioned by the geometric-multigrid V-cycle of an MGStructure
    (``mg``), else by the aggregation-AMG V-cycle of an AMGStructure
    (``amg``), else (and for ``pc='jacobi'``) by the diagonal.  With a
    DIAPattern (``dia``) the CG matvec is the DIA SpMV on every route.
    The solve, its stop-test reads included, is the span
    ``hommx.macro.solve``.  Returns (x, iterations, residual)."""
    with span("hommx.macro.solve"):
        method = options.method
        if method == "auto":
            method = "direct" if b.shape[0] <= options.direct_threshold else "cg"
        if method == "direct":
            x = dense_solve_ell(vals, cols, b)
            return x, 0, torch.zeros((), dtype=b.dtype, device=b.device)
        stop = dict(atol=options.atol, rtol=options.rtol, maxiter=options.maxiter)
        use_mg = options.pc in ("auto", "mg")
        if use_mg and mg is None and amg is not None:
            from hommx_tpu_torch.ops.amg import amg_setup, amg_vcycle

            matvec = _dia_matvec(dia, vals)[0] if dia is not None else (
                lambda v: spmv(vals, cols, v))
            state = amg_setup(amg, vals)
            return pcg_prec(matvec, lambda r: amg_vcycle(amg, state, r), b, **stop)
        if dia is None:
            return cg_ell(vals, cols, b, **stop)
        matvec, dvals = _dia_matvec(dia, vals)
        if use_mg and mg is not None:
            from hommx_tpu_torch.ops.multigrid import mg_setup, mg_vcycle

            state = mg_setup(mg, dvals)
            return pcg_prec(matvec, lambda r: mg_vcycle(mg, state, r), b, **stop)
        return cg_matfree(matvec, _ell_diag(vals, cols), b, **stop)


def _dia_matvec(dia, vals):
    """(matvec, DIA values): the CG's DIA product over ``dia``'s offsets,
    one ``DIAOperator`` (K2 on the card, its plain version on the CPU) with
    one output buffer for every product (``pcg_prec`` keeps no A·p across
    iterations, and on the card the stream orders each overwrite after the
    reads of the one before)."""
    from hommx_tpu_torch.ops import dia as dia_ops

    dvals = dia_ops.ell_vals_to_dia(dia, vals)
    op = dia_ops.DIAOperator(dvals, dia.offsets)
    return (lambda v: op(v, out=op.out)), dvals


class _ImplicitSolve(torch.autograd.Function):
    """X = A(params)⁻¹ F for a symmetric A, with the implicit-function VJP.

    The forward runs ``raw`` with grad mode off: the solver's own loop (or
    a kernel launch, whose output has no history) is never recorded.  The
    backward solves A λ = X̄ by a call of this same Function, so λ carries
    its own rule, and returns F̄ = λ and params̄ = the VJP of
    ``matvec(params, X)`` with cotangent −λ.  X is the saved output, so a
    second backward differentiates through it as well."""

    @staticmethod
    def forward(ctx, matvec, raw, F, *params):
        with torch.no_grad():
            X = raw(params, F)
        ctx.matvec, ctx.raw = matvec, raw
        ctx.save_for_backward(X, *params)
        return X

    @staticmethod
    def backward(ctx, Xbar):
        X, *params = ctx.saved_tensors
        lam = _ImplicitSolve.apply(ctx.matvec, ctx.raw, Xbar, *params)
        if not any(ctx.needs_input_grad[3:]):
            return (None, None, lam, *(None for _ in params))
        # torch.func.vjp differentiates in params alone: X's own history
        # (this Function) is not walked, yet with grad mode on (a backward
        # that creates a graph) the result stays a function of X and λ
        _, vjp = torch.func.vjp(lambda *p: ctx.matvec(p, X), *params)
        pbar = vjp(-lam)
        return (None, None, lam, *pbar)


def implicit_linear_solve(matvec, params, F, raw):
    """Solve A X = F for the symmetric operator ``matvec(params, X) = A X``
    with ``raw(params, F) -> X`` (a Krylov loop, a direct solve or a kernel
    launch), differentiable in F and in the tensors ``params`` by the
    implicit-function rule: the adjoint is one more ``raw`` solve with the
    same operator, and the operator's cotangent is the VJP of ``matvec``
    with cotangent −λ (for an ELL matrix, −λ_i x_j at slot (i, j)).  The
    rule is exact at convergence; it never unrolls ``raw``.  The forward
    value is ``raw``'s output, bit for bit.  Tensors that ``matvec``
    closes over, rather than takes in ``params``, are constants of the
    rule."""
    return _ImplicitSolve.apply(matvec, raw, F, *params)


def make_implicit_solver(cols, options, dia=None, mg=None, amg=None):
    """The differentiable macro solve ``solve(vals, b) -> x``: :func:`solve_ell`
    with the static assembly context (cols, options, DIA pattern, multigrid
    or AMG structure) closed over, under the implicit-function rule.  The
    adjoint is one more solve with the same options, pattern,
    preconditioner and kernels.  ``solve.iterations`` lists the iteration count of every solve
    it ran, forward and adjoint, in order."""
    iterations = []

    def solve_fn(vals, b):
        x, k, _ = solve_ell(vals, cols, b, options, dia=dia, mg=mg, amg=amg)
        iterations.append(int(k))
        return x

    solve = implicit_wrap(solve_fn, cols)
    solve.iterations = iterations
    return solve


def implicit_wrap(solve_fn, cols):
    """Attach the implicit-function rule to a symmetric ELL solve
    ``solve_fn(vals, b) -> x``: ∂L/∂b = λ with A λ = ∂L/∂x (one more
    ``solve_fn`` call) and ∂L/∂vals = −λ_i x_j at the slot of entry
    (i, j)."""

    def solve(vals, b):
        return implicit_linear_solve(
            lambda p, x: spmv(p[0], cols, x), (vals,), b, lambda p, B: solve_fn(p[0], B)
        )

    return solve
