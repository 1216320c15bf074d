"""Row-sharded macro solve: the DIA product on every shard with halos, in
the port's CG (torch port of ``hommx_tpu/parallel/macro.py``).

The macro system is split by rows into ``mesh.size`` blocks of
``ceil(N / size)`` rows; the rows past N are identity rows with zero
right-hand side, which decouple and stay exactly zero through CG.  The CG is
``ops/solvers.py::pcg_prec`` itself, on the padded system: its vectors,
dots and stop test stay whole on the right-hand side's device, and only the
product is split, one product per shard whose results are gathered back.
The reference keeps the vectors split and sums the shards' dots (``psum``);
the iterates agree to rounding and the iteration counts are the same.

The DIA product of a shard is one ``DIAOperator`` (ops/dia.py: the kernel
K2 on a CUDA shard, its plain version on the CPU) over ``block + 2·halo``
rows, ``halo`` the largest offset: the shard's values zero-extended by
``halo`` columns on each side, applied to ``[left halo, x_shard, right
halo]`` cut from the vector zero-extended at both ends, of which the middle
``block`` rows are kept.  Every middle row reads only inside the extended
vector, and the halo rows' values are zero, so the shard's rows come out
exact.  At the two ends of the system the halos are zero, where the DIA
values are zero too (``ell_vals_to_dia`` fills only real entries: the
argument that makes the reference's circular halo exact).

Without a DIA view (unstructured meshes) each product copies the whole
vector to every shard's device and applies the shard's rows of the ELL
gather, as the reference's ``all_gather`` does.  A multigrid or AMG
preconditioner (``prec_full``) is applied to the whole residual on the
right-hand side's device, as the reference applies it to the gathered one.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from hommx_tpu_torch.ops.dia import DIAOperator, ell_vals_to_dia
from hommx_tpu_torch.ops.solvers import _ell_diag, cg_matfree, implicit_wrap, pcg_prec
from hommx_tpu_torch.utils.profiling import span

__all__ = [
    "sharded_solve_dia",
    "sharded_solve_ell",
    "can_shard_macro",
    "can_shard_macro_ell",
    "make_sharded_solver",
]


def can_shard_macro(dia, num_devices: int) -> bool:
    """The halo copies need each shard wider than the largest stencil
    offset (one neighbour on each side); tiny macro systems fall back to
    the replicated solve."""
    if dia is None or num_devices <= 1:
        return False
    halo = max(max(abs(o) for o in dia.offsets), 1)
    block = -(-dia.num_dofs // num_devices)
    return block > halo


def can_shard_macro_ell(num_dofs: int, num_devices: int) -> bool:
    """Row sharding of the gather-based ELL product needs only one row per
    device (the product gathers x, no halo-width constraint)."""
    return num_devices > 1 and num_dofs >= num_devices


def _sharded_cg(matvec, diag_p, b_p, N, atol, rtol, maxiter, prec_full):
    """``pcg_prec`` on the padded system, the vectors whole on the
    right-hand side's device and only the product split over the shards:
    Jacobi from the padded diagonal, or ``prec_full`` on the first N rows.
    Returns (x (N,), iterations, residual norm)."""
    if prec_full is None:
        x, k, res = cg_matfree(matvec, diag_p, b_p, None, atol, rtol, maxiter)
    else:
        n_pad = b_p.shape[0] - N
        x, k, res = pcg_prec(matvec, lambda r: F.pad(prec_full(r[:N]), (0, n_pad)), b_p, None,
                             atol, rtol, maxiter)
    return x[:N], k, res


def sharded_solve_dia(mesh, dia, dvals, b, diag, atol, rtol, maxiter, prec_full=None):
    """Preconditioned CG with row-sharded DIA storage: each product is one
    DIA product (K2 on CUDA shards) per shard.

    Args:
        mesh: a ShardMesh.
        dia: DIAPattern (static offsets).
        dvals: (n_offsets, N) DIA values of the BC-applied operator.
        b: (N,) right-hand side; its device holds the CG's vectors and the
            result.
        diag: (N,) matrix diagonal (the Jacobi preconditioner).
        prec_full: optional preconditioner ``z = prec_full(r)`` on the full
            (N,) residual (the multigrid or AMG V-cycle); None → Jacobi
            from ``diag``.
    Returns: (x, iterations, residual norm), x (N,) on b's device.
    """
    nd = mesh.size
    N = dia.num_dofs
    offsets = tuple(dia.offsets)
    halo = max(max(abs(o) for o in offsets), 1)
    block = -(-N // nd)
    n_pad = block * nd - N
    home = b.device

    # identity padding rows, zero rhs
    pad_vals = dvals.new_zeros((dvals.shape[0], n_pad))
    pad_vals[offsets.index(0)] = 1.0
    dvals_p = torch.cat([dvals, pad_vals], dim=1)
    ops = [DIAOperator(F.pad(dvals_p[:, i * block:(i + 1) * block], (halo, halo)).to(dev), offsets)
           for i, dev in enumerate(mesh.devices)]

    def matvec(p):
        # shard i reads [left halo, its rows, right halo] of the vector
        # zero-extended at both ends; on one device the shards' launches
        # run back to back on its stream, with no host read
        pe = F.pad(p, (halo, halo))
        return torch.cat([op(pe[i * block:(i + 1) * block + 2 * halo].to(op.device),
                             out=op.out)[halo:halo + block].to(home)
                          for i, op in enumerate(ops)])

    return _sharded_cg(matvec, F.pad(diag, (0, n_pad), value=1.0), F.pad(b, (0, n_pad)), N,
                       atol, rtol, maxiter, prec_full)


def sharded_solve_ell(mesh, vals, cols, b, diag, atol, rtol, maxiter, prec_full=None):
    """Preconditioned CG with row-sharded ELL storage, for systems without a
    DIA view: each product copies the vector to every shard's device (once
    per distinct device) and sums the shard's rows of the ELL gather.
    Arguments and result as :func:`sharded_solve_dia`, with (vals, cols)
    the ELL operator ((N, K) values, or flat, and column indices)."""
    nd = mesh.size
    N, K = cols.shape
    vals = vals.reshape(N, K)
    block = -(-N // nd)
    n_pad = block * nd - N
    home = b.device

    # identity padding rows with zero rhs (self-referencing columns)
    pad_vals = vals.new_zeros((n_pad, K))
    pad_vals[:, 0] = 1.0
    pad_cols = torch.arange(N, N + n_pad, dtype=cols.dtype, device=cols.device)
    vals_p = torch.cat([vals, pad_vals])
    cols_p = torch.cat([cols, pad_cols[:, None].expand(n_pad, K)])
    shards = [(vals_p[i * block:(i + 1) * block].to(dev), cols_p[i * block:(i + 1) * block].to(dev))
              for i, dev in enumerate(mesh.devices)]

    def matvec(p):
        copies = {}
        out = []
        for v, c in shards:
            if v.device not in copies:
                copies[v.device] = p.to(v.device)
            out.append((v * copies[v.device][c]).sum(dim=1).to(home))
        return torch.cat(out)

    return _sharded_cg(matvec, F.pad(diag, (0, n_pad), value=1.0), F.pad(b, (0, n_pad)), N,
                       atol, rtol, maxiter, prec_full)


def make_sharded_solver(mesh, dia, cols, options, mg=None, amg=None):
    """The differentiable sharded macro solve ``solve(vals_bc, b_bc) -> x``
    from BC-applied ELL values: the DIA conversion, the geometric-multigrid
    V-cycle (with a DIA view and ``mg``) or the AMG V-cycle (``amg``,
    otherwise) for ``pc`` 'auto'/'mg', applied to the gathered residual in
    the system's own dtype, the row-sharded CG, and the implicit-function
    rule (ops/solvers.py::implicit_wrap), whose adjoint is one more sharded
    solve.  ``solve.full(vals_bc, b_bc) -> (x, iterations, residual)`` is
    the diagnostics path, without the rule; ``solve.iterations`` lists the
    iteration count of every solve ``solve`` ran, forward and adjoint.
    Each solve is the span ``hommx.macro.solve``."""
    multigrid = options.pc in ("auto", "mg")
    use_mg = dia is not None and mg is not None and multigrid
    use_amg = not use_mg and amg is not None and multigrid
    stop = (options.atol, options.rtol, options.maxiter)

    def solve_full(vals_bc, b_bc):
        with span("hommx.macro.solve"):
            dvals = None if dia is None else ell_vals_to_dia(dia, vals_bc)
            prec_full = None
            if use_mg:
                from hommx_tpu_torch.ops.multigrid import mg_setup, mg_vcycle

                state = mg_setup(mg, dvals)
                prec_full = lambda r: mg_vcycle(mg, state, r)  # noqa: E731
            elif use_amg:
                from hommx_tpu_torch.ops.amg import amg_setup, amg_vcycle

                state = amg_setup(amg, vals_bc)
                prec_full = lambda r: amg_vcycle(amg, state, r)  # noqa: E731
            diag = _ell_diag(vals_bc, cols)
            if dia is None:
                return sharded_solve_ell(mesh, vals_bc, cols, b_bc, diag, *stop,
                                         prec_full=prec_full)
            return sharded_solve_dia(mesh, dia, dvals, b_bc, diag, *stop, prec_full=prec_full)

    iterations = []

    def solve_x(vals_bc, b_bc):
        x, k, _ = solve_full(vals_bc, b_bc)
        iterations.append(int(k))
        return x

    solve = implicit_wrap(solve_x, cols)
    solve.full = solve_full
    solve.iterations = iterations
    return solve
