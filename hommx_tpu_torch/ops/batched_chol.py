"""Blocked batched Cholesky for the elasticity cell-problem batch (torch
port of ``hommx_tpu/ops/batched_chol.py``: ``_pad_spd``,
``blocked_cholesky``, ``blocked_cho_solve`` and ``blocked_solve_spd``).

The right-looking factorization runs panel by panel (width ``nb``): an
unblocked Cholesky of the diagonal block with clamped pivots
√max(p, eps), its inverse by row-wise forward substitution, then the panel
solve and the trailing Schur update as batched matmuls.  Clamped pivots
mean a non-SPD block gives large-but-finite factors instead of raising, as
``torch.linalg.cholesky`` would.

These are the body of K3's plain version (``ops/chol_kernel.py::
fused_chol_solve_plain``); the CUDA kernel runs the same blocked algorithm
(nb = 32) on its own tiles.  The
reference's ``scan_*`` variants (one large matrix as a fixed-shape scan)
are not on the port's path (ROADMAP A7).
"""

from __future__ import annotations

import torch

__all__ = ["_pad_spd", "blocked_cholesky", "blocked_cho_solve", "blocked_solve_spd"]


def _pad_spd(K, B, nb):
    """Pad K (C, n, n) and B (C, n, s) to a multiple of ``nb`` with
    decoupled identity rows and zero right-hand sides, which keeps the
    system SPD and its leading solution unchanged.  Returns (Kp, Bp, n)."""
    C, n, _ = K.shape
    n_pad = (-n) % nb
    if n_pad == 0:
        return K, B, n
    Kp = K.new_zeros((C, n + n_pad, n + n_pad))
    Kp[:, :n, :n] = K
    Kp[:, n:, n:] = torch.eye(n_pad, dtype=K.dtype, device=K.device)
    Bp = B.new_zeros((C, n + n_pad, B.shape[2]))
    Bp[:, :n] = B
    return Kp, Bp, n


def blocked_cholesky(K, nb: int = 32, eps: float = 1e-30):
    """Batched lower Cholesky of K (C, n, n), ``n % nb == 0``.

    Returns ``(panels, dinvs)``: per panel p the (C, n − p·nb, nb) column
    block of L, and the inverted (C, nb, nb) diagonal block Lpp⁻¹.  The
    diagonal of L is p/√max(p, eps) (√p for a positive pivot)."""
    C, n, _ = K.shape
    if n % nb:
        raise ValueError("pad the system first (_pad_spd)")
    Kw = K.clone()
    eye = torch.eye(nb, dtype=K.dtype, device=K.device)
    panels, dinvs = [], []
    for p in range(n // nb):
        a, b = p * nb, (p + 1) * nb
        A = Kw[:, a:b, a:b]
        cols = []
        for j in range(nb):
            piv = torch.sqrt(torch.clamp(A[:, j, j], min=eps))
            col = A[:, :, j] / piv[:, None]
            col[:, :j] = 0.0
            cols.append(col)
            A = A - col[:, :, None] * col[:, None, :]
        Lpp = torch.stack(cols, dim=-1)  # (C, nb, nb) lower
        # row i of Lpp⁻¹ = (e_i − Σ_{k<i} Lpp[i, k]·row k) / Lpp[i, i]
        Dinv = Lpp.new_zeros((C, nb, nb))
        for i in range(nb):
            r = eye[i].expand(C, nb)
            if i:
                r = r - torch.bmm(Lpp[:, i : i + 1, :i], Dinv[:, :i, :])[:, 0]
            Dinv[:, i] = r / Lpp[:, i, i, None]
        dinvs.append(Dinv)
        if b < n:
            Lp_off = Kw[:, b:, a:b] @ Dinv.transpose(1, 2)
            Kw[:, b:, b:] -= Lp_off @ Lp_off.transpose(1, 2)
            panels.append(torch.cat([Lpp, Lp_off], dim=1))
        else:
            panels.append(Lpp)
    return panels, dinvs


def blocked_cho_solve(panels, dinvs, B, nb: int = 32):
    """Solve L Lᵀ X = B for B (C, n, s) from :func:`blocked_cholesky`: both
    substitution phases as block recursions of batched matmuls."""
    npan = B.shape[1] // nb
    ys = []
    for p in range(npan):
        rhs = B[:, p * nb : (p + 1) * nb]
        for q in range(p):
            off = (p - q) * nb
            rhs = rhs - panels[q][:, off : off + nb] @ ys[q]
        ys.append(dinvs[p] @ rhs)
    xs = [None] * npan
    for p in reversed(range(npan)):
        rhs = ys[p]
        for q in range(p + 1, npan):
            off = (q - p) * nb
            rhs = rhs - panels[p][:, off : off + nb].transpose(1, 2) @ xs[q]
        xs[p] = dinvs[p].transpose(1, 2) @ rhs
    return torch.cat(xs, dim=1)


def blocked_solve_spd(K, B, nb: int = 32):
    """Batched SPD solve K X = B (K (C, n, n), B (C, n, s)) through the
    blocked factorization; pads to a block multiple internally."""
    Kp, Bp, n = _pad_spd(K, B, nb)
    panels, dinvs = blocked_cholesky(Kp, nb)
    return blocked_cho_solve(panels, dinvs, Bp, nb)[:, :n]
