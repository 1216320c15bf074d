"""Global FEM assembly, Dirichlet lifting, load vectors, the L2 norm and
the H1 seminorm (torch port of ``hommx_tpu/ops/assembly.py``)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from hommx_tpu_torch.ops.elements import cell_geometry, quad_points_physical
from hommx_tpu_torch.ops.function_space import eval_at_points
from hommx_tpu_torch.ops.sparse import ELLPattern, spmv

__all__ = [
    "assemble_ell",
    "build_gather_assembly",
    "apply_dirichlet",
    "assemble_load_vector",
    "l2_norm_fn",
    "h1_seminorm_fn",
]


def assemble_ell(
    pattern: ELLPattern,
    S_loc: torch.Tensor,
    slots: torch.Tensor,
    gather: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Assemble per-cell blocks (nc, nb, nb) into the flat ELL value array.

    Default: one scatter-add over ``slots`` (int64, on the device).  With
    ``gather`` (from :func:`build_gather_assembly`, on the device) the same
    sum is a gather over a static contributor table and a row reduction;
    the two differ only by floating-point reassociation.
    """
    if gather is not None:
        flat = torch.cat([S_loc.reshape(-1), S_loc.new_zeros(1)])
        return flat[gather].sum(dim=1)
    vals = S_loc.new_zeros(pattern.num_dofs * pattern.row_width)
    return vals.index_add_(0, slots.reshape(-1), S_loc.reshape(-1))


def build_gather_assembly(pattern: ELLPattern, max_mult: int = 32):
    """Host-side inversion of the assembly scatter map: an int64
    (num_slots, m) numpy table of the contributing entries of every ELL
    slot in ``S_loc.reshape(-1)``, padded with ``S_loc.size`` (an appended
    zero).  None when the multiplicity m exceeds ``max_mult``."""
    slots = pattern.slots.reshape(-1).astype(np.int64)
    num_slots = pattern.num_dofs * pattern.row_width
    counts = np.bincount(slots, minlength=num_slots)
    m = int(counts.max()) if counts.size else 0
    if m == 0 or m > max_mult:
        return None
    order = np.argsort(slots, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(slots.size) - starts[slots[order]]
    contrib = np.full((num_slots, m), slots.size, dtype=np.int64)
    contrib[slots[order], pos] = order
    return contrib


def apply_dirichlet(
    vals: torch.Tensor,
    cols: torch.Tensor,
    diag_slots: torch.Tensor,
    b: torch.Tensor,
    bc_mask: torch.Tensor,
    bc_values: torch.Tensor,
    dia=None,
):
    """Symmetric Dirichlet elimination by lifting:

        b <- b - A @ u_bc;  zero bc rows and columns, 1 on the bc diagonal;
        b <- bc values on bc rows.

    With a DIAPattern the column lookup is static shifts (no gather).  The
    lifting matvec is the ELL product on every path: the reference takes
    the DIA product there, whose kernel is float32 only, while this runs
    in the system's dtype (float64 on the direct path).  Returns (vals', b').
    """
    N, K = cols.shape
    zero = torch.zeros((), dtype=bc_values.dtype, device=bc_values.device)
    u_bc = torch.where(bc_mask, bc_values, zero)
    keep_row = (~bc_mask).to(vals.dtype)
    b = b - spmv(vals, cols, u_bc)
    if dia is not None:
        from hommx_tpu_torch.ops.dia import gather_cols

        keep_col = gather_cols(dia, keep_row)
    else:
        keep_col = keep_row[cols]
    v = vals.reshape(N, K) * keep_row[:, None] * keep_col
    # unit diagonal on bc rows; the true diagonal slots come from diag_slots
    # (ELL padding slots alias column 0)
    is_diag = torch.zeros(N * K, dtype=torch.bool, device=vals.device)
    is_diag[diag_slots] = True
    is_diag = is_diag.reshape(N, K)
    v = torch.where(is_diag & bc_mask[:, None], torch.ones_like(v), v)
    b = torch.where(bc_mask, bc_values.to(b.dtype), b)
    return v.reshape(-1), b


def assemble_load_vector(vertices, cells, f, bs: int = 1, degree: int = 2):
    """b_i = ∫ f · v_i dx with quadrature of the given degree.

    Args:
        vertices: (nv, d) tensor; cells: (nc, d+1) integer tensor.
        f: torch callable x:(d,) -> scalar (bs=1) or (bs,) vector.
    Returns: (num_vertices * bs,) load vector in the vertices' dtype.
    """
    xq, wq, lam = quad_points_physical(vertices, cells, degree)
    fvals = eval_at_points(f, xq).to(wq.dtype)
    cells = cells.long()
    if bs == 1:
        fvals = fvals.reshape(xq.shape[0], xq.shape[1])
        contrib = torch.einsum("cq,qa->ca", wq * fvals, lam)
        b = contrib.new_zeros(vertices.shape[0])
        return b.index_add_(0, cells.reshape(-1), contrib.reshape(-1))
    fvals = fvals.reshape(xq.shape[0], xq.shape[1], bs)
    contrib = torch.einsum("cq,cqk,qa->cak", wq, fvals, lam)
    b = contrib.new_zeros(vertices.shape[0] * bs)
    dofs = (cells[:, :, None] * bs + torch.arange(bs, device=cells.device)).reshape(-1)
    return b.index_add_(0, dofs, contrib.reshape(-1))


def l2_norm_fn(vertices, cells, u_nodes, bs: int = 1, exact=None, degree: int = 4):
    """L² norm of (u_h - exact) for a P1 function; ``exact`` may be None."""
    xq, wq, lam = quad_points_physical(vertices, cells, degree)
    uv = u_nodes.reshape(-1, bs)[cells.long()]  # (nc, nb0, bs)
    uq = torch.einsum("qa,cab->cqb", lam.to(uv.dtype), uv)
    if exact is not None:
        uq = uq - eval_at_points(exact, xq).reshape(uq.shape).to(uq.dtype)
    return torch.sqrt((wq.to(uq.dtype) * (uq * uq).sum(dim=-1)).sum())


def h1_seminorm_fn(vertices, cells, u_nodes, bs: int = 1, exact_grad=None, degree: int = 4):
    """H¹ seminorm |u_h|₁ of a P1 function, or |u_h − exact|₁ given a torch
    callable ``exact_grad(x) -> (d,)`` / ``(bs, d)``.  P1 gradients are
    elementwise constant."""
    cells = cells.long()
    grads, vols = cell_geometry(vertices, cells)  # (nc, nb0, d), (nc,)
    uv = u_nodes.reshape(-1, bs)[cells].to(grads.dtype)  # (nc, nb0, bs)
    gu = torch.einsum("cab,cad->cbd", uv, grads)  # (nc, bs, d)
    if exact_grad is None:
        return torch.sqrt((vols * (gu * gu).sum(dim=(1, 2))).sum())
    xq, wq, _ = quad_points_physical(vertices, cells, degree)
    ge = eval_at_points(exact_grad, xq).to(gu.dtype)
    ge = ge.reshape(xq.shape[0], xq.shape[1], bs, vertices.shape[1])
    diff = gu[:, None] - ge
    return torch.sqrt((wq * (diff * diff).sum(dim=(2, 3))).sum())
