"""Global FEM assembly, Dirichlet lifting, load vectors, integrals, the L2
norm, the H1 seminorm and the P1 local stiffness (torch port of
``hommx_tpu/ops/assembly.py``)."""

from __future__ import annotations

import numpy as np
import torch

from hommx_tpu_torch.ops.elements import cell_geometry, quad_points_physical
from hommx_tpu_torch.ops.function_space import eval_at_points
from hommx_tpu_torch.ops.sparse import ELLPattern, spmv

__all__ = [
    "assemble_ell",
    "build_gather_assembly",
    "invert_scatter",
    "GatherPlan",
    "gather_sum",
    "apply_dirichlet",
    "assemble_load_vector",
    "integrate",
    "l2_norm_fn",
    "h1_seminorm_fn",
    "assemble_p1_stiffness_local",
]


def invert_scatter(targets, num_targets: int, max_mult: int = 0, device=None):
    """Inversion of the scatter ``out[targets[i]] += src[i]`` on ``device``
    (the host by default): an int64 (num_targets, m) table whose row t
    lists the source positions that add into t in ascending order, padded
    with ``targets.size`` (the index of a zero appended to the source).
    None when the multiplicity m exceeds ``max_mult`` (0: no limit)."""
    t = torch.as_tensor(np.asarray(targets), device=device).reshape(-1).long()
    counts = torch.bincount(t, minlength=num_targets)
    m = int(counts.max()) if counts.numel() else 0
    if m == 0 or (max_mult and m > max_mult):
        return None
    order = torch.argsort(t, stable=True)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(t.numel(), device=t.device) - starts[t[order]]
    table = torch.full((num_targets, m), t.numel(), dtype=torch.int64, device=t.device)
    table[t[order], pos] = order
    return table


class GatherPlan:
    """An :func:`invert_scatter` table made ready for the device: the
    targets grouped by their number of contributors k, each group a dense
    (n_k, k) table with no padding, and the map back to target order.
    Summing a group is one gather and one reduction over its k
    contributors, so the work follows the contributions, not the largest
    multiplicity (on the beam's 4³ cell: 3.6 contributors a target on
    average, 24 at most)."""

    def __init__(self, table, num_sources: int, device=None):
        table = torch.as_tensor(table, device=device)
        counts = (table != num_sources).sum(dim=1)  # the padding is num_sources
        pos = torch.empty(table.shape[0], dtype=torch.int64, device=table.device)
        self.tables, start = [], 0
        for k in torch.unique(counts[counts > 0]).tolist():
            rows = torch.nonzero(counts == k)[:, 0]
            self.tables.append(table[rows, :k].contiguous())
            pos[rows] = start + torch.arange(rows.numel(), device=table.device)
            start += rows.numel()
        pos[counts == 0] = start  # an appended zero
        self.order = pos
        self.num_targets = table.shape[0]


def gather_sum(src: torch.Tensor, plan: GatherPlan) -> torch.Tensor:
    """The scatter that ``plan`` inverts, as gathers along the last axis of
    ``src`` (..., S) -> (..., T).  Every gather and reduction has a fixed
    order, so each target sums its contributors the same way on every run
    (``index_add_`` on CUDA adds in the order its atomics land)."""
    lead = src.shape[:-1]
    parts = [
        src.index_select(-1, t.reshape(-1)).reshape(*lead, *t.shape).sum(dim=-1)
        for t in plan.tables
    ]
    parts.append(src.new_zeros(*lead, 1))
    return torch.cat(parts, dim=-1).index_select(-1, plan.order)


def assemble_ell(
    pattern: ELLPattern,
    S_loc: torch.Tensor,
    slots: torch.Tensor,
    gather: GatherPlan = None,
) -> torch.Tensor:
    """Assemble per-cell blocks (nc, nb, nb) into the flat ELL value array.

    Default: one scatter-add over ``slots`` (int64, on the device).  With
    ``gather``, a :class:`GatherPlan` of :func:`build_gather_assembly`'s
    table, the same sum runs as fixed-order gathers; the two differ only
    by floating-point reassociation.
    """
    if gather is not None:
        return gather_sum(S_loc.reshape(-1), gather)
    vals = S_loc.new_zeros(pattern.num_dofs * pattern.row_width)
    return vals.index_add_(0, slots.reshape(-1), S_loc.reshape(-1))


def build_gather_assembly(pattern: ELLPattern, max_mult: int = 32, device=None):
    """Inversion of the assembly scatter map (:func:`invert_scatter` on
    ``device``): an int64 (num_slots, m) table of the contributing entries
    of every ELL slot in ``S_loc.reshape(-1)``, padded with ``S_loc.size``
    (an appended zero).  None when the multiplicity m exceeds
    ``max_mult``."""
    return invert_scatter(
        pattern.slots, pattern.num_dofs * pattern.row_width, max_mult, device
    )


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


def assemble_load_vector(vertices, cells, f, bs: int = 1, degree: int = 2, gather=None):
    """b_i = ∫ f · v_i dx with quadrature of the given degree.

    Args:
        vertices: (nv, d) tensor; cells: (nc, d+1) integer tensor.
        f: torch callable x:(d,) -> scalar (bs=1) or (bs,) vector.
        gather: optional :class:`GatherPlan` of the cell dofs
            (``MacroSystem.load_gather``): the sum in a fixed order instead
            of a scatter-add.
    Returns: (num_vertices * bs,) load vector in the vertices' dtype.
    """
    xq, wq, lam = quad_points_physical(vertices, cells, degree)
    fvals = eval_at_points(f, xq).to(wq.dtype)
    cells = cells.long()
    if bs == 1:
        fvals = fvals.reshape(xq.shape[0], xq.shape[1])
        contrib = torch.einsum("cq,qa->ca", wq * fvals, lam)
        if gather is not None:
            return gather_sum(contrib.reshape(-1), gather)
        b = contrib.new_zeros(vertices.shape[0])
        return b.index_add_(0, cells.reshape(-1), contrib.reshape(-1))
    fvals = fvals.reshape(xq.shape[0], xq.shape[1], bs)
    contrib = torch.einsum("cq,cqk,qa->cak", wq, fvals, lam)
    if gather is not None:
        return gather_sum(contrib.reshape(-1), gather)
    b = contrib.new_zeros(vertices.shape[0] * bs)
    dofs = (cells[:, :, None] * bs + torch.arange(bs, device=cells.device)).reshape(-1)
    return b.index_add_(0, dofs, contrib.reshape(-1))


def integrate(vertices, cells, fn, degree: int = 4) -> torch.Tensor:
    """∫ fn(x) dx over the mesh with a quadrature rule of ``degree``;
    ``fn`` is a torch callable x:(d,) -> scalar."""
    xq, wq, _ = quad_points_physical(vertices, cells, degree)
    vals = eval_at_points(fn, xq).to(wq.dtype)
    return (wq * vals.reshape(wq.shape)).sum()


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


def assemble_p1_stiffness_local(vertices, cells, coeff_at_cell: torch.Tensor) -> torch.Tensor:
    """Per-cell P1 stiffness (nc, nb0, nb0) of an elementwise-constant
    matrix coefficient (nc, d, d): S[c, a, b] = |T_c|·∇λ_a · A_c ∇λ_b."""
    grads, vols = cell_geometry(vertices, cells)
    return torch.einsum("c,cad,cde,cbe->cab", vols, grads, coeff_at_cell.to(grads.dtype), grads)
