"""P1 simplex element geometry and physical quadrature points (torch port of
``hommx_tpu/ops/elements.py``).

Conventions: a cell has vertices p_0..p_d; the affine map is
x = p_0 + J xi with J[:, i] = p_{i+1} - p_0.  P1 basis: lambda_0 = 1-sum(xi),
lambda_i = xi_i.  Gradients: grad lambda_i = row i-1 of J^{-1} (i >= 1),
grad lambda_0 = -sum of the others.
"""

from __future__ import annotations

import torch

from hommx_tpu_torch.ops.quadrature import simplex_rule

__all__ = ["cell_geometry", "quad_points_physical", "p1_basis_at"]


def _inv_and_det(J):
    """Explicit inverse and determinant for (..., d, d), d in {1, 2, 3}."""
    d = J.shape[-1]
    if d == 1:
        det = J[..., 0, 0]
        return (1.0 / det)[..., None, None], det
    if d == 2:
        a, b = J[..., 0, 0], J[..., 0, 1]
        c, e = J[..., 1, 0], J[..., 1, 1]
        det = a * e - b * c
        inv = torch.stack(
            [torch.stack([e, -b], dim=-1), torch.stack([-c, a], dim=-1)], dim=-2
        ) / det[..., None, None]
        return inv, det
    m = J
    c00 = m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1]
    c01 = m[..., 0, 2] * m[..., 2, 1] - m[..., 0, 1] * m[..., 2, 2]
    c02 = m[..., 0, 1] * m[..., 1, 2] - m[..., 0, 2] * m[..., 1, 1]
    c10 = m[..., 1, 2] * m[..., 2, 0] - m[..., 1, 0] * m[..., 2, 2]
    c11 = m[..., 0, 0] * m[..., 2, 2] - m[..., 0, 2] * m[..., 2, 0]
    c12 = m[..., 0, 2] * m[..., 1, 0] - m[..., 0, 0] * m[..., 1, 2]
    c20 = m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]
    c21 = m[..., 0, 1] * m[..., 2, 0] - m[..., 0, 0] * m[..., 2, 1]
    c22 = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
    det = m[..., 0, 0] * c00 + m[..., 0, 1] * c10 + m[..., 0, 2] * c20
    adj = torch.stack(
        [
            torch.stack([c00, c01, c02], dim=-1),
            torch.stack([c10, c11, c12], dim=-1),
            torch.stack([c20, c21, c22], dim=-1),
        ],
        dim=-2,
    )
    return adj / det[..., None, None], det


def cell_geometry(vertices: torch.Tensor, cells: torch.Tensor):
    """Per-cell P1 geometry.

    Args:
        vertices: (nv, d) tensor.
        cells: (nc, d+1) integer tensor on the same device.

    Returns:
        grads: (nc, d+1, d) gradient of each P1 basis function per cell.
        vols: (nc,) cell measures |T|.
    """
    d = vertices.shape[1]
    p = vertices[cells.long()]  # (nc, d+1, d)
    E = p[:, 1:, :] - p[:, :1, :]  # row i = p_{i+1} - p_0
    J = E.transpose(-1, -2)  # columns are edge vectors
    Jinv, det = _inv_and_det(J)
    fact = {1: 1.0, 2: 2.0, 3: 6.0}[d]
    vols = det.abs() / fact
    g0 = -Jinv.sum(dim=-2, keepdim=True)
    return torch.cat([g0, Jinv], dim=-2), vols


def quad_points_physical(vertices: torch.Tensor, cells: torch.Tensor, degree: int):
    """Physical quadrature points and weights for every cell.

    Returns:
        xq: (nc, nq, d) physical points.
        wq: (nc, nq) weights with sum_q wq[c, q] = |T_c|.
        lam: (nq, d+1) P1 basis values at the local quadrature points.
    """
    d = vertices.shape[1]
    xi, w = simplex_rule(d, degree)
    xi = torch.as_tensor(xi, dtype=vertices.dtype, device=vertices.device)
    w = torch.as_tensor(w, dtype=vertices.dtype, device=vertices.device)
    lam = p1_basis_at(xi)
    p = vertices[cells.long()]
    xq = torch.einsum("qa,cad->cqd", lam, p)
    _, vols = cell_geometry(vertices, cells)
    return xq, vols[:, None] * w[None, :], lam


def p1_basis_at(xi: torch.Tensor) -> torch.Tensor:
    """P1 basis values at local points xi (nq, d) -> (nq, d+1)."""
    lam0 = 1.0 - xi.sum(dim=-1, keepdim=True)
    return torch.cat([lam0, xi], dim=-1)
