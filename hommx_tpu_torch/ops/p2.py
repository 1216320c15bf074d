"""P2 (quadratic) Lagrange simplex elements (torch port of
``hommx_tpu/ops/p2.py``).

Used by the single-scale FEM (``degree=2``) and by P2 micro cell problems
(``MicroEngine(micro_degree=2)``); the HMM macro space stays P1.

Dof layout: vertex dofs [0, nv) then edge-midpoint dofs [nv, nv+nedges).
Basis on the reference simplex in barycentric coordinates λ_0..λ_d:

    vertex i : λ_i (2λ_i − 1)
    edge (i,j): 4 λ_i λ_j

Gradients: ∇φ_i = (4λ_i − 1)∇λ_i, ∇φ_(ij) = 4(λ_i ∇λ_j + λ_j ∇λ_i), with
∇λ the constant P1 gradients of the cell.  The tables are host numpy;
``p2_basis`` is torch.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["EDGE_PAIRS", "build_edges", "p2_basis", "p2_cell_dofs", "p2_dof_coordinates"]

# canonical edge order (local vertex index pairs) per dimension
EDGE_PAIRS = {
    1: [(0, 1)],
    2: [(0, 1), (0, 2), (1, 2)],
    3: [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)],
}


def build_edges(cells: np.ndarray, num_vertices: int):
    """Unique-edge table.

    Returns:
        edges: (num_edges, 2) sorted vertex pairs.
        cell_edges: (num_cells, n_local_edges) edge index per local edge.
    """
    dim = cells.shape[1] - 1
    pairs = EDGE_PAIRS[dim]
    local = np.sort(np.stack([cells[:, [i, j]] for (i, j) in pairs], axis=1), axis=2)
    flat = local.reshape(-1, 2)
    keys = flat[:, 0].astype(np.int64) * num_vertices + flat[:, 1]
    uniq, inverse = np.unique(keys, return_inverse=True)
    edges = np.stack([uniq // num_vertices, uniq % num_vertices], axis=1)
    cell_edges = inverse.reshape(local.shape[0], len(pairs))
    return edges.astype(np.int32), cell_edges.astype(np.int32)


def p2_cell_dofs(cells: np.ndarray, cell_edges: np.ndarray, num_vertices: int):
    """(num_cells, nb) P2 dofmap: vertex dofs then edge dofs."""
    return np.concatenate([cells, cell_edges + num_vertices], axis=1)


def p2_dof_coordinates(vertices: np.ndarray, edges: np.ndarray):
    """(nv + nedges, dim) node coordinates (vertices + edge midpoints)."""
    mids = 0.5 * (vertices[edges[:, 0]] + vertices[edges[:, 1]])
    return np.concatenate([vertices, mids], axis=0)


def p2_basis(xi, dim: int):
    """P2 basis values and barycentric-gradient coefficients at local points.

    Args:
        xi: (nq, dim) local coordinates (a tensor or an array; an array
            becomes a float64 tensor).
    Returns:
        phi: (nq, nb) basis values.
        dphi_dlam: (nq, nb, dim+1) coefficients c such that
            ∇φ_k(x_q) = Σ_i c[q, k, i] · ∇λ_i  (∇λ constant per cell).
    """
    xi = torch.as_tensor(xi)
    if not xi.is_floating_point():
        xi = xi.to(torch.float64)
    nq = xi.shape[0]
    lam = torch.cat([1.0 - xi.sum(dim=1, keepdim=True), xi], dim=1)  # (nq, d+1)
    pairs = EDGE_PAIRS[dim]
    nb0 = dim + 1
    phi_v = lam * (2.0 * lam - 1.0)
    phi_e = torch.stack([4.0 * lam[:, i] * lam[:, j] for (i, j) in pairs], dim=1)
    phi = torch.cat([phi_v, phi_e], dim=1)

    c_v = lam.new_zeros((nq, nb0, nb0))
    for i in range(nb0):
        c_v[:, i, i] = 4.0 * lam[:, i] - 1.0
    c_e = lam.new_zeros((nq, len(pairs), nb0))
    for k, (i, j) in enumerate(pairs):
        c_e[:, k, j] = 4.0 * lam[:, i]
        c_e[:, k, i] = 4.0 * lam[:, j]
    return phi, torch.cat([c_v, c_e], dim=1)
