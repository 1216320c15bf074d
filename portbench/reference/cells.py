"""The periodic P1 cell problems of the HMM, in plain torch: for a macro
point x with element coefficients Ā_e (Σ over the degree-2 points of
A(x, y)) and a corrector-side map T,

    K χ = F,   K = Σ_e B_eᵀ Tᵀ Ā_e T B_e,   F = −Σ_e B_eᵀ Tᵀ Ā_e E,
    A*  = (1/|Y|) Σ_e Φ_eᵀ Ā_e Φ_e,   Φ_e = E + T B_e χ,

on the unit cell Y with N intervals an axis, opposite faces identified, the
dofs of node 0 fixed to remove the constants.  B_e maps an element's nodal
values to its gradient entries (∂_j u, or ∂_j u_i at row i·d + j of a vector
problem) and E holds the unit gradients: A* comes out in the full gradient
layout, (d, d) or (d², d²).  Dense K, LU.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.fem import (
    Precision,
    assemble_dense,
    box_mesh,
    p1_geometry,
    quadrature_points,
    dense_solve,
)

__all__ = ["CellProblem"]


class CellProblem:
    """The static geometry of the unit cell: ``N`` intervals an axis in
    ``dim`` dimensions, ``bs`` unknowns a node (1 or ``dim``)."""

    def __init__(self, N: int, dim: int, bs: int, device):
        verts, cells = box_mesh(np.zeros(dim), np.ones(dim), [N] * dim)
        self.device = torch.device(device)
        self.dim, self.bs = dim, bs
        v = torch.as_tensor(verts, device=self.device)
        c = torch.as_tensor(cells, device=self.device)
        grads, vols = p1_geometry(v, c)
        #: degree-2 points (ne, nq, d) and weights (ne, nq), float64
        self.yq, self.wq = quadrature_points(v, c, vols)
        self.volume = float(vols.sum())
        # periodic node of each vertex: its grid index modulo N
        idx = np.rint(verts * N).astype(np.int64) % N
        node = sum(idx[:, k] * N ** (dim - 1 - k) for k in range(dim))
        nodes = torch.as_tensor(node, device=self.device)[c]  # (ne, d+1)
        comp = torch.arange(bs, device=self.device)
        self.dofs = (nodes[:, :, None] * bs + comp).reshape(nodes.shape[0], -1)
        self.n = N**dim * bs
        ne, nv = grads.shape[0], dim + 1
        r = dim * bs
        B = torch.zeros(ne, r, nv * bs, dtype=torch.float64, device=self.device)
        for a in range(nv):
            for i in range(bs):
                B[:, i * dim:(i + 1) * dim, a * bs + i] = grads[:, a, :]
        self.B = B
        self.E = torch.eye(r, dtype=torch.float64, device=self.device)
        self.free = torch.arange(bs, self.n, device=self.device)  # node 0's dofs fixed

    def tensors(self, Abar: torch.Tensor, T, prec: Precision) -> torch.Tensor:
        """A* (C, r, r) of C macro points: element coefficients ``Abar``
        (C, ne, r, r) and maps ``T`` (C, r, r), or None for the identity."""
        dt = prec.dtype
        Abar = Abar.to(dt)
        B, E = self.B.to(dt), self.E.to(dt)
        if T is None:
            AK = AF = Abar
        else:
            T = T.to(dt)
            AK = prec.einsum("cmr,cemt,ctn->cern", T, Abar, T)
            AF = prec.einsum("cmr,cemt->cert", T, Abar)
        Kloc = prec.einsum("erl,cert,etm->celm", B, AK, B)
        Floc = -prec.einsum("erl,cert,ts->cels", B, AF, E)
        C, ne, m = Kloc.shape[:3]
        K = assemble_dense(Kloc, self.dofs, self.n)
        F = torch.zeros(C, self.n, E.shape[1], dtype=dt, device=self.device)
        F.index_add_(1, self.dofs.reshape(-1), Floc.reshape(C, ne * m, -1))
        f = self.free
        chi = torch.zeros_like(F)
        chi[:, f] = dense_solve(K[:, f][:, :, f], F[:, f])
        del K
        grad = prec.einsum("erl,cels->cers", B, chi[:, self.dofs])
        if T is not None:
            grad = prec.einsum("crt,cets->cers", T, grad)
        Phi = E + grad
        return prec.einsum("cern,cert,cetm->cnm", Phi, Abar, Phi) / self.volume
