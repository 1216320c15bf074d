"""Plain finite-element pieces of the reference: structured simplex meshes,
P1 geometry, the degree-2 quadrature, dense assembly, and the two
precisions a reference computation runs in.

Nothing here imports the program under test: every array is built from the
configuration's numbers.

Precisions:

- ``float64``: the reference.
- ``tf32``: the control, the reference one precision below the configured
  float32 (whose matrix products run with TF32 off).  Every array is
  float32, and each operand of a contraction is first rounded to TF32's 10
  mantissa bits, nearest, ties to even, then the contraction accumulates in
  float32: what a TF32 tensor-core product computes, without relying on
  which cuBLAS kernel a shape selects.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

__all__ = ["Precision", "box_mesh", "p1_geometry", "quadrature_points", "tf32_round",
           "assemble_dense", "dense_solve"]

# degree-2 rules in barycentric coordinates, weights summing to 1: the
# triangle's three edge midpoints; the tetrahedron's symmetric four points
_A_TET = (5.0 - 5.0**0.5) / 20.0
_B_TET = (5.0 + 3.0 * 5.0**0.5) / 20.0
_RULES = {
    2: (np.array([[0.5, 0.5, 0.0], [0.0, 0.5, 0.5], [0.5, 0.0, 0.5]]), np.full(3, 1.0 / 3.0)),
    3: (np.array([[_B_TET if i == j else _A_TET for j in range(4)] for i in range(4)]),
        np.full(4, 0.25)),
}


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32 rounded to TF32 (10 explicit mantissa bits),
    nearest with ties to even."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & -0x2000
    return bits.view(torch.float32)


class Precision:
    """The arithmetic of one reference computation: ``float64`` or ``tf32``."""

    def __init__(self, name: str):
        if name not in ("float64", "tf32"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self.dtype = torch.float64 if name == "float64" else torch.float32

    def einsum(self, eq: str, *ops: torch.Tensor) -> torch.Tensor:
        if self.name == "tf32":
            return torch.einsum(eq, *[tf32_round(o) for o in ops])
        return torch.einsum(eq, *[o.to(torch.float64) for o in ops])


def box_mesh(lo, hi, n):
    """(vertices (nv, d) float64, cells (nc, d+1) int64) of the structured
    simplex mesh of the box [lo, hi] with n[k] intervals on axis k.

    Vertices are numbered lexicographically, the last axis fastest.  In 2D
    each square is split along its diagonal from the lower-left to the
    upper-right corner into (v00, v10, v11) and (v00, v11, v01); in 3D each
    cube into Kuhn's six tetrahedra, the chains of unit steps from its lower
    corner along the axis permutations in lexicographic order.  Cells are
    numbered square by square (cube by cube) in the vertices' order."""
    lo, hi = np.asarray(lo, dtype=np.float64), np.asarray(hi, dtype=np.float64)
    n = [int(k) for k in n]
    d = len(n)
    axes = [np.linspace(lo[k], hi[k], n[k] + 1) for k in range(d)]
    grid = np.meshgrid(*axes, indexing="ij")
    verts = np.stack([g.ravel() for g in grid], axis=1)
    strides = [int(np.prod([m + 1 for m in n[k + 1:]])) for k in range(d)]
    base = np.stack([g.ravel() for g in np.meshgrid(*[np.arange(m) for m in n],
                                                    indexing="ij")], axis=1)

    def vid(corner):
        return sum(corner[:, k] * strides[k] for k in range(d))

    if d == 2:
        v = {(i, j): vid(base + np.array([i, j])) for i in (0, 1) for j in (0, 1)}
        cells = np.stack([np.stack([v[0, 0], v[1, 0], v[1, 1]], 1),
                          np.stack([v[0, 0], v[1, 1], v[0, 1]], 1)], axis=1)
    elif d == 3:
        tets = []
        for perm in itertools.permutations(range(3)):
            corner = base.copy()
            chain = [vid(corner)]
            for axis in perm:
                corner = corner.copy()
                corner[:, axis] += 1
                chain.append(vid(corner))
            tets.append(np.stack(chain, 1))
        cells = np.stack(tets, axis=1)
    else:
        raise ValueError("2D or 3D boxes only")
    return verts, cells.reshape(-1, d + 1).astype(np.int64)


def p1_geometry(verts: torch.Tensor, cells: torch.Tensor):
    """(gradients (nc, d+1, d), volumes (nc,)) of the P1 basis, float64."""
    p = verts[cells]
    J = (p[:, 1:, :] - p[:, :1, :]).transpose(1, 2)  # columns: edge vectors
    Jinv = torch.linalg.inv(J)  # row i: the gradient of barycentric i+1
    d = verts.shape[1]
    vols = torch.linalg.det(J).abs() / float(np.prod(np.arange(1, d + 1)))
    return torch.cat([-Jinv.sum(dim=1, keepdim=True), Jinv], dim=1), vols


def quadrature_points(verts: torch.Tensor, cells: torch.Tensor, vols: torch.Tensor):
    """(points (nc, nq, d), weights (nc, nq)) of the degree-2 rule, the
    weights summing to each cell's volume, float64."""
    d = verts.shape[1]
    lam, w = _RULES[d]
    lam = torch.as_tensor(lam, dtype=torch.float64, device=verts.device)
    w = torch.as_tensor(w, dtype=torch.float64, device=verts.device)
    return torch.einsum("qa,cad->cqd", lam, verts[cells]), vols[:, None] * w[None, :]


def assemble_dense(local: torch.Tensor, dofs: torch.Tensor, n: int) -> torch.Tensor:
    """Sum element matrices ``local`` (B, ne, m, m) on the dofs ``dofs``
    (ne, m) into dense (B, n, n) matrices."""
    B = local.shape[0]
    flat = (dofs[:, :, None] * n + dofs[:, None, :]).reshape(-1)
    idx = (torch.arange(B, device=local.device)[:, None] * (n * n) + flat[None, :]).reshape(-1)
    out = torch.zeros(B * n * n, dtype=local.dtype, device=local.device)
    out.index_put_((idx,), local.reshape(-1), accumulate=True)
    return out.reshape(B, n, n)


def dense_solve(K: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
    """X with K X = F for dense K (B, n, n), F (B, n, k): LU with partial
    pivoting after symmetric diagonal equilibration, so that it also
    returns a number where rounding has left K indefinite; NaN where a
    factor is singular.  One matrix at a time (a batched LU of MKL stalls
    on the CPU)."""
    s = torch.rsqrt(torch.diagonal(K, dim1=-2, dim2=-1).abs())
    X = torch.empty_like(F)
    for b in range(K.shape[0]):
        Ks = s[b, :, None] * K[b] * s[b, None, :]
        LU, piv, info = torch.linalg.lu_factor_ex(Ks)
        X[b] = s[b, :, None] * torch.linalg.lu_solve(LU, piv, s[b, :, None] * F[b])
        if int(info) != 0:
            X[b] = float("nan")
    return X
