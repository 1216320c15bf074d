"""The macro problem of the HMM in plain torch: P1 elements (scalar, or a
vector of ``bs`` components) on a structured box,

    Σ_T |T| ∇v : A*_T ∇u = Σ_T ∫_T f · v,   u = g on the fixed dofs,

with A*_T in the full gradient layout (row i·d + j holds ∂_j v_i) and a
constant load f.  The tensors of a symmetric coefficient are symmetric, so
the reference takes the symmetric part of those it is given: a float32
tensor's rounding leaves it off by ~1e-7, which the choice of index order
or of a solver that reads one triangle would otherwise amplify by the
macro system's condition number.  Dense assembly, the fixed values lifted
into the load, LU on the free dofs.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.fem import Precision, assemble_dense, p1_geometry, dense_solve

__all__ = ["MacroProblem"]


class MacroProblem:
    """Static geometry of the macro mesh ``verts``, ``cells`` (numpy) with
    ``bs`` unknowns a node and the dofs ``fixed`` (boolean, nv·bs) held at
    ``values`` (nv·bs; None: 0)."""

    def __init__(self, verts: np.ndarray, cells: np.ndarray, bs: int, fixed: np.ndarray, device,
                 values=None):
        self.device = torch.device(device)
        v = torch.as_tensor(verts, dtype=torch.float64, device=self.device)
        c = torch.as_tensor(cells, dtype=torch.int64, device=self.device)
        grads, self.vols = p1_geometry(v, c)
        d = v.shape[1]
        self.bs = bs
        self.centers = v[c].mean(dim=1)
        nc, nv = c.shape
        B = torch.zeros(nc, d * bs, nv * bs, dtype=torch.float64, device=self.device)
        for a in range(nv):
            for i in range(bs):
                B[:, i * d:(i + 1) * d, a * bs + i] = grads[:, a, :]
        self.B = B
        comp = torch.arange(bs, device=self.device)
        self.dofs = (c[:, :, None] * bs + comp).reshape(nc, -1)
        self.n = v.shape[0] * bs
        self.free = torch.as_tensor(np.flatnonzero(~np.asarray(fixed)), device=self.device)
        g = np.zeros(self.n) if values is None else np.asarray(values, dtype=np.float64)
        self.g = torch.as_tensor(np.where(np.asarray(fixed), g, 0.0), device=self.device)

    def solve(self, Astar: torch.Tensor, f, prec: Precision) -> torch.Tensor:
        """u (n,) for the tensors ``Astar`` (nc, r, r) and the load ``f``
        (bs,)."""
        dt = prec.dtype
        Asym = 0.5 * (Astar + Astar.transpose(1, 2)).to(dt)
        S = prec.einsum("c,crl,crt,ctm->clm", self.vols.to(dt), self.B.to(dt), Asym,
                        self.B.to(dt))
        K = assemble_dense(S[None], self.dofs, self.n)[0]
        nb = self.dofs.shape[1]
        f = torch.as_tensor(np.asarray(f, dtype=np.float64), device=self.device)
        load = (self.vols[:, None] / (nb // self.bs)) * f.repeat(nb // self.bs)[None, :]
        b = torch.zeros(self.n, dtype=dt, device=self.device)
        b.index_add_(0, self.dofs.reshape(-1), load.to(dt).reshape(-1))
        fr = self.free
        g = self.g.to(dt)
        b = b - prec.einsum("ij,j->i", K, g).to(dt)
        u = g.clone()
        u[fr] = dense_solve(K[fr][:, fr][None], b[fr, None][None])[0, :, 0]
        return u
