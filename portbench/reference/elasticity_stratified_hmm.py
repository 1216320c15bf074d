"""Reference of the ``elasticity_stratified_hmm`` family: the rotated-fibre
beam of the upstream ``examples/linear_elasticity/rotated_fibers.py``.

- Macro: the box [0, L]×[0, W]×[0, H], P1 displacements, clamped
  (u = 0) on the face x₀ = 0, the constant load (0, 0, −g).
- Hooke tensor C_ijkl = λ δ_ij δ_kl + μ (δ_ik δ_jl + δ_il δ_jk), λ = 1;
  μ = μ_fibre · (1 + slope·θ·(x₀ + x₂)) where (y₁, y₂) lies within r of
  (½, ½) by the wrapped distance, |arccos cos 2π(y_k − ½)| in each
  coordinate, else μ_matrix.
- Stratified map Dθᵀ(x) = R(γ)ᵀ, R the rotation by γ = (π/2)·x₁/W in the
  (0, 2) plane, [[c, 0, s], [0, 1, 0], [−s, 0, c]]; the cell problems'
  corrector strain is e_D(u) = sym(Dθᵀ ∇̄u), ∇̄u the transposed gradient,
  the generators' strain the plain one.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.cells import CellProblem
from portbench.reference.fem import Precision, box_mesh
from portbench.reference.macro import MacroProblem

__all__ = ["Model"]


class Model:
    def __init__(self, cfg: dict, device):
        self.cfg = cfg
        box = np.asarray(cfg["macro_box"], dtype=np.float64)
        self.verts, self.cells = box_mesh(box[0], box[1], cfg["macro_cells"])
        clamped = np.isclose(self.verts[:, 0], box[0, 0])
        self.macro = MacroProblem(self.verts, self.cells, 3, np.repeat(clamped, 3), device)
        self.cell = CellProblem(cfg["micro_cells_per_axis"], 3, 3, device)
        self.centers = self.macro.centers
        self.width = float(box[1, 1] - box[0, 1])
        eye = torch.eye(3, dtype=torch.float64, device=self.centers.device)
        self._lam_part = torch.einsum("ij,kl->ijkl", eye, eye).reshape(9, 9)
        self._mu_part = (torch.einsum("ik,jl->ijkl", eye, eye)
                         + torch.einsum("il,jk->ijkl", eye, eye)).reshape(9, 9)

    def _maps(self, x: torch.Tensor) -> torch.Tensor:
        """T (C, 9, 9): the gradient H (H_pq = ∂u_p/∂y_q at row p·3 + q) to
        e_D = ½(M Hᵀ + H Mᵀ), M = Dθᵀ(x)."""
        g = 0.5 * math.pi * x[:, 1] / self.width
        c, s = torch.cos(g), torch.sin(g)
        z, o = torch.zeros_like(c), torch.ones_like(c)
        R = torch.stack([torch.stack([c, z, s], -1), torch.stack([z, o, z], -1),
                         torch.stack([-s, z, c], -1)], -2)
        M = R.transpose(1, 2)
        eye = torch.eye(3, dtype=x.dtype, device=x.device)
        T = 0.5 * (torch.einsum("ciq,pj->cijpq", M, eye) + torch.einsum("cjq,pi->cijpq", M, eye))
        return T.reshape(-1, 9, 9)

    def astar(self, idx: torch.Tensor, theta: float, prec: Precision) -> torch.Tensor:
        """A* (len(idx), 9, 9) of the macro cells ``idx``."""
        c = self.cfg["coefficient"]
        x = self.centers[idx]
        y = self.cell.yq  # (ne, nq, 3)
        r = c["fibre_radius"]
        da = torch.arccos(torch.cos(2 * math.pi * (y[..., 1] - 0.5)))
        db = torch.arccos(torch.cos(2 * math.pi * (y[..., 2] - 0.5)))
        fibre = (da**2 + db**2) < (2 * math.pi) ** 2 * r**2
        stiff = c["mu_fibre"] * (1.0 + c["fibre_slope"] * theta * (x[:, 0] + x[:, 2]))
        mu = torch.where(fibre[None], stiff[:, None, None],
                         torch.full_like(stiff, c["mu_matrix"])[:, None, None])
        wq = self.cell.wq.to(prec.dtype)
        mubar = prec.einsum("ceq,eq->ce", mu.to(prec.dtype), wq)
        vol = wq.sum(dim=1)
        abar = (c["lambda"] * vol[None, :, None, None] * self._lam_part.to(prec.dtype)
                + mubar[:, :, None, None] * self._mu_part.to(prec.dtype))
        return self.cell.tensors(abar, self._maps(x), prec)

    def solve(self, Astar: torch.Tensor, prec: Precision) -> torch.Tensor:
        """u (nv·3,) at the macro vertices for the tensors ``Astar`` of every
        cell."""
        return self.macro.solve(Astar, [0.0, 0.0, -float(self.cfg["load_g"])], prec)
