"""Reference of the ``poisson_hmm`` family: −div(A(x, x/ε) ∇u) = f on the
configuration's rectangle, u held at its Dirichlet values on the left and
right edges (natural on the others), by the HMM with P1 macro and micro
elements, and the laminate coefficient of the configuration

    A(x, y) = a0 + θ·x₀ + amplitude · sin 2π(y₀ + x₁).

ε cancels in the HMM's scaling and does not enter.
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
        d = 2
        n = cfg["macro_cells_per_axis"]
        box = np.asarray(cfg["macro_box"], dtype=np.float64)
        self.verts, self.cells = box_mesh(box[0], box[1], [n, n])
        left = np.isclose(self.verts[:, 0], box[0, 0])
        right = np.isclose(self.verts[:, 0], box[1, 0])
        values = np.where(left, float(cfg["dirichlet"]["left"]), 0.0)
        values = np.where(right, float(cfg["dirichlet"]["right"]), values)
        self.macro = MacroProblem(self.verts, self.cells, 1, left | right, device, values)
        self.cell = CellProblem(cfg["micro_cells_per_axis"], d, 1, device)
        self.centers = self.macro.centers

    def astar(self, idx: torch.Tensor, theta: float, prec: Precision) -> torch.Tensor:
        """A* (len(idx), 2, 2) of the macro cells ``idx``."""
        c = self.cfg["coefficient"]
        x = self.centers[idx]
        y = self.cell.yq
        vals = (c["a0"] + theta * x[:, 0, None, None]
                + c["amplitude"] * torch.sin(2 * math.pi * (y[None, :, :, 0]
                                                            + x[:, 1, None, None])))
        abar = prec.einsum("ceq,eq->ce", vals.to(prec.dtype), self.cell.wq.to(prec.dtype))
        eye = torch.eye(2, dtype=prec.dtype, device=abar.device)
        return self.cell.tensors(abar[:, :, None, None] * eye, None, prec)

    def solve(self, Astar: torch.Tensor, prec: Precision) -> torch.Tensor:
        """u at the macro vertices for the tensors ``Astar`` of every cell."""
        return self.macro.solve(Astar, [float(self.cfg["load"])], prec)
