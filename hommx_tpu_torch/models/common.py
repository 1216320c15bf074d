"""Shared machinery for the solver classes (torch port of
``hommx_tpu/models/common.py``): coefficient probing, BC merging, the macro
system's static data and its assembly.

Scalar (bs = 1) and vector (bs = d, elasticity) macro systems.  Only the
native-float64 / pipeline-dtype assembly is ported; the reference's
double-float32 route exists for the TPU's emulated float64 and is not
ported (ROADMAP "Do not port").  Multigrid and AMG hierarchies wait for
ROADMAP A5/A10.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from hommx_tpu_torch.config import as_device
from hommx_tpu_torch.ops.assembly import apply_dirichlet, assemble_ell
from hommx_tpu_torch.ops.dia import build_dia_from_ell
from hommx_tpu_torch.ops.elements import cell_geometry
from hommx_tpu_torch.ops.function_space import DirichletBC, FunctionSpace
from hommx_tpu_torch.ops.solvers import require_jacobi
from hommx_tpu_torch.ops.sparse import build_ell_pattern

__all__ = [
    "probe_coeff_kind",
    "strain_coefficients",
    "merge_bcs",
    "MacroSystem",
    "macro_precs",
    "assemble_macro_system",
]


def assemble_macro_system(sys, A_star, b, mask, bvals, *, macro_f64: bool):
    """A*(c_T) batch -> BC-applied macro ELL system (vals_bc, b_bc): per-cell
    stiffness S_loc = |T|·P A*ᵀ Pᵀ (P the P1 gradients, or the strain
    coefficients of the vector basis), ELL scatter assembly and symmetric
    Dirichlet lifting.  ``macro_f64`` runs the chain in float64 (the
    direct-solve path and every vector system)."""
    vector = sys.V.bs > 1
    if macro_f64:
        vols = sys.vols64
        P = sys.strain_P64 if vector else sys.grads64
        A_T = A_star.transpose(-1, -2).to(torch.float64)
        bvals = bvals.to(torch.float64)
        b = b.to(torch.float64)
    else:
        vols = sys.vols
        P = sys.strain_P if vector else sys.grads
        A_T = A_star.transpose(-1, -2)  # reference index order
    S_loc = torch.einsum("c,cad,cde,cbe->cab", vols, P, A_T, P)
    vals = assemble_ell(sys.pattern, S_loc, sys.slots)
    return apply_dirichlet(vals, sys.cols, sys.diag_slots, b, mask, bvals, dia=sys.dia)


def macro_precs(sys, options):
    """The reference's (mg, amg) preconditioner structures.  None of them
    is ported: (None, None) when the solve is direct or Jacobi CG, and
    ``NotImplementedError`` for multigrid ('auto'/'mg') on the CG path."""
    method = options.method
    if method == "auto":
        method = "direct" if sys.V.num_dofs <= options.direct_threshold else "cg"
    if method == "cg":
        require_jacobi(options)
    return None, None


def probe_coeff_kind(coeff: Callable, dim: int, nargs: int = 2) -> str:
    """Classify A(x, y) (or A(y)) output: 'scalar' | 'matrix' | 'tensor4',
    from one evaluation at the origin."""
    x = torch.zeros(dim, dtype=torch.float64)
    shape = tuple(torch.as_tensor(coeff(*((x, x)[:nargs]))).shape)
    if shape == ():
        return "scalar"
    if shape == (dim, dim):
        return "matrix"
    if shape == (dim, dim, dim, dim):
        return "tensor4"
    raise ValueError(f"unsupported coefficient shape {shape} for dim={dim}")


def strain_coefficients(grads: torch.Tensor, d: int) -> torch.Tensor:
    """P[c, m, (kl)] = e(v_m)_kl for the vector basis m = vertex·d + comp:
    e(v_(a,i))_kl = ½(δ_ik ∂λ_a/∂x_l + δ_il ∂λ_a/∂x_k).  grads: (nc, d+1, d)
    P1 gradients; returns (nc, (d+1)·d, d²)."""
    nc, nb0, _ = grads.shape
    eye = torch.eye(d, dtype=grads.dtype, device=grads.device)
    E = 0.5 * (
        torch.einsum("ik,cal->caikl", eye, grads) + torch.einsum("il,cak->caikl", eye, grads)
    )
    return E.reshape(nc, nb0 * d, d * d)


def merge_bcs(bcs: Sequence[DirichletBC], num_dofs: int, dtype, device):
    """Combine DirichletBCs into (mask, values) tensors over all dofs; later
    BCs win on overlapping dofs."""
    mask = np.zeros(num_dofs, dtype=bool)
    vals = np.zeros(num_dofs, dtype=np.float64)
    for bc in bcs:
        mask[bc.dofs] = True
        vals[bc.dofs] = bc.values
    return (
        torch.as_tensor(mask, device=device),
        torch.as_tensor(vals, dtype=dtype, device=device),
    )


class MacroSystem:
    """Static assembly data for the macro FEM system on a function space:
    the ELL pattern and its DIA view on the host, index tensors and the
    geometry (float64 and pipeline-dtype copies) on ``device``; for vector
    spaces also the strain coefficients ``strain_P64`` / ``strain_P``."""

    def __init__(self, V: FunctionSpace, dtype, device):
        device = as_device(device)
        self.V = V
        self.dtype = dtype
        self.device = device
        self.cell_dofs = V.cell_dofs_unrolled()
        self.pattern = build_ell_pattern(self.cell_dofs, V.num_dofs)
        # DIA view of the sparsity (structured meshes): static shifted
        # multiply-adds for the CG matvec
        self.dia = build_dia_from_ell(self.pattern)
        self.slots = torch.as_tensor(self.pattern.slots.astype(np.int64), device=device)
        self.cols = torch.as_tensor(self.pattern.cols.astype(np.int64), device=device)
        self.diag_slots = torch.as_tensor(
            self.pattern.diag_slots.astype(np.int64), device=device
        )
        self.cells = torch.as_tensor(V.mesh.cells.astype(np.int64), device=device)
        # geometry in f64, kept both ways: f64 for the f64 direct path, the
        # pipeline dtype for the CG path
        self.verts64 = torch.as_tensor(V.mesh.vertices, dtype=torch.float64, device=device)
        self.grads64, self.vols64 = cell_geometry(self.verts64, self.cells)
        self.verts = self.verts64.to(dtype)
        self.grads = self.grads64.to(dtype)
        self.vols = self.vols64.to(dtype)
        self.centers = self.verts64[self.cells].mean(dim=1).to(dtype)  # c_T
        if V.bs > 1:
            self.strain_P64 = strain_coefficients(self.grads64, V.bs)
            self.strain_P = self.strain_P64.to(dtype)  # (nc, nb, d²)
