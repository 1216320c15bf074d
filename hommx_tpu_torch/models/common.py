"""Shared machinery for the solver classes (torch port of
``hommx_tpu/models/common.py``): coefficient probing, BC merging, the macro
system's static data and its assembly.

Scalar (bs = 1) and vector (bs = d, elasticity) macro systems.  Only the
native-float64 / pipeline-dtype assembly is ported; the reference's
double-float32 route exists for the TPU's emulated float64 and is not
ported (ROADMAP "Do not port").  ``MacroSystem.mg`` builds the geometric
multigrid hierarchy of a structured mesh lazily, ``MacroSystem.amg`` the
aggregation-AMG hierarchy (ops/amg.py) of every other system.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from hommx_tpu_torch.config import as_device
from hommx_tpu_torch.ops.amg import build_amg_structure
from hommx_tpu_torch.ops.assembly import (
    GatherPlan,
    apply_dirichlet,
    assemble_ell,
    build_gather_assembly,
    invert_scatter,
)
from hommx_tpu_torch.ops.dia import build_dia_from_ell
from hommx_tpu_torch.ops.elements import cell_geometry
from hommx_tpu_torch.ops.function_space import DirichletBC, FunctionSpace
from hommx_tpu_torch.ops.multigrid import build_mg_structure
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
    Dirichlet lifting.

    The chain runs in float64 on every path.  With ``macro_f64`` (the
    direct path and every vector system) the system stays float64; else it
    is rounded once to the pipeline dtype.  The reference accumulates a
    float32 system in float32, whose roundings break the zero row sums of
    the stiffness, and the solve amplifies them by up to κ: on the 512²
    Poisson slice its solution lies 6.6e-4 from the float64 system's, the
    once-rounded system's 1.0e-4 (``tools/macro_rounding.py`` on an NVIDIA
    H100 80GB HBM3 at 700 W)."""
    P = sys.strain_P64 if sys.V.bs > 1 else sys.grads64
    A_T = A_star.transpose(-1, -2).to(torch.float64)  # reference index order
    S_loc = torch.einsum("c,cad,cde,cbe->cab", sys.vols64, P, A_T, P)
    vals = assemble_ell(sys.pattern, S_loc, sys.slots, gather=sys.gather_asm)
    vals_bc, b_bc = apply_dirichlet(
        vals, sys.cols, sys.diag_slots, b.to(torch.float64), mask,
        bvals.to(torch.float64), dia=sys.dia,
    )
    if macro_f64:
        return vals_bc, b_bc
    return vals_bc.to(sys.dtype), b_bc.to(sys.dtype)


def macro_precs(sys, options):
    """The (mg, amg) preconditioner structures of the iterative macro path:
    (None, None) when the solve is direct or the options exclude multigrid,
    so the lazy hierarchy builds never run for solves that cannot use them;
    else (sys.mg, sys.amg), of which at most one is not None.  Float64
    systems get the hierarchies too (elasticity above the direct threshold
    runs a float64 V-cycle)."""
    method = options.method
    if method == "auto":
        method = "direct" if sys.V.num_dofs <= options.direct_threshold else "cg"
    if method != "cg" or options.pc not in ("auto", "mg"):
        return None, None
    return sys.mg, sys.amg


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
        # geometry in f64, which the assembly uses on every path; the
        # pipeline-dtype copies serve ``local_stiffness``
        self.verts64 = torch.as_tensor(V.mesh.vertices, dtype=torch.float64, device=device)
        self.grads64, self.vols64 = cell_geometry(self.verts64, self.cells)
        self.grads = self.grads64.to(dtype)
        self.vols = self.vols64.to(dtype)
        self.centers = self.verts64[self.cells].mean(dim=1).to(dtype)  # c_T
        if V.bs > 1:
            self.strain_P64 = strain_coefficients(self.grads64, V.bs)
            self.strain_P = self.strain_P64.to(dtype)  # (nc, nb, d²)
        self._mg = False  # lazily built (False = not yet, None = unavailable)
        self._amg = False
        # fixed-order gather plans of the ELL assembly and of the load
        # vector for a CUDA system, built on the device: index_add_ there
        # adds colliding entries in the order its atomics land, so two
        # identical runs would differ in the last bits.  None on the CPU,
        # where the scatter is in order (and at a pathological multiplicity)
        self.gather_asm = self.load_gather = None
        if device.type == "cuda":
            table = build_gather_assembly(self.pattern, device=device)
            if table is not None:
                self.gather_asm = GatherPlan(table, self.pattern.slots.size, device)
            table = invert_scatter(self.cell_dofs, V.num_dofs, device=device)
            self.load_gather = GatherPlan(table, self.cell_dofs.size, device)

    @property
    def mg(self):
        """Geometric-multigrid hierarchy of the macro operator (structured
        meshes with a DIA view; None otherwise), built on first use: the
        direct path never needs it."""
        if self._mg is False:
            self._mg = (
                build_mg_structure(self.V.mesh.structure, self.V.bs, self.dia)
                if self.V.degree == 1
                else None
            )
        return self._mg

    @property
    def amg(self):
        """Aggregation-AMG hierarchy (ops/amg.py), the preconditioner of the
        systems the geometric hierarchy declines (Delaunay and file meshes,
        P2 spaces), built on first use.  None where geometric multigrid
        exists (it is stronger) or the system is at or below the bottom
        size."""
        if self._amg is False:
            self._amg = (
                None if self.mg is not None
                else build_amg_structure(self.pattern, self.V.bs,
                                         near_kernel=self._rigid_modes())
            )
        return self._amg

    def _rigid_modes(self):
        """The near-null space of the AMG tentative prolongation where the
        block size equals the dimension (elasticity): the per-component
        translations and the rotations of the dof coordinates, centred and
        scaled so the rotations are O(1) like the translations (PETSc GAMG
        given the rigid-body ``NearNullSpace``).  None for scalar systems,
        which take the translations inside ``build_amg_structure``."""
        bs, d = self.V.bs, self.V.dim
        if bs != d or d < 2:
            return None
        x = np.asarray(self.V.tabulate_dof_coordinates(), dtype=np.float64)
        x = x - x.mean(axis=0)
        x = x / max(float(np.abs(x).max()), 1e-30)
        n_nodes = x.shape[0]
        m = bs + (d * (d - 1)) // 2
        B = np.zeros((n_nodes * bs, m))
        B[np.arange(n_nodes * bs), np.arange(n_nodes * bs) % bs] = 1.0
        pairs = [(0, 1)] if d == 2 else [(0, 1), (0, 2), (1, 2)]
        for k, (a, b) in enumerate(pairs):
            B[np.arange(n_nodes) * bs + a, bs + k] = -x[:, b]
            B[np.arange(n_nodes) * bs + b, bs + k] = x[:, a]
        return B
