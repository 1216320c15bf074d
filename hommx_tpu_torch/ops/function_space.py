"""Function spaces, functions and Dirichlet boundary conditions (torch port
of ``hommx_tpu/ops/function_space.py``; P1 Lagrange only — P2 spaces wait
for ROADMAP A9d).

Dof layout: node-major, component-minor — dof = node * bs + component.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from hommx_tpu_torch.config import as_device, default_dtype
from hommx_tpu_torch.meshes.simplex import SimplexMesh

__all__ = [
    "FunctionSpace",
    "Function",
    "DirichletBC",
    "dirichletbc",
    "locate_dofs_geometrical",
    "boundary_dofs",
    "eval_at_points",
]


def eval_at_points(fn: Callable, pts: torch.Tensor) -> torch.Tensor:
    """``fn`` applied to every point of ``pts`` (..., d) -> (..., *out).

    ``fn`` takes one point of shape (d,) and is vectorized with
    ``torch.func.vmap``; a constant result (a Python number or an
    unbatched tensor) is broadcast over the points.
    """
    lead = pts.shape[:-1]
    flat = pts.reshape(-1, pts.shape[-1])

    def one(x):
        return torch.as_tensor(fn(x), device=x.device)

    vals = torch.func.vmap(one)(flat)
    return vals.reshape(*lead, *vals.shape[1:])


class FunctionSpace:
    """P1 Lagrange space (bs=1 scalar, bs=d vector) on a simplex mesh."""

    def __init__(self, mesh: SimplexMesh, bs: int = 1, degree: int = 1):
        if int(degree) != 1:
            raise NotImplementedError("only P1 spaces are ported (P2: ROADMAP A9d)")
        self.mesh = mesh
        self.bs = int(bs)
        self.degree = 1

    @property
    def dim(self) -> int:
        return self.mesh.dim

    @property
    def num_nodes(self) -> int:
        return self.mesh.num_vertices

    @property
    def num_dofs(self) -> int:
        return self.num_nodes * self.bs

    @property
    def dofs_per_cell(self) -> int:
        return self.mesh.cells.shape[1] * self.bs

    def tabulate_dof_coordinates(self) -> np.ndarray:
        return self.mesh.vertices

    def cell_nodes(self) -> np.ndarray:
        return self.mesh.cells

    def cell_dofs_unrolled(self) -> np.ndarray:
        """(num_cells, dofs_per_cell) unrolled scalar dof indices per cell."""
        cells = self.mesh.cells
        if self.bs == 1:
            return cells
        comp = np.arange(self.bs)
        return (cells[:, :, None] * self.bs + comp[None, None, :]).reshape(
            cells.shape[0], -1
        )

    def boundary_nodes(self) -> np.ndarray:
        return self.mesh.boundary_vertices()

    def __eq__(self, other):
        return (
            isinstance(other, FunctionSpace)
            and other.mesh is self.mesh
            and other.bs == self.bs
        )

    def __hash__(self):
        return hash((id(self.mesh), self.bs))

    def __repr__(self):
        return f"FunctionSpace(P1, bs={self.bs}, mesh={self.mesh!r})"


class Function:
    """A coefficient vector over a FunctionSpace: ``f.array`` is the flat
    (num_dofs,) tensor (``f.x.array`` also works)."""

    def __init__(self, V: FunctionSpace, array=None, device="cuda", dtype=None):
        self.space = V
        if array is None:
            device = as_device(device)
            array = torch.zeros(
                V.num_dofs, dtype=dtype or default_dtype(device), device=device
            )
        self.array = torch.as_tensor(array)

    @property
    def x(self) -> "Function":
        return self

    @property
    def function_space(self) -> FunctionSpace:
        return self.space


class DirichletBC:
    """Dirichlet condition in canonical (unrolled dofs, values) form."""

    def __init__(self, dofs: np.ndarray, values: np.ndarray, V: FunctionSpace):
        self.dofs = np.asarray(dofs, dtype=np.int32)
        self.values = np.asarray(values, dtype=np.float64)
        if self.dofs.shape != self.values.shape:
            raise ValueError("dofs and values must have the same shape")
        self.space = V

    @property
    def g(self):
        return self.values


def dirichletbc(
    value: Union[float, Sequence[float], Function],
    dofs: np.ndarray,
    V: Optional[FunctionSpace] = None,
) -> DirichletBC:
    """Build a DirichletBC from node indices + value (scalar, (bs,) vector,
    or a Function sampled at the nodes); every component of a vector node is
    constrained."""
    dofs = np.asarray(dofs, dtype=np.int32)
    if isinstance(value, Function):
        V = value.space if V is None else V
        bs = V.bs
        unrolled = (dofs[:, None] * bs + np.arange(bs)[None, :]).reshape(-1)
        vals = value.array.detach().cpu().numpy()[unrolled]
        return DirichletBC(unrolled, vals, V)
    if V is None:
        raise ValueError("V required for non-Function values")
    bs = V.bs
    unrolled = (dofs[:, None] * bs + np.arange(bs)[None, :]).reshape(-1)
    value = np.asarray(value, dtype=np.float64)
    if value.ndim == 0:
        vals = np.full(unrolled.shape, float(value))
    else:
        if value.shape != (bs,):
            raise ValueError(f"vector bc value must have shape ({bs},)")
        vals = np.tile(value, dofs.shape[0])
    return DirichletBC(unrolled, vals, V)


def locate_dofs_geometrical(V: FunctionSpace, marker: Callable) -> np.ndarray:
    """Node indices where ``marker(x)`` is True; ``x`` is (dim, N) numpy."""
    x = V.tabulate_dof_coordinates().T
    mask = np.asarray(marker(x), dtype=bool)
    return np.nonzero(mask)[0].astype(np.int32)


def boundary_dofs(V: FunctionSpace, marker: Optional[Callable] = None) -> np.ndarray:
    """Node indices on the mesh boundary, optionally filtered by a marker."""
    bnodes = V.boundary_nodes()
    if marker is None:
        return bnodes.astype(np.int32)
    x = V.tabulate_dof_coordinates()[bnodes].T
    mask = np.asarray(marker(x), dtype=bool)
    return bnodes[mask].astype(np.int32)
