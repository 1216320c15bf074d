"""Function spaces, functions and Dirichlet boundary conditions (torch port
of ``hommx_tpu/ops/function_space.py``): P1 and P2 Lagrange spaces, scalar
or d-vector, the DOLFINx-style ``functionspace`` constructor and
``Function`` surface (``values``, ``interpolate``, ``eval``, ``copy``,
``scatter_forward``).

Dof layout: node-major, component-minor — dof = node * bs + component.
P2 nodes are the vertices, then the edge midpoints (ops/p2.py).
"""

from __future__ import annotations

import itertools
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from hommx_tpu_torch.config import as_device, default_dtype
from hommx_tpu_torch.meshes.simplex import SimplexMesh

__all__ = [
    "FunctionSpace",
    "Function",
    "DirichletBC",
    "functionspace",
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
    """P1/P2 Lagrange space (bs=1 scalar, bs=d vector) on a simplex mesh.
    P2 (degree=2) adds the edge-midpoint nodes (ops/p2.py)."""

    def __init__(self, mesh: SimplexMesh, bs: int = 1, degree: int = 1):
        self.mesh = mesh
        self.bs = int(bs)
        self.degree = int(degree)
        if self.degree not in (1, 2):
            raise NotImplementedError("only P1 and P2 Lagrange are supported")
        if self.degree == 2:
            from hommx_tpu_torch.ops.p2 import build_edges, p2_cell_dofs, p2_dof_coordinates

            self.edges, self.cell_edges = build_edges(mesh.cells, mesh.num_vertices)
            self._cell_nodes = p2_cell_dofs(mesh.cells, self.cell_edges, mesh.num_vertices)
            self._dof_coords = p2_dof_coordinates(mesh.vertices, self.edges)
        else:
            self._cell_nodes = mesh.cells
            self._dof_coords = mesh.vertices

    @property
    def dim(self) -> int:
        return self.mesh.dim

    @property
    def num_nodes(self) -> int:
        return self._dof_coords.shape[0]

    @property
    def num_dofs(self) -> int:
        return self.num_nodes * self.bs

    @property
    def dofs_per_cell(self) -> int:
        return self._cell_nodes.shape[1] * self.bs

    def tabulate_dof_coordinates(self) -> np.ndarray:
        """(num_nodes, dim) node coordinates (P1: vertices; P2: + midpoints)."""
        return self._dof_coords

    def cell_nodes(self) -> np.ndarray:
        """(num_cells, nodes_per_cell) node indices per cell."""
        return self._cell_nodes

    def cell_dofs_unrolled(self) -> np.ndarray:
        """(num_cells, dofs_per_cell) unrolled scalar dof indices per cell."""
        cells = self._cell_nodes
        if self.bs == 1:
            return cells
        comp = np.arange(self.bs)
        return (cells[:, :, None] * self.bs + comp[None, None, :]).reshape(
            cells.shape[0], -1
        )

    def boundary_nodes(self) -> np.ndarray:
        """Node indices on the mesh boundary: the boundary vertices, and for
        P2 the midpoints of the boundary edges after them."""
        bverts = self.mesh.boundary_vertices()
        if self.degree == 1:
            return bverts
        facets = self.mesh.boundary_facets()  # (nf, d) sorted
        d = self.mesh.dim
        if d == 2:
            bedges = {tuple(f) for f in facets.tolist()}
        else:
            bedges = {
                (int(f[0]), int(f[1]))
                for pair in itertools.combinations(range(d), 2)
                for f in facets[:, list(pair)]
            }
        edge_keys = {tuple(e): i for i, e in enumerate(self.edges.tolist())}
        mid_ids = [self.mesh.num_vertices + edge_keys[e] for e in bedges if e in edge_keys]
        return np.concatenate([bverts, np.asarray(sorted(mid_ids), dtype=np.int64)])

    def __eq__(self, other):
        return (
            isinstance(other, FunctionSpace)
            and other.mesh is self.mesh
            and other.bs == self.bs
            and other.degree == self.degree
        )

    def __hash__(self):
        return hash((id(self.mesh), self.bs, self.degree))

    def __repr__(self):
        return f"FunctionSpace(P{self.degree}, bs={self.bs}, mesh={self.mesh!r})"


def functionspace(mesh: SimplexMesh, element=("Lagrange", 1)) -> FunctionSpace:
    """DOLFINx-style constructor: ``functionspace(mesh, ("Lagrange", 1))``,
    or ``functionspace(mesh, ("Lagrange", 2, (dim,)))`` for a vector space."""
    family, degree, *shape = element
    if family not in ("Lagrange", "P", "CG") or degree not in (1, 2):
        raise NotImplementedError("only P1/P2 Lagrange spaces are supported")
    bs = 1 if not shape else int(np.prod(shape[0]))
    return FunctionSpace(mesh, bs, degree)


class Function:
    """A coefficient vector over a FunctionSpace: ``f.array`` is the flat
    (num_dofs,) tensor (``f.x.array`` also works).  Without an array it is
    zero, on ``device`` (the card by default) in ``dtype`` (the device's
    default)."""

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

    def values(self) -> torch.Tensor:
        """(num_nodes, bs) view of the dof vector."""
        return self.array.reshape(self.space.num_nodes, self.space.bs)

    def interpolate(self, fn: Callable) -> "Function":
        """Set the dof values from a callable x -> scalar or (bs,) value.

        ``fn`` receives one point of shape (dim,) and is vectorized over
        the nodes with ``torch.func.vmap`` on the Function's device, in
        float64; a callable that vmap cannot trace (data-dependent Python
        control flow, ``float(x[0])``) is called point by point on float64
        host tensors instead.  The values keep the Function's device and
        dtype."""
        arr = self.array
        coords = torch.as_tensor(self.space.tabulate_dof_coordinates(), dtype=torch.float64,
                                 device=arr.device)
        try:
            vals = eval_at_points(fn, coords)
        except (RuntimeError, TypeError, ValueError):  # what vmap raises on untraceable code
            vals = torch.stack([
                torch.as_tensor(np.asarray(fn(c), dtype=np.float64))
                for c in coords.cpu()
            ])
        self.array = vals.to(device=arr.device, dtype=arr.dtype).reshape(-1)
        return self

    def eval(self, points, cells=None) -> torch.Tensor:
        """Values at ``points`` (np, d) -> (np,) or (np, bs), float64 on the
        host (ops/interpolation.py::eval_p1); with ``cells`` each point
        takes the polynomial of its given cell."""
        from hommx_tpu_torch.ops.interpolation import eval_p1

        return eval_p1(self, points, cells)

    def copy(self) -> "Function":
        """A Function on the same space with a copy of the dof vector."""
        return Function(self.space, self.array.clone())

    def scatter_forward(self) -> "Function":
        """Single-program: no ghost values to update."""
        return self


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
