"""Struct-of-arrays simplex meshes (triangles, tetrahedra) — numpy copy of
``hommx_tpu/meshes/simplex.py``.

The mesh is host state (numpy); solvers move what they need to a torch
device.  ``mesh_from_delaunay``/``mesh_from_file`` and the rescale helpers
are not ported yet (ROADMAP A10).

Replaces DOLFINx's C++ mesh stack (``mesh.create_unit_square/cube/rectangle/
box``, ``helpers.py:125-209`` of the reference) with plain arrays:

    vertices : (num_vertices, dim) float
    cells    : (num_cells, dim+1) int32

For P1 Lagrange elements the dofmap *is* the ``cells`` array, so no separate
dofmap machinery is needed (reference ``hmm.py:311`` uses
``dofmap.cell_dofs``; here that is ``mesh.cells[c]``).

Structured box meshes remember their grid structure (``BoxStructure``) which
gives O(1) analytic point location for cross-mesh interpolation (replaces
``fem.create_interpolation_data`` / ``interpolate_nonmatching`` used by the
reference tests, ``test_integration_poisson.py:15-24``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

__all__ = [
    "SimplexMesh",
    "BoxStructure",
    "create_rectangle",
    "create_unit_square",
    "create_box",
    "create_unit_cube",
]


@dataclasses.dataclass(frozen=True)
class BoxStructure:
    """Grid metadata for structured box meshes (analytic point location)."""

    lo: np.ndarray  # (dim,)
    hi: np.ndarray  # (dim,)
    shape: tuple  # number of grid intervals per axis, e.g. (nx, ny)
    cells_per_box: int  # 2 triangles / 6 tets per grid box
    diagonal: str = "right"  # 2D split direction (which triangle is t0)


class SimplexMesh:
    """A conforming simplex mesh held as numpy arrays.

    Arrays are kept on host (numpy); solver setup converts what it needs to
    device arrays.  Mutation is not supported except for the in-place rescale
    helper mirroring the reference API.
    """

    def __init__(
        self,
        vertices: np.ndarray,
        cells: np.ndarray,
        structure: Optional[BoxStructure] = None,
    ):
        vertices = np.ascontiguousarray(np.asarray(vertices, dtype=np.float64))
        cells = np.ascontiguousarray(np.asarray(cells, dtype=np.int32))
        if vertices.ndim != 2:
            raise ValueError("vertices must have shape (num_vertices, dim)")
        if cells.ndim != 2 or cells.shape[1] != vertices.shape[1] + 1:
            raise ValueError(
                "cells must have shape (num_cells, dim+1); got "
                f"{cells.shape} for dim={vertices.shape[1]}"
            )
        self.vertices = vertices
        self.cells = cells
        self.structure = structure

    # -- basic queries -------------------------------------------------------
    @property
    def dim(self) -> int:
        return self.vertices.shape[1]

    @property
    def num_vertices(self) -> int:
        return self.vertices.shape[0]

    @property
    def num_cells(self) -> int:
        return self.cells.shape[0]

    def cell_vertices(self, c: int) -> np.ndarray:
        return self.vertices[self.cells[c]]

    def bounding_box(self):
        return self.vertices.min(axis=0), self.vertices.max(axis=0)

    def cell_volumes(self) -> np.ndarray:
        """|T| for every cell (length / area / volume)."""
        p = self.vertices[self.cells]  # (nc, d+1, d)
        edges = p[:, 1:, :] - p[:, :1, :]  # (nc, d, d)
        if self.dim == 1:
            det = edges[:, 0, 0]
        elif self.dim == 2:
            det = edges[:, 0, 0] * edges[:, 1, 1] - edges[:, 0, 1] * edges[:, 1, 0]
        else:
            det = np.linalg.det(edges)
        fact = {1: 1.0, 2: 2.0, 3: 6.0}[self.dim]
        return np.abs(det) / fact

    def volume(self) -> float:
        """Total measure of the mesh domain (|Y| in HMM scaling)."""
        return float(self.cell_volumes().sum())

    def boundary_facets(self) -> np.ndarray:
        """(num_boundary_facets, dim) sorted vertex tuples of boundary facets
        (a facet belongs to the boundary iff exactly one cell contains it)."""
        d = self.dim
        if d == 1:
            counts = np.bincount(self.cells.ravel(), minlength=self.num_vertices)
            return np.nonzero(counts == 1)[0][:, None]
        import itertools

        facets = []
        for idxs in itertools.combinations(range(d + 1), d):
            facets.append(np.sort(self.cells[:, list(idxs)], axis=1))
        facets = np.concatenate(facets, axis=0)
        uniq, counts = np.unique(facets, axis=0, return_counts=True)
        return uniq[counts == 1]

    def boundary_vertices(self) -> np.ndarray:
        """Indices of vertices on the domain boundary (facet-based).

        Replaces ``mesh.locate_entities_boundary`` with an all-boundary
        marker (reference ``test_unit.py:30-31``).
        """
        return np.unique(self.boundary_facets().ravel())

    def __repr__(self):
        return (
            f"SimplexMesh(dim={self.dim}, vertices={self.num_vertices}, "
            f"cells={self.num_cells}, structured={self.structure is not None})"
        )


# ---------------------------------------------------------------------------
# structured constructors
# ---------------------------------------------------------------------------


def create_rectangle(points, n, diagonal: str = "right") -> SimplexMesh:
    """Triangulated rectangle [p0, p1] with n=(nx, ny) grid intervals.

    Mirrors ``dolfinx.mesh.create_rectangle`` (used at reference
    ``examples/hmm.py:33``).  Each grid square is split into two triangles
    along the chosen diagonal ("right": bottom-left → top-right).
    """
    (x0, y0), (x1, y1) = np.asarray(points, dtype=np.float64)
    nx, ny = int(n[0]), int(n[1])
    xs = np.linspace(x0, x1, nx + 1)
    ys = np.linspace(y0, y1, ny + 1)
    X, Y = np.meshgrid(xs, ys, indexing="ij")  # vertex id = ix*(ny+1)+iy
    verts = np.stack([X.ravel(), Y.ravel()], axis=1)

    ix, iy = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    v00 = (ix * (ny + 1) + iy).ravel()
    v10 = ((ix + 1) * (ny + 1) + iy).ravel()
    v01 = (ix * (ny + 1) + iy + 1).ravel()
    v11 = ((ix + 1) * (ny + 1) + iy + 1).ravel()
    if diagonal == "right":
        t0 = np.stack([v00, v10, v11], axis=1)
        t1 = np.stack([v00, v11, v01], axis=1)
    elif diagonal == "left":
        t0 = np.stack([v00, v10, v01], axis=1)
        t1 = np.stack([v10, v11, v01], axis=1)
    else:
        raise ValueError(f"unknown diagonal {diagonal!r}")
    cells = np.concatenate([t0[:, None, :], t1[:, None, :]], axis=1).reshape(-1, 3)
    structure = BoxStructure(
        np.array([x0, y0]), np.array([x1, y1]), (nx, ny), 2, diagonal
    )
    return SimplexMesh(verts, cells, structure)


def create_unit_square(nx: int, ny: Optional[int] = None, diagonal="right") -> SimplexMesh:
    ny = nx if ny is None else ny
    return create_rectangle([[0.0, 0.0], [1.0, 1.0]], [nx, ny], diagonal)


# Kuhn triangulation of the unit cube into 6 tets: each tet is a chain
# 0 -> corner following a permutation of axis steps.
_KUHN_PERMS = [
    (0, 1, 2),
    (0, 2, 1),
    (1, 0, 2),
    (1, 2, 0),
    (2, 0, 1),
    (2, 1, 0),
]


def create_box(points, n) -> SimplexMesh:
    """Tetrahedral box [p0, p1] with n=(nx, ny, nz) grid intervals.

    Mirrors ``dolfinx.mesh.create_box`` (reference ``examples/hmm_3d.py:32``):
    every grid hexahedron is split into 6 tetrahedra (Kuhn triangulation),
    which yields a conforming mesh whose opposing faces have matching surface
    triangulations — required for the periodic slave→master vertex matching
    in the micro cell (reference ``cell_problem.py:139-300``).
    """
    (x0, y0, z0), (x1, y1, z1) = np.asarray(points, dtype=np.float64)
    nx, ny, nz = int(n[0]), int(n[1]), int(n[2])
    xs = np.linspace(x0, x1, nx + 1)
    ys = np.linspace(y0, y1, ny + 1)
    zs = np.linspace(z0, z1, nz + 1)
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    verts = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)

    def vid(ix, iy, iz):
        return (ix * (ny + 1) + iy) * (nz + 1) + iz

    ix, iy, iz = np.meshgrid(
        np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"
    )
    ix, iy, iz = ix.ravel(), iy.ravel(), iz.ravel()
    base = np.stack([ix, iy, iz], axis=1)  # (nb, 3)
    tets = []
    for perm in _KUHN_PERMS:
        corner = base.copy()
        chain = [corner.copy()]
        for axis in perm:
            corner = corner.copy()
            corner[:, axis] += 1
            chain.append(corner.copy())
        tet = np.stack(
            [vid(c[:, 0], c[:, 1], c[:, 2]) for c in chain], axis=1
        )  # (nb, 4)
        tets.append(tet)
    cells = np.stack(tets, axis=1).reshape(-1, 4)  # box-major, 6 tets each
    structure = BoxStructure(
        np.array([x0, y0, z0]), np.array([x1, y1, z1]), (nx, ny, nz), 6
    )
    return SimplexMesh(verts, cells, structure)


def create_unit_cube(nx: int, ny: Optional[int] = None, nz: Optional[int] = None) -> SimplexMesh:
    ny = nx if ny is None else ny
    nz = nx if nz is None else nz
    return create_box([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0]], [nx, ny, nz])
