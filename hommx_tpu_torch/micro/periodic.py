"""Periodic boundary identification on box micro meshes — numpy copy of
``hommx_tpu/micro/periodic.py`` (the numpy matcher; the port has no native
host runtime yet, ROADMAP A13).

Replaces dolfinx_mpc's MultiPointConstraint construction (reference
``cell_problem.py:16-300``).  The reference builds the slave→master map with
a hierarchy of face / edge / corner constraint calls (3 calls in 2D, 7 in 3D)
because dolfinx_mpc cannot nest constraints.  Here the same relation is one
rule: a vertex with any coordinate on a "hi" face maps to the vertex with
every such coordinate replaced by the matching "lo" value — faces, edges and
corners fall out of the single rule (the corner (1,..,1) maps straight to the
origin, exactly the workaround of ``cell_problem.py:123-135``).

Instead of constrained *assembly* (dolfinx_mpc assemble_matrix), the solver
uses constraint *elimination*: the reduced dof space simply drops slaves, and
the gradient operator scatters element contributions through
``reduced_index`` (see micro/engine.py).  Back-substitution is a gather.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from hommx_tpu_torch.meshes.simplex import SimplexMesh

__all__ = ["PeriodicMap", "build_periodic_map", "build_periodic_map_points"]


@dataclasses.dataclass(frozen=True)
class PeriodicMap:
    """Vertex-level periodic identification on a box mesh.

    Attributes:
        masters: (nv,) index of the master vertex (identity for non-slaves).
        is_slave: (nv,) bool.
        reduced_index: (nv,) id in the reduced vertex space [0, n_reduced);
            slaves share their master's id.
        n_reduced: number of reduced vertices.
    """

    masters: np.ndarray
    is_slave: np.ndarray
    reduced_index: np.ndarray
    n_reduced: int

    def expand(self, u_red: np.ndarray) -> np.ndarray:
        """Back-substitution: reduced vertex values -> full vertex values
        (replaces ``mpc.backsubstitution``, reference ``cell_problem.py:386``)."""
        return u_red[self.reduced_index]


def build_periodic_map(mesh: SimplexMesh, rtol: float = 1e-5, atol: float = 1e-8) -> PeriodicMap:
    """Build the slave→master vertex map for a box-shaped mesh.

    Box bounds are detected from the mesh coordinates (reference
    ``cell_problem.py:65-69``).  Opposing faces must carry matching vertex
    traces (true for all structured box meshes in this package); a slave with
    no matching master raises.
    """
    if mesh.dim == 1:
        raise ValueError("Periodic boundary conditions in 1d not implemented.")
    return build_periodic_map_points(mesh.vertices)


def build_periodic_map_points(
    points: np.ndarray, rtol: float = 1e-5, atol: float = 1e-8
) -> PeriodicMap:
    """Slave→master map for an arbitrary point set on a box (same fold rule).

    Used for P1 vertices and for P2 dof points (vertices + edge midpoints):
    an edge midpoint on a "hi" face folds to the matching "lo"-face midpoint
    by exactly the vertex rule, so higher-order periodic spaces need no new
    constraint machinery (contrast the reference's per-entity dolfinx_mpc
    call hierarchy, ``cell_problem.py:16-300``).
    """
    points = np.asarray(points, dtype=np.float64)
    n = points.shape[0]
    x = points
    lo = x.min(axis=0)
    hi = x.max(axis=0)
    span = hi - lo
    on_hi = np.isclose(x, hi[None, :], rtol=rtol, atol=atol)  # (n, d)
    is_slave = on_hi.any(axis=1)

    target = np.where(on_hi, lo[None, :], x)
    # match targets to points by quantized coordinates
    scale = np.where(span > 0, span, 1.0)
    key_of = lambda pts: [
        tuple(row) for row in np.round((pts - lo) / scale * 1e12).astype(np.int64)
    ]
    lookup = {k: i for i, k in enumerate(key_of(x))}
    masters = np.arange(n, dtype=np.int64)
    slave_ids = np.nonzero(is_slave)[0]
    for v in slave_ids:
        k = key_of(target[v : v + 1])[0]
        m = lookup.get(k)
        if m is None:
            raise ValueError(
                f"periodic master for point {v} at {x[v]} not found; "
                "micro mesh faces do not match periodically"
            )
        masters[v] = m

    return _finalize(n, masters, is_slave)


def _finalize(nv: int, masters: np.ndarray, is_slave: np.ndarray) -> PeriodicMap:
    slave_ids = np.nonzero(is_slave)[0]
    reduced_index = np.full(nv, -1, dtype=np.int64)
    keep = np.nonzero(~is_slave)[0]
    reduced_index[keep] = np.arange(keep.shape[0])
    reduced_index[slave_ids] = reduced_index[masters[slave_ids]]
    if (reduced_index < 0).any():  # a slave pointing at a slave cannot happen
        raise AssertionError("periodic reduction failed: unresolved slaves")
    return PeriodicMap(
        masters=masters,
        is_slave=is_slave,
        reduced_index=reduced_index,
        n_reduced=int(keep.shape[0]),
    )
