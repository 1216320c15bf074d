"""Point evaluation of P1/P2 functions and cross-mesh interpolation (torch
port of ``hommx_tpu/ops/interpolation.py``).

Point → cell location is analytic on structured box meshes (the grid box
and the simplex within it follow from local coordinates); unstructured
meshes take a host-side uniform-grid binning search, in the native host
runtime (``hommx_tpu_torch/native``) or in numpy.  Host arrays throughout.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from hommx_tpu_torch import native
from hommx_tpu_torch.meshes.simplex import _KUHN_PERMS, SimplexMesh

__all__ = ["locate_cells", "eval_p1", "interpolate_nonmatching"]

_PERM_INDEX = {perm: i for i, perm in enumerate(_KUHN_PERMS)}


def locate_cells(mesh: SimplexMesh, points: np.ndarray) -> np.ndarray:
    """Cell index containing each point (clamped to the domain)."""
    points = np.asarray(points, dtype=np.float64)
    if mesh.structure is not None:
        return _locate_structured(mesh, points)
    return _locate_binned(mesh, points)


def _locate_structured(mesh: SimplexMesh, points: np.ndarray) -> np.ndarray:
    st = mesh.structure
    d = mesh.dim
    n = np.asarray(st.shape)
    h = (st.hi - st.lo) / n
    rel = (points - st.lo) / h  # grid coordinates
    idx = np.clip(np.floor(rel).astype(np.int64), 0, n - 1)
    loc = np.clip(rel - idx, 0.0, 1.0)  # local coordinates in the box
    if d == 2:
        box = idx[:, 0] * n[1] + idx[:, 1]
        if st.diagonal == "right":
            # t0 = (v00, v10, v11): below the (0,0)->(1,1) diagonal
            tri = np.where(loc[:, 0] >= loc[:, 1], 0, 1)
        else:
            # t0 = (v00, v10, v01): below the (1,0)->(0,1) diagonal
            tri = np.where(loc[:, 0] + loc[:, 1] <= 1.0, 0, 1)
        return (box * 2 + tri).astype(np.int32)
    box = (idx[:, 0] * n[1] + idx[:, 1]) * n[2] + idx[:, 2]
    order = np.argsort(-loc, axis=1, kind="stable")  # descending coordinate order
    perm_idx = np.array([_PERM_INDEX[tuple(o)] for o in order], dtype=np.int64)
    return (box * 6 + perm_idx).astype(np.int32)


def _barycentric(cell_pts: np.ndarray, pt: np.ndarray) -> np.ndarray:
    T = (cell_pts[1:] - cell_pts[0]).T
    xi = np.linalg.solve(T, pt - cell_pts[0])
    return np.concatenate([[1.0 - xi.sum()], xi])


def _locate_binned(mesh: SimplexMesh, points: np.ndarray) -> np.ndarray:
    """Uniform-grid binning point location for unstructured meshes: the
    native host runtime where it is built and not switched off, else
    :func:`_locate_binned_numpy`.  The two bin the cells differently, so a
    point on a face shared by two cells may be given either."""
    res = native.locate_cells_native(mesh.vertices, mesh.cells, points)
    if res is not None:
        return res
    return _locate_binned_numpy(mesh, points)


def _locate_binned_numpy(mesh: SimplexMesh, points: np.ndarray) -> np.ndarray:
    """The cell of the point's bin whose barycentric coordinates are least
    negative (every cell where the bin is empty)."""
    native.note("locate_cells", "numpy")
    d = mesh.dim
    lo, hi = mesh.bounding_box()
    span = np.where(hi - lo > 0, hi - lo, 1.0)
    nb = max(1, int(round(mesh.num_cells ** (1.0 / d) / 2)))
    cellsv = mesh.vertices[mesh.cells]  # (nc, d+1, d)
    cmin = ((cellsv.min(axis=1) - lo) / span * nb).astype(np.int64).clip(0, nb - 1)
    cmax = ((cellsv.max(axis=1) - lo) / span * nb).astype(np.int64).clip(0, nb - 1)
    buckets: dict = {}
    for c in range(mesh.num_cells):
        for key in itertools.product(*[range(cmin[c, k], cmax[c, k] + 1) for k in range(d)]):
            buckets.setdefault(key, []).append(c)
    pkey = ((points - lo) / span * nb).astype(np.int64).clip(0, nb - 1)
    out = np.zeros(points.shape[0], dtype=np.int32)
    for i, pt in enumerate(points):
        cand = buckets.get(tuple(pkey[i])) or range(mesh.num_cells)
        best, best_viol = 0, np.inf
        for c in cand:
            viol = -min(_barycentric(mesh.vertices[mesh.cells[c]], pt).min(), 0.0)
            if viol < best_viol:
                best, best_viol = c, viol
                if viol <= 1e-12:
                    break
        out[i] = best
    return out


def eval_p1(func, points, cells=None) -> torch.Tensor:
    """Evaluate a P1/P2 Function at arbitrary points (np, d) -> (np,) or
    (np, bs), on the host in float64.  With ``cells`` given, each point
    takes the polynomial of its cell even outside it (the macro -> micro
    interpolation's semantics)."""
    V = func.space
    mesh = V.mesh
    points = np.asarray(points, dtype=np.float64)[:, : mesh.dim]
    if cells is None:
        cells = locate_cells(mesh, points)
    cp = mesh.vertices[mesh.cells[cells]]  # (np, d+1, d)
    T = np.swapaxes(cp[:, 1:, :] - cp[:, :1, :], 1, 2)
    xi = np.linalg.solve(T, (points - cp[:, 0, :])[..., None])[..., 0]
    lam = np.concatenate([1.0 - xi.sum(axis=1, keepdims=True), xi], axis=1)
    if V.degree == 1:
        basis = lam
    else:
        from hommx_tpu_torch.ops.p2 import EDGE_PAIRS

        phi_e = np.stack([4.0 * lam[:, i] * lam[:, j] for (i, j) in EDGE_PAIRS[mesh.dim]],
                         axis=1)
        basis = np.concatenate([lam * (2.0 * lam - 1.0), phi_e], axis=1)
    uv = func.array.detach().cpu().numpy().astype(np.float64).reshape(-1, V.bs)
    vals = np.einsum("pa,pab->pb", basis, uv[V.cell_nodes()[cells]])
    return torch.as_tensor(vals if V.bs > 1 else vals[:, 0])


def interpolate_nonmatching(V_to, func_from):
    """Nodal interpolation of a P1/P2 function onto another P1/P2 space (the
    function evaluated at every node of ``V_to``), as a float64 Function
    on the host."""
    from hommx_tpu_torch.ops.function_space import Function

    vals = eval_p1(func_from, V_to.tabulate_dof_coordinates())
    return Function(V_to, vals.reshape(-1))
