"""Static operator construction for the micro engine (torch port of
``hommx_tpu/micro/percell.py::build_operators``, scalar P1 branch).

Runs once at engine construction on the host: the per-element gradient
operators, the reduced dof map, the generator fields and the nullspace
pinning.  The per-cell solve route (``cell_tensor``) is not ported yet
(ROADMAP A9).
"""

from __future__ import annotations

import numpy as np
import torch

from hommx_tpu_torch.ops.elements import cell_geometry, quad_points_physical

__all__ = ["build_operators"]


def build_operators(eng):
    mesh, d = eng.mesh, eng.d
    # geometry in f64 regardless of the compute dtype: quadrature-point
    # coordinates feed the user coefficient, and discontinuous
    # coefficients are knife-edge sensitive to point placement
    verts = torch.as_tensor(mesh.vertices, dtype=torch.float64)
    cells = torch.as_tensor(mesh.cells)
    grads, _ = cell_geometry(verts, cells)  # (ne, d+1, d)
    xq, wq, _ = quad_points_physical(verts, cells, eng.quad_degree)
    ne, nq = wq.shape
    grads_np = grads.numpy()

    red = eng.pmap.reduced_index  # (nv,)
    node_cells = mesh.cells  # (ne, d+1)
    nbl = node_cells.shape[1]
    eng.nbl = nbl

    # local gradient operator Draw: (ne, r, nbl) — P1 gradients are
    # elementwise constant, so quadrature folds into the element coefficient
    Draw = np.zeros((ne, eng.r, nbl), dtype=np.float64)
    for a in range(d + 1):
        Draw[:, :, a] = grads_np[:, a, :]
    eng.yq = xq.numpy()  # (ne, nq, d) quadrature points (f64)
    eng.wq = wq.numpy()  # (ne, nq) weights, sum = |Y|
    eng.nE, eng.nq = ne, nq
    eng.Draw_np = Draw
    eng.Draw = torch.as_tensor(Draw, dtype=eng.dtype, device=eng.device)

    loc2red = red[node_cells]  # (ne, nbl)
    eng.loc2red_np = loc2red
    eng.loc2red = torch.as_tensor(loc2red, device=eng.device)

    nred = eng.n_reduced
    # dense reduced gradient operator D (ne, r, nred), shared by all cells
    if ne * eng.r * nred <= 5e7:
        D = np.zeros((ne, eng.r, nred), dtype=np.float64)
        e_idx = np.arange(ne)[:, None, None]
        r_idx = np.arange(eng.r)[None, :, None]
        np.add.at(D, (e_idx, r_idx, loc2red[:, None, :]), Draw)
        eng.D_np = D
        eng.D = torch.as_tensor(D, dtype=eng.dtype, device=eng.device)
    else:
        eng.D_np = eng.D = None
    if eng.assembly == "dense" and eng.D is None:
        raise ValueError("dense assembly requested but operator too large")

    eng.E = torch.eye(d, dtype=eng.dtype, device=eng.device)  # generators (r, s)

    # nullspace pinning: the dof of reduced vertex 0
    pin = np.zeros(nred, dtype=bool)
    pin[:1] = True
    eng.pin_np = pin
    eng.pin_mask = torch.as_tensor(pin, device=eng.device)
    # quadrature COORDINATES stay f64; everything downstream of coefficient
    # VALUES uses the compute dtype
    eng.yq_dev = torch.as_tensor(eng.yq, dtype=torch.float64, device=eng.device)
    eng.wq_dev = torch.as_tensor(eng.wq, dtype=eng.dtype, device=eng.device)
    eng._get_K0inv()  # built eagerly on the host
