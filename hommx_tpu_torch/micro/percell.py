"""Static operator construction for the micro engine (torch port of
``hommx_tpu/micro/percell.py::build_operators``, P1 branch, scalar and
vector dofs).

Runs once at engine construction on the host: the per-element gradient
operators, the reduced dof map, the generator fields (the Voigt set for
elasticity) and the nullspace pinning.  The per-cell solve route
(``cell_tensor``) is not ported yet (ROADMAP A9).
"""

from __future__ import annotations

import numpy as np
import torch

from hommx_tpu_torch.micro.engine import _sym_map
from hommx_tpu_torch.ops.elements import cell_geometry, quad_points_physical

__all__ = ["build_operators"]


def build_operators(eng):
    mesh, d, bs = eng.mesh, eng.d, eng.bs
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
    nbl = node_cells.shape[1] * bs  # local dofs per micro element
    eng.nbl = nbl

    # local gradient operator Draw: (ne, r, nbl) — P1 gradients are
    # elementwise constant, so quadrature folds into the element coefficient
    Draw = np.zeros((ne, eng.r, nbl), dtype=np.float64)
    for a in range(d + 1):
        if bs == 1:
            Draw[:, :, a] = grads_np[:, a, :]
        else:
            for i in range(bs):
                # component i of vector dof (a, i) contributes grad_a[j] to
                # gradient entry H_ij (row i*d + j)
                Draw[:, i * d : (i + 1) * d, a * bs + i] = grads_np[:, a, :]
    eng.yq = xq.numpy()  # (ne, nq, d) quadrature points (f64)
    eng.wq = wq.numpy()  # (ne, nq) weights, sum = |Y|
    eng.nE, eng.nq = ne, nq
    eng.Draw_np = Draw
    eng.Draw = torch.as_tensor(Draw, dtype=eng.dtype, device=eng.device)

    # local -> reduced dof map (ne, nbl)
    red_cells = red[node_cells]  # (ne, d+1)
    if bs == 1:
        loc2red = red_cells
    else:
        comp = np.arange(bs)
        loc2red = (red_cells[:, :, None] * bs + comp[None, None, :]).reshape(ne, nbl)
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

    # generator fields E: (r, s) — the Voigt set for elasticity (the
    # distinct symmetrized generators), with the map back to the full
    # (k·d + l) column layout
    if bs == 1:
        E = np.eye(d)
        eng.sym_expand = None
    else:
        pairs = [(k, l) for k in range(d) for l in range(k, d)]
        E = np.zeros((d * d, len(pairs)))
        for j, (k, l) in enumerate(pairs):
            Ekl = np.zeros((d, d))
            Ekl[k, l] += 0.5
            Ekl[l, k] += 0.5
            E[:, j] = Ekl.reshape(-1)
        eng.sym_expand = np.asarray(
            [pairs.index((min(k, l), max(k, l))) for k in range(d) for l in range(d)]
        )
    eng.E_np = E
    eng.E = torch.as_tensor(E, dtype=eng.dtype, device=eng.device)

    # nullspace pinning: the bs dofs of reduced vertex 0
    pin = np.zeros(nred, dtype=bool)
    pin[:bs] = True
    eng.pin_np = pin
    eng.pin_mask = torch.as_tensor(pin, device=eng.device)
    # quadrature COORDINATES stay f64; everything downstream of coefficient
    # VALUES uses the compute dtype
    eng.yq_dev = torch.as_tensor(eng.yq, dtype=torch.float64, device=eng.device)
    eng.wq_dev = torch.as_tensor(eng.wq, dtype=eng.dtype, device=eng.device)
    eng._eye_sym = (
        _sym_map(torch.eye(d, dtype=eng.dtype, device=eng.device)) if bs > 1 else None
    )
    # built eagerly on the host: K0⁻¹ for the PCG's preconditioner, diag(K0)
    # for the Cholesky route's equilibration
    if eng.solver == "pcg":
        eng._get_K0inv()
    else:
        eng._get_K0diag()
