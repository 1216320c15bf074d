#!/usr/bin/env python3
"""3D rotated-fiber beam with LinearElasticityStratifiedHMM
(``examples/linear_elasticity/rotated_fibers.py``): a clamped
[0,1]x[0,0.4]x[0,0.1] beam with stiff circular fibers (μ = 100 inside,
0.001 outside) whose direction rotates from longitudinal to vertical with
height, via the stratified map γ(x₁) = π/2 · x₁ / W.

    python3 -m hommx_tpu_torch.examples.linear_elasticity.rotated_fibers [--quick] [--macro NX NY NZ] [--device cpu] [--out DIR]

Dθᵀ note: the original reference example ships a non-square (3,2) matrix
that cannot typecheck in its own UFL forms; as in the JAX example, this is
the square rotation R_γ in the (0,2) plane it gestures at (same dropped γ'
terms).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from hommx_tpu_torch import (
    LinearElasticityStratifiedHMM,
    create_box,
    create_unit_cube,
    dirichletbc,
)
from hommx_tpu_torch.examples._common import (
    circle_indicator,
    close_figure,
    parser,
    png_path,
    two_phase,
)
from hommx_tpu_torch.ops.function_space import boundary_dofs
from hommx_tpu_torch.utils.validation import hooke_tensor

L, W, H = 1.0, 0.4, 0.1
delta = W / L
g = 0.05 * delta**2
eps = 2 ** (-5)


def mu(x, y):
    # stiff fiber along y0, circular cross-section in the (y1, y2) plane
    return two_phase(circle_indicator(y[1], y[2]), 100.0, 0.001, y)


A_tensor = hooke_tensor(3, mu, lambda x, y: 1.0)


def Dtheta(x):
    """Square rotation in the (0,2) plane, γ from 0 (bottom) to π/2 (top)."""
    gamma = 0.5 * torch.pi * x[1] / W
    c, s = torch.cos(gamma), torch.sin(gamma)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    Dth = torch.stack([torch.stack([c, z, s]), torch.stack([z, o, z]),
                       torch.stack([-s, z, c])])
    return Dth.T


def f(x):
    return torch.stack([torch.zeros_like(x[0]), torch.zeros_like(x[0]),
                        torch.full_like(x[0], -g)])


def run(quick: bool = False, macro=None, device="cuda", out: str = ".") -> dict:
    """Solve, print the example's lines, write the warped plot and return
    the numbers."""
    macro_n = list(macro) if macro else ([10, 3, 3] if quick else [20, 6, 6])
    domain = create_box([[0, 0, 0], [L, W, H]], macro_n)
    cell_box = create_unit_cube(4)

    lehmm = LinearElasticityStratifiedHMM(domain, A_tensor, f, cell_box, eps, Dtheta,
                                          device=device)
    dofs = boundary_dofs(lehmm.function_space, lambda x: np.isclose(x[0], 0))
    lehmm.set_boundary_conditions(dirichletbc(np.zeros(3), dofs, lehmm.function_space))

    n_reduced = lehmm._engine.n_reduced
    print(f"macro cells: {domain.num_cells} "
          f"(= {domain.num_cells * 12} reference-equivalent cell solves), "
          f"micro reduced dofs: {n_reduced}")
    t0 = time.time()
    u = lehmm.solve()
    dt = time.time() - t0
    vals = u.array.detach().cpu().numpy().astype(np.float64).reshape(-1, 3)
    max_u, tip = float(np.abs(vals).max()), float(vals[:, 2].min())
    print(f"solve: {dt:.2f}s; max |u| = {max_u:.5f}, tip deflection u_z min = {tip:.5f}")
    if not np.isfinite(vals).all():
        raise FloatingPointError("the beam's displacement is not finite")

    # warped boundary-surface plot (reference pyvista warp_by_vector beam)
    path = png_path(out, "rotated_fibers.png")
    close_figure(lehmm.plot_solution(filename=path, warp=0.25,
                                     title="rotated-fiber beam, |u| (warped)"))
    print(f"wrote {path}")
    return {"num_cells": domain.num_cells, "n_reduced": n_reduced, "solve_seconds": dt,
            "max_u": max_u, "tip": tip, "pngs": [path]}


def main(argv=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--macro", type=int, nargs=3, default=None)
    args = ap.parse_args(argv)
    return run(args.quick, args.macro, args.device, args.out)


if __name__ == "__main__":
    main()
