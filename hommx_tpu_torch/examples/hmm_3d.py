#!/usr/bin/env python3
"""3D PoissonHMM on the unit cube vs a fine FEM reference
(``examples/hmm_3d.py``: N = 6 macro and micro, eps = 2⁻³, a 2⁶ reference
cube by default, 2⁴ with --quick).

    python3 -m hommx_tpu_torch.examples.hmm_3d [--quick] [--device cpu] [--out DIR]
"""

from __future__ import annotations

import time

import torch

from hommx_tpu_torch import PoissonHMM, create_unit_cube
from hommx_tpu_torch.examples._common import close_figure, parser, png_path
from hommx_tpu_torch.models.fem import fem_solve
from hommx_tpu_torch.ops.function_space import FunctionSpace, boundary_dofs, dirichletbc
from hommx_tpu_torch.utils.validation import relative_l2_vs_reference

eps = 1 / 2**3


def A(x, y):
    return 1.1 + x[0] + torch.sin(2 * torch.pi * y[0])


def f(x):
    return 1.0


def run(quick: bool = False, device="cuda", out: str = ".") -> dict:
    """Solve, print the example's lines, write the plot and return the
    numbers; ``fem`` holds the fine FEM's diagnostics (set-up, assembly
    and solve seconds, CG iterations and loop steps, multigrid grids)."""
    N = 6
    msh = create_unit_cube(N)
    msh_micro = create_unit_cube(N)
    phmm = PoissonHMM(msh, A, f, msh_micro, eps, device=device)
    n_reduced = phmm._engine.n_reduced
    print(f"macro cells: {msh.num_cells}, micro reduced dofs: {n_reduced}")

    t0 = time.time()
    u_phmm = phmm.solve()
    t_hmm = time.time() - t0
    print(f"HMM solve: {t_hmm:.2f}s")

    N_ref = 2**4 if quick else 2**6
    ref = create_unit_cube(N_ref)
    V_ref = FunctionSpace(ref, 1)
    bcs = [dirichletbc(0.0, boundary_dofs(V_ref), V_ref)]
    t0 = time.time()
    u_ref = fem_solve(V_ref, lambda x: A(x, x / eps), f, bcs, device=device)
    t_ref = time.time() - t0
    print(f"fine FEM ({N_ref}^3): {t_ref:.2f}s")

    rel = relative_l2_vs_reference(u_phmm, u_ref)
    print(f"relative error of hmm against FEM ref for {eps=}, {N=}, {N_ref=} is {rel}")

    # 3D boundary-surface plot (reference pyvista plot, hmm.py:493-511)
    path = png_path(out, "hmm_3d.png")
    close_figure(phmm.plot_solution(filename=path, title="3D Poisson HMM solution"))
    print(f"wrote {path}")
    mg = u_ref.system.mg if u_ref.macro_method == "cg" else None
    fem = {**u_ref.diagnostics, "dofs": V_ref.num_dofs, "method": u_ref.macro_method,
           "iterations": u_ref.solver_iterations,
           "mg_grids": None if mg is None else [list(lev.grid) for lev in mg.levels]}
    return {"num_cells": msh.num_cells, "n_reduced": n_reduced, "hmm_seconds": t_hmm,
            "N_ref": N_ref, "fem_seconds": t_ref, "rel": rel, "fem": fem, "pngs": [path]}


def main(argv=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args(argv)
    return run(args.quick, args.device, args.out)


if __name__ == "__main__":
    main()
