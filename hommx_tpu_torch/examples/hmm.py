#!/usr/bin/env python3
"""2D PoissonHMM on a 5x5 rectangle with Darcy-style left/right BCs,
compared against a fine-mesh FEM reference (``examples/hmm.py``).

    python3 -m hommx_tpu_torch.examples.hmm [--quick] [--plot] [--device cpu] [--out DIR]

--quick takes a 32² reference mesh in place of 128².
"""

from __future__ import annotations

import time

import torch

from hommx_tpu_torch import PoissonHMM, create_rectangle, create_unit_square
from hommx_tpu_torch.examples._common import close_figure, darcy_bcs, parser, png_path
from hommx_tpu_torch.models.fem import fem_solve
from hommx_tpu_torch.ops.function_space import FunctionSpace
from hommx_tpu_torch.utils.validation import relative_l2_vs_reference

eps = 1 / 2**5


def A(x, y):
    return 1.1 + x[0] + torch.sin(2 * torch.pi * y[0])


def f(x):
    return 0.0


def run(quick: bool = False, plot: bool = False, device="cuda", out: str = ".") -> dict:
    """Solve, print the example's lines and return its numbers."""
    N = 15
    msh = create_rectangle([[0, 0], [5, 5]], [N, N])
    msh_micro = create_unit_square(N, N)

    t0 = time.time()
    phmm = PoissonHMM(msh, A, f, msh_micro, eps, device=device)
    phmm.set_boundary_conditions(darcy_bcs(phmm.function_space))
    u_phmm = phmm.solve()
    t_hmm = time.time() - t0
    print(f"HMM solve: {t_hmm:.2f}s "
          f"({msh.num_cells} cells x {msh.dim} correctors)")

    N_ref = 2**5 if quick else 2**7
    ref = create_rectangle([[0, 0], [5, 5]], [N_ref, N_ref])
    V_ref = FunctionSpace(ref, 1)
    t0 = time.time()
    u_ref = fem_solve(V_ref, lambda x: A(x, x / eps), f, darcy_bcs(V_ref), device=device)
    t_ref = time.time() - t0

    rel = relative_l2_vs_reference(u_phmm, u_ref)
    print(f"relative error of hmm against FEM ref for {eps=}, N={N_ref} is {rel}")
    result = {"hmm_seconds": t_hmm, "num_cells": msh.num_cells, "correctors": msh.dim,
              "N_ref": N_ref, "fem_seconds": t_ref, "rel": rel, "pngs": []}

    if plot:
        path = png_path(out, "hmm_2d.png")
        close_figure(phmm.plot_solution(filename=path, title="$u_{hmm}$"))
        print(f"wrote {path}")
        result["pngs"].append(path)
    return result


def main(argv=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--plot", action="store_true")
    args = ap.parse_args(argv)
    return run(args.quick, args.plot, args.device, args.out)


if __name__ == "__main__":
    main()
