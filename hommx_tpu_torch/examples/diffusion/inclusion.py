#!/usr/bin/env python3
"""Wavy circular-inclusion diffusion with PoissonStratifiedHMM
(``examples/diffusion/inclusion.py``): periodic circular inclusions
A = 0.001 inside / 0.1 outside a radius-1/4 disk, deformed by
θ(x) = (x₀ + ½ sin 2πx₁, x₁).

    python3 -m hommx_tpu_torch.examples.diffusion.inclusion [--quick] [--plot] [--device cpu] [--out DIR]

--quick takes a 128² reference mesh in place of 512².
"""

from __future__ import annotations

import time

import torch

from hommx_tpu_torch import PoissonStratifiedHMM, create_unit_square
from hommx_tpu_torch.examples._common import (
    circle_indicator,
    close_figure,
    darcy_bcs,
    parser,
    png_path,
    two_phase,
)
from hommx_tpu_torch.models.fem import fem_solve
from hommx_tpu_torch.ops.function_space import FunctionSpace
from hommx_tpu_torch.utils.plotting import func_to_png
from hommx_tpu_torch.utils.validation import relative_l2_vs_reference


def A(x, y):
    return two_phase(circle_indicator(y[0], y[1]), 0.001, 0.1, y)


def f(x):
    return 1.0


def theta(x):
    return torch.stack([x[0] + 0.5 * torch.sin(2 * torch.pi * x[1]), x[1]])


def Dtheta(x):
    # Dθᵀ_ij = ∂θ_j/∂x_i
    z, o = torch.zeros_like(x[0]), torch.ones_like(x[0])
    return torch.stack([torch.stack([o, z]),
                        torch.stack([0.5 * 2 * torch.pi * torch.cos(2 * torch.pi * x[1]), o])])


eps = 2 ** (-5)


def run(quick: bool = False, plot: bool = False, device="cuda", out: str = ".") -> dict:
    """Solve, print the example's lines and return its numbers."""
    nx = 30
    msh = create_unit_square(nx, nx)
    msh_micro = create_unit_square(nx, nx)

    t0 = time.time()
    pshmm = PoissonStratifiedHMM(msh, A, f, msh_micro, eps, Dtheta, quad_degree_micro=2,
                                 device=device)
    pshmm.set_boundary_conditions(darcy_bcs(pshmm.function_space))
    u_pshmm = pshmm.solve()
    t_hmm = time.time() - t0
    print(f"stratified HMM solve: {t_hmm:.2f}s")

    N_ref = 2**7 if quick else 2**9
    ref = create_unit_square(N_ref, N_ref)
    V_ref = FunctionSpace(ref, 1)
    t0 = time.time()
    u_ref = fem_solve(V_ref, lambda x: A(x, theta(x) / eps), f, darcy_bcs(V_ref),
                      device=device)
    t_ref = time.time() - t0
    print(f"fine FEM ({N_ref}^2): {t_ref:.2f}s")

    rel = relative_l2_vs_reference(u_pshmm, u_ref)
    print(f"relative L^2 error is: {rel}")
    result = {"hmm_seconds": t_hmm, "N_ref": N_ref, "fem_seconds": t_ref, "rel": rel,
              "pngs": []}

    if plot:
        path = png_path(out, "diffusion_wavy_inclusion_stratified_hmm.png")
        close_figure(func_to_png(path[:-4], pshmm.function_space, u_pshmm, title="$u_{hmm}$"))
        print("wrote png")
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
