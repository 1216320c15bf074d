#!/usr/bin/env python3
"""Wavy-laminate diffusion with PoissonStratifiedHMM
(``examples/diffusion/laminate.py``): a sharp laminate coefficient
A(y) = 5 or 0.05 depending on sign(cos 2πy₀), deformed by
θ(x) = (x₁ − sin 2πx₀, x₀), with Darcy left/right boundary conditions.

    python3 -m hommx_tpu_torch.examples.diffusion.laminate [--quick] [--plot] [--device cpu] [--out DIR]

Note on Dθᵀ: the original reference example passes a (2,1) matrix, which
cannot typecheck in its own UFL forms.  Here, as in the JAX example, it is
the square Jacobian transpose of the θ above.
"""

from __future__ import annotations

import time

import torch

from hommx_tpu_torch import PoissonStratifiedHMM, create_unit_square
from hommx_tpu_torch.examples._common import close_figure, darcy_bcs, parser, png_path, two_phase
from hommx_tpu_torch.models.fem import fem_solve
from hommx_tpu_torch.ops.function_space import FunctionSpace
from hommx_tpu_torch.utils.plotting import func_to_png
from hommx_tpu_torch.utils.validation import relative_l2_vs_reference


def A(x, y):
    return two_phase(torch.cos(2 * torch.pi * y[0]) < 0, 5.0, 0.05, y)


def f(x):
    return 1.0


def theta(x):
    # Only θ₀ enters the physical coefficient (A depends on y₀ alone).  The
    # completion θ₁ = x₀ keeps det Dθ ≡ -1, so the deformed cell problem is
    # never degenerate.  (The reference's θ₁ = x₁ makes Dθ singular wherever
    # cos 2πx₀ = 0 — with a square map that degenerates the cell problem;
    # the homogenized tensor is independent of the completion since A is a
    # y₀-laminate.)
    return torch.stack([x[1] - torch.sin(2 * torch.pi * x[0]), x[0]])


def Dtheta(x):
    # Dθᵀ_ij = ∂θ_j/∂x_i for θ = (x₁ − sin 2πx₀, x₀)
    z, o = torch.zeros_like(x[0]), torch.ones_like(x[0])
    return torch.stack([torch.stack([-2 * torch.pi * torch.cos(2 * torch.pi * x[0]), o]),
                        torch.stack([o, z])])


eps = 2 ** (-5)


def run(quick: bool = False, plot: bool = False, device="cuda", out: str = ".") -> dict:
    """Solve, print the example's lines and return its numbers."""
    nx = 30
    msh = create_unit_square(nx, nx)
    msh_micro = create_unit_square(nx, nx)

    t0 = time.time()
    pshmm = PoissonStratifiedHMM(msh, A, f, msh_micro, eps, Dtheta, device=device)
    pshmm.set_boundary_conditions(darcy_bcs(pshmm.function_space))
    u_pshmm = pshmm.solve()
    t_hmm = time.time() - t0
    print(f"stratified HMM solve: {t_hmm:.2f}s")

    # Primary validation: the exact homogenized limit.  For a two-phase
    # laminate the effective tensor is closed-form (harmonic mean along the
    # layer normal n = ∇θ₀, arithmetic mean across), so the eps→0 limit
    # solution is computable without resolving the eps-oscillations.
    aa = 0.5 * (5.0 + 0.05)
    ah = 1.0 / (0.5 * (1 / 5.0 + 1 / 0.05))

    def Astar_exact(x):
        n = torch.stack([-2 * torch.pi * torch.cos(2 * torch.pi * x[0]), torch.ones_like(x[0])])
        nh = n / torch.linalg.norm(n)
        return aa * torch.eye(2, dtype=x.dtype, device=x.device) + (ah - aa) * torch.outer(nh, nh)

    N_ref = 2**7 if quick else 2**8
    ref = create_unit_square(N_ref, N_ref)
    V_ref = FunctionSpace(ref, 1)
    t0 = time.time()
    u_hom = fem_solve(V_ref, Astar_exact, f, darcy_bcs(V_ref), device=device)
    t_hom = time.time() - t0
    print(f"homogenized-limit FEM ({N_ref}^2): {t_hom:.2f}s")
    rel = relative_l2_vs_reference(u_pshmm, u_hom)
    print(f"relative L^2 error vs exact homogenized limit: {rel}")
    result = {"hmm_seconds": t_hmm, "N_ref": N_ref, "hom_seconds": t_hom, "rel": rel,
              "pngs": []}

    u_ref = u_hom
    if not quick:
        # Secondary (informational): the heterogeneous fine-mesh solve.  At
        # eps = 2⁻⁵ with contrast 100 the eps-gap itself is O(10%) and a
        # mesh resolving the discontinuous laminate needs ≳ 2¹⁰ cells/side,
        # so this number is NOT a convergence gate (the reference example
        # prints the same kind of number, ``laminate.py:230``).  It runs in
        # float64 on every device, as in the JAX example: rounded to
        # float32, this system alone moves u by 3e-3 and the number below
        # by 4e-3 (contrast 100 at 512²).
        N_het = 2**9
        het = create_unit_square(N_het, N_het)
        V_het = FunctionSpace(het, 1)
        t0 = time.time()
        u_het = fem_solve(V_het, lambda x: A(x, theta(x) / eps), f, darcy_bcs(V_het),
                          dtype=torch.float64, device=device)
        t_het = time.time() - t0
        print(f"heterogeneous fine FEM ({N_het}^2): {t_het:.2f}s")
        rel_het = relative_l2_vs_reference(u_pshmm, u_het)
        print(f"relative L^2 vs heterogeneous fine FEM (informational): {rel_het}")
        result.update(N_het=N_het, het_seconds=t_het, rel_het=rel_het)

    if plot:
        paths = [png_path(out, "diffusion_wavy_laminate_stratified_hmm.png"),
                 png_path(out, "diffusion_wavy_laminate_reference.png")]
        close_figure(func_to_png(paths[0][:-4], pshmm.function_space, u_pshmm,
                                 title="$u_{hmm}$"))
        close_figure(func_to_png(paths[1][:-4], V_ref, u_ref, title="$u_{ref}$"))
        print("wrote pngs")
        result["pngs"] += paths
    return result


def main(argv=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--plot", action="store_true")
    args = ap.parse_args(argv)
    return run(args.quick, args.plot, args.device, args.out)


if __name__ == "__main__":
    main()
