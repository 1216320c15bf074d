#!/usr/bin/env python3
"""Standalone periodic variational solves on the unit cell
(``examples/diffusion/periodic_cell_load.py``).

``MicroEngine.solve_periodic`` solves any periodic problem

    a(u, v) = ∫_Y ∇v · A(x₀, y) ∇u dy = ∫_Y f·v dy + ∫_Y g·∇v dy

on the unit cell, not just the HMM cell problems.  This example solves

  1. a manufactured periodic Poisson problem (f-load) and reports the
     O(h²) error sequence, and
  2. the HMM generator cell problem itself through the g-load form,
     verifying it reproduces the engine's corrector.

Both run in float64 on every device, as in the example (the per-cell
route: dense batched solves, no kernel).

    python3 -m hommx_tpu_torch.examples.diffusion.periodic_cell_load [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from hommx_tpu_torch import MicroEngine, create_unit_square
from hommx_tpu_torch.examples._common import parser


def run(device="cuda", out: str = ".") -> dict:
    """Solve, print the example's lines and return the error sequence
    (``errors``, by ``n``) and the generator cell's ``delta``.  ``out`` is
    accepted for the scripts' common signature: this example writes no
    file."""
    # 1. manufactured solution: -div(grad u) = f on the periodic cell
    print("periodic Poisson, u = sin(2πy₀)cos(2πy₁):")
    sizes, errors = (8, 16, 32, 64), []
    for n in sizes:
        eng = MicroEngine(create_unit_square(n), dtype=torch.float64, device=device)

        def f(y):
            return 8 * torch.pi**2 * torch.sin(2 * torch.pi * y[0]) * torch.cos(2 * torch.pi * y[1])

        u = eng.solve_periodic(lambda x, y: 1.0, rhs=f)
        verts = np.asarray(eng.mesh.vertices)
        ue = np.sin(2 * np.pi * verts[:, 0]) * np.cos(2 * np.pi * verts[:, 1])
        un = u.cpu().numpy().copy()
        un -= un.mean()
        ue -= ue.mean()
        err = np.linalg.norm(un - ue) / np.linalg.norm(ue)
        errors.append(float(err))
        print(f"  n={n:3d}: rel l2 error {err:.2e}")

    # 2. the HMM cell problem via the gradient load g = -A e₀
    eng = MicroEngine(create_unit_square(16), dtype=torch.float64, solver="pcg", device=device)

    def A(x, y):
        return 1.0 + 0.5 * torch.sin(2 * torch.pi * y[0])

    x0 = torch.zeros(2, dtype=torch.float64, device=device)

    def g(y):
        return -torch.stack([A(x0, y), torch.zeros_like(y[0])])

    u = eng.solve_periodic(A, grad_rhs=g, x_center=x0)
    _, X = eng.cell_tensor(eng.element_coeff(A, x0))
    red = np.asarray(eng.pmap.reduced_index)
    Xf = X.cpu().numpy()[red, 0].copy()
    un = u.cpu().numpy().copy()
    un -= un.mean()
    Xf -= Xf.mean()
    delta = float(np.max(np.abs(un - Xf)))
    print(
        "generator cell problem via grad_rhs: max |Δ| vs engine corrector "
        f"= {delta:.2e}"
    )
    return {"sizes": list(sizes), "errors": errors, "delta": delta, "pngs": []}


def main(argv=None) -> dict:
    args = parser(__doc__).parse_args(argv)
    return run(args.device, args.out)


if __name__ == "__main__":
    main()
