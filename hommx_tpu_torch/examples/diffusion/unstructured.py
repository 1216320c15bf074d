#!/usr/bin/env python3
"""PoissonHMM on an UNSTRUCTURED (Delaunay) macro mesh
(``examples/diffusion/unstructured.py``).

A jittered-grid Delaunay triangulation takes the aggregation-AMG macro
preconditioner (``ops/amg.py``) when the system is large enough for the CG
path, and the solution is validated against the structured-mesh solution
interpolated cross-mesh.

    python3 -m hommx_tpu_torch.examples.diffusion.unstructured [--n 72] [--device cpu]
"""

from __future__ import annotations

import time

import numpy as np
import torch

from hommx_tpu_torch import PoissonHMM, create_unit_square, mesh_from_delaunay
from hommx_tpu_torch.examples._common import parser
from hommx_tpu_torch.ops.interpolation import eval_p1

eps = 1 / 2**5


def A(x, y):
    return 1.1 + x[0] + torch.sin(2 * torch.pi * y[0])


def jittered_delaunay(n, jitter=0.25, seed=3):
    """The (n+1)² grid points of the unit square, the interior ones moved
    by up to ``jitter``/n in each coordinate (seeded), triangulated by
    Delaunay."""
    from scipy.spatial import Delaunay

    grid = np.linspace(0.0, 1.0, n + 1)
    X, Y = np.meshgrid(grid, grid, indexing="ij")
    pts = np.stack([X.reshape(-1), Y.reshape(-1)], axis=1)
    rng = np.random.default_rng(seed)
    interior = (
        (pts[:, 0] > 0) & (pts[:, 0] < 1) & (pts[:, 1] > 0) & (pts[:, 1] < 1)
    )
    pts[interior] += rng.uniform(-jitter, jitter, (int(interior.sum()), 2)) / n
    return mesh_from_delaunay(pts, Delaunay(pts).simplices)


def run(n: int = 72, device="cuda", out: str = ".") -> dict:
    """Solve on the jittered mesh and on the structured one, print the
    example's lines and return the numbers; raises AssertionError where
    the two differ by 5e-2 or more, as the example does.  ``out`` is
    accepted for the scripts' common signature: this example writes no
    file."""
    micro = create_unit_square(16, 16)
    macro_u = jittered_delaunay(n)
    assert macro_u.structure is None  # genuinely unstructured

    t0 = time.perf_counter()
    hmm = PoissonHMM(macro_u, A, lambda x: 1.0, micro, eps, device=device)
    u = hmm.solve()
    dt = time.perf_counter() - t0
    its = hmm.diagnostics["macro_iterations"]
    path = "AMG-preconditioned CG" if its else "dense direct (below cap)"
    print(f"unstructured solve: {dt:.2f} s, "
          f"{hmm.diagnostics['num_cells']} cells, "
          f"macro iterations {its} ({path})")

    # cross-check against the structured-mesh solution at the jittered nodes
    macro_s = create_unit_square(n, n)
    hmm_s = PoissonHMM(macro_s, A, lambda x: 1.0, micro, eps, device=device)
    u_s = hmm_s.solve()
    at_nodes = eval_p1(u_s, macro_u.vertices).numpy()
    u_nodes = u.array.detach().cpu().numpy().astype(np.float64)
    rel = float(np.linalg.norm(u_nodes - at_nodes) / np.linalg.norm(at_nodes))
    print(f"rel l2 vs structured-mesh solution at the jittered nodes: "
          f"{rel:.2e}")
    assert rel < 5e-2, rel
    return {"n": n, "dofs": macro_u.num_vertices, "solve_seconds": dt,
            "num_cells": hmm.diagnostics["num_cells"], "macro_iterations": its,
            "amg_levels": hmm.diagnostics["macro_amg_levels"], "rel": rel, "pngs": []}


def main(argv=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("--n", type=int, default=72,
                    help="macro grid resolution before jittering "
                         "(72 → 5329 dofs, above the direct cap → CG+AMG)")
    args = ap.parse_args(argv)
    return run(args.n, args.device, args.out)


if __name__ == "__main__":
    main()
