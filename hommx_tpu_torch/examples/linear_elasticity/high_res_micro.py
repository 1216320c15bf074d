#!/usr/bin/env python3
"""High-resolution micro cells for elasticity: the matrix-free route
(``examples/linear_elasticity/high_res_micro.py``).

A stiff-fiber unit cell (μ = 100 in the fiber, 0.001 outside, contrast
1e5) is resolved at 4³ and 8³ on the engine's default route (the chunk
Cholesky: on the card K3's small and then its large instance) and at
``--n`` (default 16) on the matrix-free torus-multigrid route
(``solver='pcg', pcg_strategy='matfree', cell_prec='mg'``), which never
forms a dense operator or a dense K₀ inverse.  The homogenized tensor's
moves along the sequence show micro-mesh convergence.

    python3 -m hommx_tpu_torch.examples.linear_elasticity.high_res_micro [--n 16] [--device cpu]

The multigrid step runs in float64 on every device, as the JAX example
does: in float32 its lockstep PCG stalls short of the example's
tolerance of 1e-7.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from hommx_tpu_torch import MicroEngine, create_unit_cube
from hommx_tpu_torch.examples._common import circle_indicator, parser, two_phase
from hommx_tpu_torch.utils.validation import hooke_tensor


def mu(x, y):
    return two_phase(circle_indicator(y[1], y[2]), 100.0, 0.001, y)


A_el = hooke_tensor(3, mu, lambda x, y: 1.0)


def run(n: int = 16, device="cuda", out: str = ".") -> dict:
    """The micro-mesh sequence (4, 8, ``n``): print the example's lines and
    return one row a step (``A``: the 6x6 tensor; ``A11``, ``A22``,
    ``seconds``, ``delta``: the move against the previous step, None
    first).  ``out`` is accepted for the scripts' common signature: this
    example writes no file."""
    prev, rows = None, []
    for m in (4, 8, n):
        t0 = time.perf_counter()
        if m <= 8:
            eng = MicroEngine(create_unit_cube(m), bs=3, coeff_kind="tensor4",
                              device=device)  # batched-Cholesky default
        else:
            eng = MicroEngine(create_unit_cube(m), bs=3, coeff_kind="tensor4",
                              solver="pcg", pcg_strategy="matfree", cell_prec="mg",
                              mg_nu=8, pcg_tol=1e-7, pcg_maxiter=4000,
                              dtype=torch.float64, device=device)
        center = torch.full((1, 3), 0.5, dtype=eng.dtype, device=device)
        A = eng.tensors_for_centers(A_el, center)[0].cpu().numpy().astype(np.float64)
        dt = time.perf_counter() - t0
        d = A.diagonal()
        delta = None if prev is None else float(np.max(np.abs(A - prev)) / np.max(np.abs(A)))
        move = "" if prev is None else f"  Δ vs previous {delta:.3e}"
        print(
            f"micro {m:>2}³: A*₁₁ = {d[0]:.4f}, A*₂₂ = {d[4]:.3e} "
            f"({dt:6.1f} s){move}"
        )
        rows.append({"n": m, "dtype": str(eng.dtype), "solver": eng.solver,
                     "cell_prec": eng.cell_prec, "A": A.tolist(), "A11": float(d[0]),
                     "A22": float(d[4]), "seconds": dt, "delta": delta})
        prev = A
    return {"rows": rows, "pngs": []}


def main(argv=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("--n", type=int, default=16, help="finest micro n")
    args = ap.parse_args(argv)
    return run(args.n, args.device, args.out)


if __name__ == "__main__":
    main()
