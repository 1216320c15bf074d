#!/usr/bin/env python3
"""How far a float32 macro system puts u from the answer of its A*.

    python3 tools/macro_rounding.py [--n 512] [--micro 8] [--device cuda]

Builds the flagship PoissonHMM (A = 1.1 + x₀ + sin 2πy₀, f = 1) on an n²
macro mesh in float32, takes its A*, and solves in float64 (multigrid CG to
1e-12) three macro systems assembled from it: in float64 (the answer), in
float64 rounded once to float32 (what ``assemble_macro_system`` stores on
the float32 CG path), and accumulated in float32 (the reference's float32
path).  Then the same with A* perturbed by 1e-6 relative noise (a seeded
draw), the size of the difference between two float32 micro stages.
Prints one JSON line: each system's max-norm relative distance to the
answer, and how far the perturbation moves each solution.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from hommx_tpu_torch import PoissonHMM, SolverOptions, create_unit_square  # noqa: E402
from hommx_tpu_torch.models.common import assemble_macro_system, merge_bcs  # noqa: E402
from hommx_tpu_torch.ops import solvers  # noqa: E402
from hommx_tpu_torch.ops.assembly import apply_dirichlet, assemble_ell  # noqa: E402


def rel(u, v) -> float:
    return float((u - v).abs().max() / v.abs().max())


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--micro", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)

    A = lambda x, y: 1.1 + x[0] + torch.sin(2 * torch.pi * y[0])  # noqa: E731
    hmm = PoissonHMM(create_unit_square(args.n), A, 1.0, create_unit_square(args.micro), 2**-5,
                     SolverOptions(rtol=1e-5), dtype=torch.float32, device=dev)
    hmm.solve()
    sys_ = hmm._sys
    A32 = hmm.homogenized_tensors()
    g = torch.Generator(device=dev).manual_seed(0)
    A32p = A32 * (1 + 1e-6 * torch.randn(A32.shape, generator=g, device=dev))
    mask, bvals = merge_bcs(hmm._bcs, hmm.function_space.num_dofs, torch.float64, dev)
    opts = SolverOptions(rtol=1e-12, atol=0.0, maxiter=20000)

    def solve(vals, b):
        x, _, _ = solvers.solve_ell(vals.double(), sys_.cols, b.double(), opts,
                                    dia=sys_.dia, mg=sys_.mg)
        return x

    def f64(Ast):
        return solve(*assemble_macro_system(sys_, Ast, hmm._b_load, mask, bvals, macro_f64=True))

    def rounded_once(Ast):
        return solve(*assemble_macro_system(sys_, Ast, hmm._b_load, mask, bvals, macro_f64=False))

    def accumulated_f32(Ast):
        f32 = torch.float32
        S = torch.einsum("c,cad,cde,cbe->cab", sys_.vols, sys_.grads,
                         Ast.transpose(-1, -2), sys_.grads)
        vals = assemble_ell(sys_.pattern, S, sys_.slots)
        return solve(*apply_dirichlet(vals, sys_.cols, sys_.diag_slots,
                                      hmm._b_load.to(f32), mask, bvals.to(f32), dia=sys_.dia))

    x64 = f64(A32)
    out = {"n": args.n, "micro": args.micro, "device": str(dev),
           "device_name": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}
    for name, fn in (("f64", f64), ("rounded_once", rounded_once),
                     ("accumulated_f32", accumulated_f32)):
        x = fn(A32)
        out[f"{name}_rel_diff_to_answer"] = rel(x, x64)
        out[f"{name}_moved_by_1e-6_astar_noise"] = rel(fn(A32p), x)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
