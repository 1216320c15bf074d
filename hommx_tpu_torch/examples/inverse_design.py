#!/usr/bin/env python3
"""Inverse design through the differentiable HMM pipeline
(``examples/inverse_design.py``).

The whole two-scale solve — batched periodic cell problems,
homogenized-tensor contraction, macro assembly, macro solve — is one
differentiable function (``BaseHMM.build_pipeline``): every solve carries
the implicit-function rule (``ops/solvers.py::implicit_linear_solve``, one
extra solve in the backward pass), never an unrolled iteration history, so
autograd differentiates it exactly, twice over with ``create_graph=True``.

The demo recovers the micro-structure of a laminate from macro data:

  1. generate a target macro solution u* with inclusion contrast m* = 7,
  2. forget m*, start from m = 2, and run damped NEWTON on
         J(m) = ||u(m) - u*||²  /  ||u*||²
     with BOTH derivatives from autograd,
  3. recover m = m* in ~6 steps (textbook quadratic convergence).

    python3 -m hommx_tpu_torch.examples.inverse_design [--n 8] [--steps 12] [--m-true 7] [--m-init 2] [--device cpu]
"""

from __future__ import annotations

import time

import torch

from hommx_tpu_torch import PoissonHMM, create_unit_square
from hommx_tpu_torch.config import default_dtype
from hommx_tpu_torch.examples._common import parser

EPS = 0.1 / 8


def make_loss(macro, micro, u_target, device):
    """J(m), or with ``u_target`` None the forward map m -> u(m); the
    pipeline is rebuilt at every call, with m entering the coefficient."""

    def solve_for(m):
        # two-phase laminate in the fast variable; m = inclusion contrast
        def A(x, y):
            phase = 0.5 * (1.0 + torch.tanh(10.0 * torch.sin(2 * torch.pi * y[0])))
            return 1.0 + (m - 1.0) * phase

        hmm = PoissonHMM(macro, A, lambda x: 1.0, micro, EPS, device=device)
        step, centers = hmm.build_pipeline()
        return step(centers)

    if u_target is None:  # target-generation mode
        return solve_for

    def loss(m):
        u = solve_for(m)
        return torch.sum((u - u_target) ** 2) / torch.sum(u_target**2)

    return loss


def run(n: int = 8, steps: int = 12, m_true: float = 7.0, m_init: float = 2.0,
        device="cuda", out: str = ".") -> dict:
    """Run the damped Newton loop, print the example's lines and return
    the recovered ``m``, its relative error ``err``, the loss and ``m`` of
    each step, and the loop's seconds; raises AssertionError where ``err``
    is 1e-4 or more, as the example does.  ``out`` is accepted for the
    scripts' common signature: this example writes no file."""
    dtype = default_dtype(device)
    macro = create_unit_square(n, n)
    micro = create_unit_square(n, n)

    print(f"generating target at m* = {m_true} ...")
    with torch.no_grad():
        u_target = make_loss(macro, micro, None, device)(torch.tensor(m_true, dtype=dtype, device=device))

    loss = make_loss(macro, micro, u_target, device)
    # Optimize p = log m: the homogenized response saturates in the
    # contrast (harmonic-mean-like), so log-parameterization keeps the
    # problem well-scaled.  The loss is FLAT near the optimum (a 3% error
    # in m moves J by ~1e-4), so first-order methods crawl; instead run
    # damped NEWTON with the second derivative also computed by autograd
    # through the entire two-scale solver, implicit-rule solves and all.
    p = torch.log(torch.tensor(m_init, dtype=dtype, device=device))
    history = []
    t0 = time.perf_counter()
    for k in range(steps):
        th = p.clone().requires_grad_(True)
        J = loss(torch.exp(th))
        (g,) = torch.autograd.grad(J, th, create_graph=True)
        (h,) = torch.autograd.grad(g, th)
        J, g, h = J.detach(), g.detach(), h.detach()
        # damped Newton: trust the curvature where it is positive, fall
        # back to a bounded gradient step elsewhere
        dp = -g / torch.clamp(h, min=1e-12) if h > 1e-12 else -torch.sign(g) * 0.4
        p = p + torch.clamp(dp, -0.7, 0.7)
        history.append({"J": float(J), "m": float(torch.exp(p)), "g": float(g), "h": float(h)})
        print(f"step {k:3d}:  J = {float(J):.3e}   "
              f"m = {float(torch.exp(p)):.6f}")
        if float(torch.abs(dp)) < 1e-8:
            break
    dt = time.perf_counter() - t0

    m = float(torch.exp(p))
    err = abs(m - m_true) / m_true
    print(f"\nrecovered m = {m:.6f}  (true {m_true}, "
          f"rel err {err:.2e}) in {dt:.1f} s")
    assert err < 1e-4, "inverse design did not converge"
    print("OK")
    return {"m": m, "m_true": m_true, "err": err, "steps": history, "seconds": dt,
            "pngs": []}


def main(argv=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("--n", type=int, default=8, help="macro/micro grid n")
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--m-true", type=float, default=7.0)
    ap.add_argument("--m-init", type=float, default=2.0)
    args = ap.parse_args(argv)
    return run(args.n, args.steps, args.m_true, args.m_init, args.device, args.out)


if __name__ == "__main__":
    main()
