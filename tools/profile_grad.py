#!/usr/bin/env python3
"""Where the time of a gradient through the hommx_tpu_torch pipeline goes,
on one NVIDIA GPU.

    python3 tools/profile_grad.py [--macro 512] [--micro 16] [--out FILE]

Run from the repository root on a machine with one CUDA card; it fails
without one.  It drives ``chip_smoke.py``'s ``pipeline_grad`` configuration
(PoissonHMM.build_pipeline on the flagship with a parameter, A = 1.1 + θx₀
+ sin 2πy₀, float32, default options, J = Σu²) and prints one JSON line per
measurement; the full records go to ``--out`` (default
``chiprun_out/profile_grad.json``):

- ``passes``: host-clock seconds of a cold forward and backward pass, then
  of three warm ones, each beside a forward with grad mode off (the
  forward alone, as ``solve()`` runs it);
- ``profile``: ``torch.profiler`` over one warm forward and, separately,
  its backward: wall seconds, device busy seconds (union of the device's
  kernel and copy intervals), idle share of the wall, kernel launches of
  K1 and K2, top kernels by device time and top host operators by self
  time.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def top_host_ops(prof, k: int = 10) -> list:
    """The ``k`` host operators with the most self time: [name, calls, ms]."""
    rows = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:k]
    return [[e.key[:80], e.count, round(e.self_cpu_time_total / 1e3, 3)] for e in rows]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--macro", type=int, default=512)
    ap.add_argument("--micro", type=int, default=16)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "profile_grad.json"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_grad: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tools"))
    from chip_smoke import _theta_flagship, emit, phase_build, phase_device
    from profile_slice import device_busy

    from hommx_tpu_torch import PoissonHMM, create_unit_square
    from hommx_tpu_torch.micro import stencil_pcg
    from hommx_tpu_torch.ops import dia

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    records = []

    def keep(rec):
        emit(rec)
        records.append(rec)

    name, smi = phase_device()
    records.append({"device": name, "nvidia_smi": smi})
    phase_build()
    kernels = {"stencil_pcg": stencil_pcg.KERNEL, "dia_spmv": dia.KERNEL}

    holder = [1.0]
    hmm = PoissonHMM(create_unit_square(args.macro), _theta_flagship(holder), lambda x: 1.0,
                     create_unit_square(args.micro), 2**-5, dtype=torch.float32,
                     device=device, dedup_cells=False)
    step, centers = hmm.build_pipeline()
    theta = torch.tensor(1.0, device=device, requires_grad=True)

    def forward():
        holder[0] = theta
        return (step(centers).double() ** 2).sum()

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    for rep in ("cold", "warm", "warm", "warm"):
        with torch.no_grad():
            _, t_nograd = timed(forward)
        J, t_fwd = timed(forward)
        _, t_bwd = timed(lambda: torch.autograd.grad(J, theta))
        keep({"tag": "passes", "rep": rep, "forward_no_grad_s": t_nograd,
              "forward_s": t_fwd, "backward_s": t_bwd})
        del J

    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    box = {}
    for stage in ("forward", "backward"):
        for k in kernels.values():
            k.reset_counts()
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            if stage == "forward":
                box["J"] = forward()
            else:
                torch.autograd.grad(box.pop("J"), theta)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy, span, n, top = device_busy(prof)
        keep({"tag": "profile", "stage": stage, "wall_s": wall, "device_busy_s": busy,
              "kernel_span_s": span, "idle_share_of_wall": 1.0 - busy / wall,
              "n_device_events": n,
              "launches": {k: v.launches for k, v in kernels.items()},
              "top": top, "top_host_ops": top_host_ops(prof)})
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(records, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
