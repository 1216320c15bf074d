"""The readings that a cell's check limits are set from, in one process:

    python3 -m portbench.control --workload <cell> --seeds <n> [<n> ...] [--solves 3]

For each seed it drives the cell's own step at its own size through
``--solves`` solves of the seed's θ sequence (the run's warm-up solves
first), then computes the check's numbers twice on the same sample: with
the program's outputs (the lower reading) and with the reference in TF32
put in the program's place (the control, the upper reading).  One JSON line
a seed, then a summary line: the largest program reading and the smallest
control reading of each number.  The benchmark's own runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

__all__ = ["readings"]


def readings(cell, seeds, solves: int = 3, device="cuda", emit=print) -> dict:
    """{"program": {number: largest}, "control": {number: smallest}} over
    ``seeds``."""
    import importlib

    import torch

    from portbench.check import check
    from portbench.families.common import AstarProbe
    from portbench.harness import WARMUP

    device = torch.device(device)
    cfg = cell.config
    family = importlib.import_module(f"portbench.families.{cfg['family']}")
    theta = torch.zeros((), dtype=torch.float64, device=device)
    system = family.build(cfg, device, theta)
    probe = AstarProbe()
    low, high = {}, {}
    for seed in seeds:
        thetas = cell.kind.params(cell.traffic, seed, WARMUP + solves, device, WARMUP)
        outs = {}
        with torch.no_grad():
            for j in range(WARMUP + solves):
                before = system.launches().get(system.chunk_launcher, 0)
                u = cell.kind.solve(system, theta, thetas, j)
                outs[j] = (u.clone(), probe.last.clone())
        chunks = max(1, system.launches().get(system.chunk_launcher, 0) - before)
        th = thetas.cpu().numpy()
        held = list(range(WARMUP, WARMUP + solves))
        prog = check(cfg, seed, held, th, outs.__getitem__, device, chunks=chunks)
        ctrl = check(cfg, seed, held, th, outs.__getitem__, device, control="tf32",
                     chunks=chunks)
        row = {"seed": seed, "program": {k: v["value"] for k, v in prog.items()},
               "control": {k: v["value"] for k, v in ctrl.items()}}
        emit(json.dumps(row))
        for k, v in row["program"].items():
            low[k] = max(low.get(k, 0.0), v if v is not None else float("inf"))
        for k, v in row["control"].items():
            high[k] = min(high.get(k, float("inf")), v if v is not None else float("inf"))
        del outs
    probe.remove()
    return {"program": low, "control": high}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--solves", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench.harness import load_cell

    out = readings(load_cell(args.workload, ROOT), args.seeds, args.solves, args.device,
                   emit=lambda line: print(line, flush=True))
    print(json.dumps({"summary": args.workload, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
