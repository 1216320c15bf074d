#!/usr/bin/env python3
"""Run-to-run spread of the float32 beam against the change dedup makes.

    python3 tools/dedup_spread.py [--sizes 20x6x6 40x12x12]

On the card: the rotated-fibre beam of ``chip_smoke.py`` (float32 micro
stage through K3, float64 macro solve) twice with ``dedup_cells=False`` and
twice with the default dedup, at each macro size.  Prints one JSON line a
size: max-norm relative differences of u and of A* between the two
dedup-off runs (the pipeline's own spread: the micro stage's scatters add
in no fixed order on the card), between the two dedup runs, and between a
dedup run and a dedup-off run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", nargs="+", default=["20x6x6", "40x12x12"])
    args = ap.parse_args()
    dev = torch.device("cuda", 0)
    for size in args.sizes:
        macro_n = tuple(int(v) for v in size.split("x"))
        runs = {}
        for dedup in (False, True):
            for k in range(2):
                hmm = cs.make_beam(dev, macro_n, dedup_cells=dedup)
                u = hmm.solve().array
                runs[(dedup, k)] = (u, hmm.homogenized_tensors(), hmm.diagnostics["unique_cells"])
        out = {"size": size, "device": torch.cuda.get_device_name(dev),
               "unique_cells": runs[(True, 0)][2]}
        for name, a, b in (("off_vs_off", (False, 0), (False, 1)),
                           ("on_vs_on", (True, 0), (True, 1)),
                           ("on_vs_off", (True, 0), (False, 0))):
            out[f"u_{name}"] = cs.rel_diff(runs[a][0], runs[b][0])
            out[f"astar_{name}"] = cs.rel_diff(runs[a][1], runs[b][1])
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
