#!/usr/bin/env python3
"""K1, K2 and the Poisson slice of two trees, in turns, on one NVIDIA GPU.

    python3 tools/compare_slice.py --base DIR [--out FILE]

Run from the repository root on a machine with one CUDA card; it fails
without one.  ``DIR`` is another checkout of the repository (for instance
``git archive <commit>`` unpacked into a git-ignored directory).  The two
trees run in the order base, this, this, base, each turn in a process of
its own (the two ``hommx_tpu_torch`` packages cannot share one): the turn
builds that tree's kernels and runs its own ``chip_smoke.py`` phases
``dia`` (K2 against its plain version and the CSR product, with times),
``stencil`` (K1 against its plain version, timed at the main path's
2048-cell chunk; trees that time it also do so on the 8³ mesh's
1000-cell chunk) and ``slice`` (the 512² macro / 16² micro Poisson
solve, cold then warm, with the micro and macro seconds); between the
last two it times K1 on both of those chunks with this script's own code
(``k1_times``), which calls only the wrapper ``stencil_pcg_cuda`` that
the two trees share.  It prints one JSON line per
turn and phase record, and with ``--out FILE`` writes all records there.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def k1_times(device) -> None:
    """K1's CUDA-event time on the main path's 2048-cell chunk and on a
    1000-cell chunk of the 8³ mesh, the same inputs in every tree."""
    import numpy as np
    import torch
    from chip_smoke import emit, flagship, time_ms

    from hommx_tpu_torch import MicroEngine, create_unit_cube, create_unit_square
    from hommx_tpu_torch.micro.chunk import chunk_system
    from hommx_tpu_torch.micro.stencil_pcg import stencil_pcg_cuda

    rng = np.random.default_rng(5)
    for name, mesh, C in (("2d16_C2048", create_unit_square(16, 16), 2048),
                          ("3d8_C1000", create_unit_cube(8), 1000)):
        eng = MicroEngine(mesh, device=device, dtype=torch.float32)
        centers = torch.as_tensor(rng.uniform(0, 1, (C, eng.d)), dtype=torch.float32,
                                  device=device)
        cs = chunk_system(eng, flagship, centers)
        ws_s, Fs = cs.scaled()
        args = (ws_s, Fs, cs.Minv, cs.st.shape, cs.st.offsets, eng.pcg_tol, eng.pcg_maxiter)
        _, it = stencil_pcg_cuda(*args)
        emit({"phase": "k1_time", "case": name, "iters": int(it),
              "ms": time_ms(lambda: stencil_pcg_cuda(*args), reps=20)})


def turn(tree: str) -> int:
    """One turn: the phases of the ``chip_smoke.py`` found in ``tree``."""
    import torch

    if not torch.cuda.is_available():
        print("compare_slice: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, tree)
    import chip_smoke

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    chip_smoke.phase_build()
    chip_smoke.phase_dia(device)
    chip_smoke.phase_stencil(device)
    k1_times(device)
    chip_smoke.phase_slice(device)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", help="the other tree, run first and last")
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    ap.add_argument("--out", help="write all records to this JSON file")
    args = ap.parse_args()
    if args.turn:
        return turn(args.turn)
    if not args.base:
        ap.error("--base is required")
    trees = {"base": str(Path(args.base).resolve()), "this": str(ROOT)}
    records = []
    for i, label in enumerate(("base", "this", "this", "base")):
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--turn", trees[label]],
                             capture_output=True, text=True, timeout=900)
        for line in res.stdout.splitlines():
            if line.startswith("{"):
                rec = {"turn": i, "tree": label, **json.loads(line)}
                records.append(rec)
                print(json.dumps(rec), flush=True)
        if res.returncode != 0:
            print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
            return 1
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(records, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
