#!/usr/bin/env python3
"""Bit-level digests of the main paths' forward results, to hold two trees
of hommx_tpu_torch to the same bits on one NVIDIA GPU.

    python3 tools/forward_digest.py [--root DIR]

Run from the repository root on a machine with one CUDA card; it fails
without one.  ``--root`` names the checkout whose ``hommx_tpu_torch`` is
imported (default: this one), for instance ``git archive <commit>``
unpacked into a git-ignored directory; its kernels are built into that
tree's ``_build/``.  Each case runs in float32 and prints the SHA-256 of
the result's bytes, one JSON line in all:

- ``slice_mg``: the 512² / 16² Poisson slice of ``chip_smoke.py``
  (flagship coefficient, CG to rtol 1e-5, dedup off): A* and u;
- ``slice_default``: the same with the models' defaults (dedup on): u;
- ``golden``: the 8² / 8² golden through K1 and the direct macro solve: u;
- ``beam``: the 20×6×6 rotated-fibre beam (K3, direct float64 macro,
  dedup off): A* and u;
- ``chol_batched``: 1080 beam cells through the whole-batch K3 route
  (``HOMMX_CHOL_SOLVE_BATCH=1``): A*;
- ``correctors``: ``cell_correctors`` of 64 slice cells: A* and X.

Two trees whose lines are equal computed every one of these bit for bit.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def digest(t) -> str:
    return hashlib.sha256(t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()[:16]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(ROOT))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("forward_digest: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve()))
    sys.path.insert(1, str(ROOT))
    import hommx_tpu_torch as ht
    from chip_smoke import beam_coeff, beam_rotation, flagship, golden_coeff, make_beam

    if not Path(ht.__file__).resolve().is_relative_to(Path(args.root).resolve()):
        raise RuntimeError(f"imported {ht.__file__}, not the tree under {args.root}")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    f32 = torch.float32
    out = {"root": args.root}

    def slice_model(**kw):
        return ht.PoissonHMM(ht.create_unit_square(512), flagship, 1.0, ht.create_unit_square(16),
                             2**-5, ht.SolverOptions(rtol=1e-5, maxiter=20000), dtype=f32,
                             device=device, chunk=2048, **kw)

    hmm = slice_model(dedup_cells=False)
    u = hmm.solve().array
    out["slice_mg"] = [digest(hmm.homogenized_tensors()), digest(u)]
    out["slice_default"] = digest(slice_model().solve().array)
    hmm = ht.PoissonHMM(ht.create_unit_square(8), golden_coeff, lambda x: 1.0,
                        ht.create_unit_square(8), 0.1 / 8, dtype=f32, device=device,
                        dedup_cells=False)
    out["golden"] = digest(hmm.solve().array)
    beam = make_beam(device)
    u = beam.solve().array
    out["beam"] = [digest(beam.homogenized_tensors()), digest(u)]
    eng = ht.MicroEngine(ht.create_unit_cube(4), bs=3, coeff_kind="tensor4", dtype=f32,
                         device=device)
    centers = torch.rand((1080, 3), generator=torch.Generator().manual_seed(1)).to(device, f32)
    os.environ["HOMMX_CHOL_SOLVE_BATCH"] = "1"
    A = eng.tensors_for_centers(beam_coeff(True), centers, G_fn=beam_rotation, chunk=540)
    del os.environ["HOMMX_CHOL_SOLVE_BATCH"]
    out["chol_batched"] = digest(A)
    A, X = slice_model(dedup_cells=False).cell_correctors(list(range(0, 524288, 8192)))
    out["correctors"] = [digest(A), digest(X)]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
