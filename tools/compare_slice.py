#!/usr/bin/env python3
"""K1, K2, K3 and the two slices of two trees, in turns, on one NVIDIA GPU.

    python3 tools/compare_slice.py --base DIR [--groups poisson,elasticity,k1,k3] [--out FILE]

Run from the repository root on a machine with one CUDA card; it fails
without one.  ``DIR`` is another checkout of the repository (for instance
``git archive <commit>`` unpacked into a git-ignored directory).  The two
trees run in the order base, this, this, base, each turn in a process of
its own (the two ``hommx_tpu_torch`` packages cannot share one): the turn
builds that tree's kernels and runs its own ``chip_smoke.py`` phases.

- ``poisson``: ``dia`` (K2 against its plain version and the CSR product,
  with times), ``stencil`` (K1 against its plain version, timed at the main
  path's 2048-cell chunk; trees that time it also do so on the 8³ mesh's
  1000-cell chunk) and ``slice`` (the 512² macro / 16² micro Poisson
  solve, cold then warm, with the micro and macro seconds); between the
  last two it times K1 on both of those chunks with this script's own code
  (``k1_times``), which calls only the wrapper ``stencil_pcg_cuda`` that
  the two trees share.
- ``elasticity``: ``chol`` (K3 against its plain version, timed at the
  beam's 1080-cell chunk with ``torch.linalg.solve`` beside it), then
  ``k3_times`` (this script's own code: both trees' ``fused_chol_solve_cuda``
  on that chunk and on the 8640-cell elasticity micro stage's eight
  chunks), then ``slice_elasticity`` (the beam, cold then warm, and the
  stage's seconds).
- ``k1``: ``k1_times`` and ``k1_large_times`` (this script's own code,
  both trees' ``stencil_pcg_cuda``): K1's small instance on the main path's
  chunks and its large one on the auto-sized chunks of the 33², 64² and
  16³ micro meshes, timed, and on two 64² chunks whose alternate blocks
  hold high-contrast cells, held block by block against the per-block
  plain version.
- ``k3``: ``k3_large_times`` (this script's own code, both trees'
  ``fused_chol_solve_cuda``): K3's large instance at the four shapes of
  ``chip_smoke.py`` phase 5 (h2) and on one 8³ cell (8 CTAs), and the small
  instance on the beam's 1080-cell chunk, timed, with each result's
  residual.

It prints one JSON line per turn and phase record, and with ``--out FILE``
writes all records there.
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


def _harsh_coeff(x, y):
    """The flagship coefficient times 100 in a disc of radius 1/4 at the
    middle of cells with x₀ < 1/2 (contrast up to ~2000)."""
    import torch
    from chip_smoke import flagship

    inc = ((y[0] - 0.5) ** 2 + (y[1] - 0.5) ** 2 < 0.0625) & (x[0] < 0.5)
    return flagship(x, y) * torch.where(inc, 100.0, 1.0)


def k1_large_times(device) -> None:
    """K1's large instance: the CUDA-event time on an auto-sized chunk of
    the 33², 64² and 16³ micro meshes (flagship), and on two 64² chunks
    whose alternate blocks hold contrast cells (contrast 100 as in
    ``chip_smoke.contrast_coeff``, defined here too since older trees lack
    it, and ``_harsh_coeff``), the A* distance to the
    per-block plain version and the per-block iteration counts of the
    kernel, the plain version and the plain version in float64 (stop
    tolerance 1e-5); the same inputs in every tree."""
    import numpy as np
    import torch
    from chip_smoke import emit, flagship, time_ms

    from hommx_tpu_torch import MicroEngine, create_unit_cube, create_unit_square
    from hommx_tpu_torch.micro.chunk import chunk_system
    from hommx_tpu_torch.micro.stencil_pcg import launch_config, stencil_pcg_cuda, stencil_pcg_plain

    def contrast100(x, y):
        inc = (y[0] - 0.5) ** 2 + (y[1] - 0.5) ** 2 < 0.0625
        return torch.where(x[0] < 0.5, torch.where(inc, 100.0, 1.0), flagship(x, y))

    rng = np.random.default_rng(6)
    for name, mesh in (("2d33", create_unit_square(33, 33)), ("2d64", create_unit_square(64, 64)),
                       ("3d16", create_unit_cube(16))):
        eng = MicroEngine(mesh, device=device, dtype=torch.float32)
        C = eng._auto_chunk(1 << 20)
        cases = [(name, flagship, rng.uniform(0, 1, (C, eng.d)))]
        if name == "2d64":
            cb = launch_config(eng.n_reduced, eng.s, C).cells_per_block
            half = (np.arange(C) // cb) % 2 == 0
            x0 = np.where(half, rng.uniform(0, 0.5, C), rng.uniform(0.5, 1, C))
            cen = np.stack([x0, rng.uniform(0, 1, C)], axis=1)
            cases += [(f"{name}_contrast100", contrast100, cen),
                      (f"{name}_harsh", _harsh_coeff, cen)]
        for tag, coeff, cen in cases:
            centers = torch.as_tensor(cen, dtype=torch.float32, device=device)
            cs = chunk_system(eng, coeff, centers)
            ws_s, Fs = cs.scaled()
            args = (ws_s, Fs, cs.Minv, cs.st.shape, cs.st.offsets, eng.pcg_tol, eng.pcg_maxiter)
            Yk, itk = stencil_pcg_cuda(*args, per_block=True)
            itk = [int(v) for v in itk.cpu()]
            rec = {"phase": "k1_large_time", "case": tag, "iters": max(itk),
                   "ms": time_ms(lambda: stencil_pcg_cuda(*args), reps=10)}
            if tag != name:  # the per-block plain version, float32 and float64
                cb = launch_config(eng.n_reduced, eng.s, C).cells_per_block
                Yp, itp = stencil_pcg_plain(*args, block=cb, per_block=True)
                args64 = ([w.double() for w in ws_s], Fs.double(), cs.Minv.double(), *args[3:5],
                          1e-5, eng.pcg_maxiter)
                _, it64 = stencil_pcg_plain(*args64, block=cb, per_block=True)
                Ak, Ap = cs.astar(eng, Yk, max(itk)), cs.astar(eng, Yp, max(itp))
                rec.update({"iters_per_block": [list(v) for v in zip(itk, itp, it64)],
                            "astar_rel_err": float((Ak - Ap).abs().max() / Ap.abs().max())})
            emit(rec)
        del eng
        torch.cuda.empty_cache()


def k3_times(device, chunk: int = 1080, cells: int = 8640) -> None:
    """K3's CUDA-event time on phase 5 case (a)'s chunk (the beam's first
    1080 cells) and on the elasticity micro stage at the bench row's size
    (8640 fresh cells, x-dependent fibre modulus, eight 1080-cell chunks,
    all eight launches timed together), the same inputs in every tree."""
    import numpy as np
    import torch
    from chip_smoke import (BEAM_H, BEAM_L, BEAM_W, _cell_systems, beam_coeff, beam_rotation,
                            emit, time_ms)

    from hommx_tpu_torch import MicroEngine, create_box, create_unit_cube
    from hommx_tpu_torch.ops.chol_kernel import fused_chol_solve_cuda

    eng = MicroEngine(create_unit_cube(4), bs=3, coeff_kind="tensor4", dtype=torch.float32,
                      device=device)
    macro = create_box([[0, 0, 0], [BEAM_L, BEAM_W, BEAM_H]], [20, 6, 6])
    centers = torch.as_tensor(macro.vertices[macro.cells].mean(axis=1)[:chunk],
                              dtype=torch.float32, device=device)
    Ks, Fs, _ = _cell_systems(eng, beam_coeff(False), centers, beam_rotation)
    emit({"phase": "k3_time", "case": f"a_beam_C{chunk}", "launches": 1,
          "ms": time_ms(lambda: fused_chol_solve_cuda(Ks, Fs), reps=20)})
    stage_centers = torch.as_tensor(np.random.default_rng(1).uniform(0, 1, (cells, 3)),
                                    dtype=torch.float32, device=device)
    systems = [_cell_systems(eng, beam_coeff(True), stage_centers[a:a + chunk], beam_rotation)[:2]
               for a in range(0, cells, chunk)]

    def stage():
        for K, F in systems:
            fused_chol_solve_cuda(K, F)

    emit({"phase": "k3_time", "case": f"stage_C{cells}", "launches": len(systems),
          "ms": time_ms(stage, reps=10)})


def k3_large_times(device) -> None:
    """K3's CUDA-event times on the small instance's 1080-cell beam chunk
    (4³ cube; first, before the large shapes warm the card), at the large
    instance's four shapes of ``chip_smoke.py`` phase 5 (h2) (the beam's
    720, 309 and 76 cells on the 5³, 6³ and 8³ cubes, the 2D inclusion's
    683 cells on the 16² square) and on one 8³ cell (a cluster of 8 CTAs),
    the same inputs in every tree; the
    large shapes' X also against the plain version (largest residual
    ‖F − K X‖∞/‖F‖∞ in float64, of 16 sampled cells)."""
    import numpy as np
    import torch
    from chip_smoke import (BEAM_H, BEAM_L, BEAM_W, _cell_systems, beam_coeff, beam_rotation,
                            emit, inclusion_mu, time_ms)

    from hommx_tpu_torch import MicroEngine, create_box, create_unit_cube, create_unit_square
    from hommx_tpu_torch.ops.chol_kernel import chol_launch_config, fused_chol_solve_cuda
    from hommx_tpu_torch.utils.validation import hooke_tensor

    def engine(mesh):
        return MicroEngine(mesh, bs=mesh.dim, coeff_kind="tensor4", dtype=torch.float32,
                           device=device)

    macro = create_box([[0, 0, 0], [BEAM_L, BEAM_W, BEAM_H]], [20, 6, 6])
    beam = torch.as_tensor(macro.vertices[macro.cells].mean(axis=1), dtype=torch.float32,
                           device=device)

    def residual(K, F, X):
        cells = np.linspace(0, K.shape[0] - 1, 16).round().astype(int).tolist()
        Kd, Fd, Xd = K[cells].double(), F[:, :, cells].double(), X[:, :, cells].double()
        R = Fd.permute(2, 0, 1) - Kd @ Xd.permute(2, 0, 1)
        return float((R.abs().amax(dim=(1, 2)) / Fd.permute(2, 0, 1).abs().amax(dim=(1, 2))).max())

    def timed(case, K, F, large):
        cfg = chol_launch_config(K.shape[1], F.shape[1], K.shape[0])
        X = fused_chol_solve_cuda(K, F)
        emit({"phase": "k3_large_time", "case": case, "n": K.shape[1], "cells": K.shape[0],
              "cluster": cfg.cluster, "apart": getattr(cfg, "apart", 0), "large": large,
              "ms": time_ms(lambda: fused_chol_solve_cuda(K, F), reps=10),
              "residual": residual(K, F, X)})

    K, F, _ = _cell_systems(engine(create_unit_cube(4)), beam_coeff(False), beam[:1080],
                            beam_rotation)
    timed("small_beam_C1080", K, F, False)
    for m, C in ((5, 720), (6, 309), (8, 76)):
        K, F, _ = _cell_systems(engine(create_unit_cube(m)), beam_coeff(False), beam[:C],
                                beam_rotation)
        timed(f"beam_cube{m}_C{C}", K, F, True)
        if m == 8:
            timed("beam_cube8_C1", K[:1].contiguous(), F[:, :, :1].contiguous(), True)
        del K, F
        torch.cuda.empty_cache()
    rng = np.random.default_rng(21)
    c2 = torch.as_tensor(rng.uniform(0, 1, (683, 2)), dtype=torch.float32, device=device)
    K, F, _ = _cell_systems(engine(create_unit_square(16)),
                            hooke_tensor(2, inclusion_mu, lambda x, y: 1.0), c2)
    timed("square16_C683", K, F, True)


def turn(tree: str, groups: list) -> int:
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
    if "poisson" in groups:
        chip_smoke.phase_dia(device)
        chip_smoke.phase_stencil(device)
        k1_times(device)
        chip_smoke.phase_slice(device)
    if "k1" in groups:
        k1_times(device)
        k1_large_times(device)
    if "elasticity" in groups:
        chip_smoke.phase_chol(device)
        k3_times(device)
        chip_smoke.phase_slice_elasticity(device)
    if "k3" in groups:
        k3_large_times(device)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", help="the other tree, run first and last")
    ap.add_argument("--groups", default="poisson,elasticity",
                    help="comma-separated phase groups: poisson, elasticity, k1, k3")
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    ap.add_argument("--out", help="write all records to this JSON file")
    args = ap.parse_args()
    groups = [g for g in args.groups.split(",") if g]
    if not groups or set(groups) - {"poisson", "elasticity", "k1", "k3"}:
        ap.error(f"--groups: unknown group in {args.groups!r}")
    if args.turn:
        return turn(args.turn, groups)
    if not args.base:
        ap.error("--base is required")
    trees = {"base": str(Path(args.base).resolve()), "this": str(ROOT)}
    records = []
    for i, label in enumerate(("base", "this", "this", "base")):
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--turn", trees[label],
                              "--groups", ",".join(groups)],
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
