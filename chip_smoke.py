#!/usr/bin/env python3
"""Smoke run of the hommx_tpu_torch main path on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Phases (each prints one JSON line; any failure raises, exits non-zero and
prints no result line):

1. device     the card's name, and ``nvidia-smi`` name + power limit
2. build      both CUDA kernels compiled from the repository's sources
3. dia_spmv   K2 vs its plain version on the 512x512 macro DIA pattern
4. stencil    K1 vs its plain version on one 2048-cell chunk of the
              16x16 micro engine (flagship coefficient), on a ragged
              37-cell chunk and on a 1000-cell chunk of an 8x8x8 micro mesh
5. golden     PoissonHMM golden configuration (8x8 macro, 8x8 micro) in
              float32 through K1 and the direct macro solve, vs the frozen
              float64 functionals
6. slice      PoissonHMM on a 512x512 macro mesh (524,288 cells, 263,169
              dofs) with a 16x16 micro mesh, float32, Jacobi CG macro solve
              through K2 — cold then warm — with every kernel's launch
              count, and A* on 4096 cells vs the plain PCG loop in float64

The line before the last is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

# frozen float64 functionals (L2 norm, max|u|) of the golden poisson_hmm
# configuration, computed by the JAX reference package on the CPU
GOLDEN_POISSON_HMM = (0.13615178178157605, 0.26585257192673567)
GOLDEN_RTOL = 1e-4  # float32 on the card
K1_RTOL = 5e-5  # A* relative error, kernel vs plain
K1_ITER_SLACK = 2
K2_RTOL = 1e-5  # max abs error / max |y|
SLICE_ASTAR_RTOL = 1e-4  # float32 slice vs plain float64 port


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps: int = 20, warmup: int = 2) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()``."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def flagship(x, y):
    import torch

    return 1.1 + x[0] + torch.sin(2 * torch.pi * y[0])


def golden_coeff(x, y):
    import torch

    return 0.33 + 0.15 * (torch.sin(2 * torch.pi * x[0]) + torch.sin(2 * torch.pi * y[0]))


def phase_device():
    import torch

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    emit({"phase": "device", "name": name, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda})
    return name, smi


def phase_build():
    from hommx_tpu_torch.micro import stencil_pcg
    from hommx_tpu_torch.ops import dia

    out = {"phase": "build"}
    for key, kern in (("stencil_pcg", stencil_pcg.KERNEL), ("dia_spmv", dia.KERNEL)):
        kern.library()
        out[f"{key}_seconds"] = kern.build_seconds
        for line in kern.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[{key}] {line.strip()}", file=sys.stderr)
    emit(out)


def phase_dia(device):
    import torch

    from hommx_tpu_torch import create_unit_square
    from hommx_tpu_torch.ops.dia import build_dia_from_ell, dia_spmv, dia_spmv_cuda
    from hommx_tpu_torch.ops.sparse import build_ell_pattern

    mesh = create_unit_square(512, 512)
    dia = build_dia_from_ell(build_ell_pattern(mesh.cells, mesh.num_vertices))
    N, nd = dia.num_dofs, dia.num_diagonals
    g = torch.Generator(device=device).manual_seed(2)
    vals = torch.randn((nd, N), generator=g, device=device, dtype=torch.float32)
    x = torch.randn((N,), generator=g, device=device, dtype=torch.float32)
    y_k = dia_spmv_cuda(vals, dia.offsets, x)
    y_p = dia_spmv(vals, dia.offsets, x)
    torch.cuda.synchronize()
    abs_err = float((y_k - y_p).abs().max())
    rel = abs_err / float(y_p.abs().max())
    ms = time_ms(lambda: dia_spmv_cuda(vals, dia.offsets, x))
    plain_ms = time_ms(lambda: dia_spmv(vals, dia.offsets, x))
    rec = {"phase": "dia_spmv", "N": N, "offsets": list(dia.offsets),
           "max_abs_err": abs_err, "rel_err": rel, "ms": ms, "plain_ms": plain_ms}
    emit(rec)
    if not rel < K2_RTOL:
        raise AssertionError(f"DIA kernel disagrees with its plain version: {rel}")
    return rec


def _k1_case(eng, centers, timed):
    """K1 vs its plain version on one chunk of the main path's scaled
    system, both taken through the chunk's own clamp and A* contraction."""
    import torch

    from hommx_tpu_torch.micro.chunk import chunk_system
    from hommx_tpu_torch.micro.stencil_pcg import stencil_pcg_cuda, stencil_pcg_plain

    cs = chunk_system(eng, flagship, centers)
    ws_s, Fs = cs.scaled()
    args = (ws_s, Fs, cs.Minv, cs.st.shape, cs.st.offsets, eng.pcg_tol, eng.pcg_maxiter)
    Yk, itk = stencil_pcg_cuda(*args)
    Yp, itp = stencil_pcg_plain(*args)
    Ak, Ap = cs.astar(eng, Yk, itk), cs.astar(eng, Yp, itp)
    torch.cuda.synchronize()
    abs_err = float((Ak - Ap).abs().max())
    rec = {"cells": centers.shape[0], "dim": eng.d, "n": eng.n_reduced,
           "K": len(cs.st.offsets), "s": eng.s, "iters_kernel": int(itk),
           "iters_plain": int(itp), "max_abs_err": abs_err,
           "rel_err": abs_err / float(Ap.abs().max())}
    if timed:
        rec["ms"] = time_ms(lambda: stencil_pcg_cuda(*args), reps=20)
        rec["plain_ms"] = time_ms(lambda: stencil_pcg_plain(*args), reps=5, warmup=1)
    ok = (math.isfinite(rec["rel_err"]) and rec["rel_err"] < K1_RTOL
          and abs(rec["iters_kernel"] - rec["iters_plain"]) <= K1_ITER_SLACK)
    return rec, ok


def phase_stencil(device):
    """K1 at the main path's chunk (16x16 micro, 2048 cells), at a ragged
    chunk (padded blocks) and on an 8x8x8 micro mesh (n = 512, K = 15:
    dynamic shared memory above the 48 KB default)."""
    import numpy as np
    import torch

    from hommx_tpu_torch import MicroEngine, create_unit_cube, create_unit_square

    rng = np.random.default_rng(0)
    eng2 = MicroEngine(create_unit_square(16, 16), device=device, dtype=torch.float32)
    eng3 = MicroEngine(create_unit_cube(8), device=device, dtype=torch.float32)
    cases = (("2d16_C2048", eng2, 2048, True), ("2d16_C37", eng2, 37, False),
             ("3d8_C1000", eng3, 1000, False))
    main, failed = None, []
    for name, eng, C, timed in cases:
        centers = torch.as_tensor(rng.uniform(0, 1, (C, eng.d)), dtype=torch.float32,
                                  device=device)
        rec, ok = _k1_case(eng, centers, timed)
        rec = {"phase": "stencil_pcg", "case": name, **rec}
        emit(rec)
        if not ok:
            failed.append(name)
        main = main or rec
    if failed:
        raise AssertionError(f"stencil PCG kernel disagrees with its plain version: {failed}")
    return main


def phase_golden(device):
    import torch

    from hommx_tpu_torch import PoissonHMM, create_unit_square
    from hommx_tpu_torch.ops.assembly import l2_norm_fn

    macro, micro = create_unit_square(8, 8), create_unit_square(8, 8)
    hmm = PoissonHMM(macro, golden_coeff, lambda x: 1.0, micro, 0.1 / 8,
                     dtype=torch.float32, device=device)
    u = hmm.solve().array
    l2 = float(l2_norm_fn(hmm._sys.verts64, hmm._sys.cells, u.double()))
    umax = float(u.abs().max())
    rel = [abs(g - w) / abs(w) for g, w in zip((l2, umax), GOLDEN_POISSON_HMM)]
    emit({"phase": "golden", "l2": l2, "max_u": umax, "rel_err": rel,
          "macro_method": hmm._macro_method})
    if not all(math.isfinite(r) and r < GOLDEN_RTOL for r in rel):
        raise AssertionError(f"golden functionals off: {rel}")


def phase_slice(device):
    import torch

    from hommx_tpu_torch import MicroEngine, PoissonHMM, SolverOptions, create_unit_square
    from hommx_tpu_torch.micro import stencil_pcg
    from hommx_tpu_torch.micro.chunk import tensors_chunk_plain
    from hommx_tpu_torch.micro.krylov import _map_chunked
    from hommx_tpu_torch.ops import dia

    macro, micro = create_unit_square(512, 512), create_unit_square(16, 16)
    opts = SolverOptions(method="cg", pc="jacobi", rtol=1e-5, maxiter=20000)
    stencil_pcg.KERNEL.launches = 0
    dia.KERNEL.launches = 0
    runs = []
    hmm = None
    for label in ("cold", "warm"):
        t0 = time.perf_counter()
        hmm = PoissonHMM(macro, flagship, 1.0, micro, 2**-5, opts,
                         dtype=torch.float32, device=device, chunk=2048)
        t_setup = time.perf_counter() - t0
        u = hmm.solve().array
        torch.cuda.synchronize()
        t_total = time.perf_counter() - t0
        dg = hmm.diagnostics
        # one cell solve = one generator problem: s = d per macro cell
        cell_solves = dg["num_cells"] * hmm._engine.s
        finite = bool(torch.isfinite(u).all())
        rec = {"phase": f"slice_{label}", "setup_seconds": t_setup,
               "total_seconds": t_total, "micro_seconds": dg["micro_seconds"],
               "macro_seconds": dg["macro_seconds"],
               "macro_iterations": dg["macro_iterations"],
               "macro_residual": dg["macro_residual"], "num_cells": dg["num_cells"],
               "dofs": hmm.function_space.num_dofs,
               "cell_solves": cell_solves,
               "cell_solves_per_s": cell_solves / dg["micro_seconds"],
               "diverged_cells": int(dg["diverged_cells"].size),
               "fallback_cells": int(dg["fallback_cells"].size),
               "nan_cells": int(dg["nan_cells"].size), "finite": finite,
               "max_u": float(u.abs().max())}
        emit(rec)
        runs.append(rec)
        if not (finite and dg["macro_iterations"] < opts.maxiter
                and rec["diverged_cells"] == 0 and rec["fallback_cells"] == 0
                and rec["nan_cells"] == 0):
            raise AssertionError(f"slice run failed its checks: {rec}")
    launches = {"stencil_pcg": stencil_pcg.KERNEL.launches, "dia_spmv": dia.KERNEL.launches}
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the main path was never launched: {launches}")

    # A* of 4096 cells vs the plain PCG loop in float64 on the card (the
    # kernel is float32 only; no entry point runs this route)
    A32 = hmm.homogenized_tensors()
    idx = torch.linspace(0, A32.shape[0] - 1, 4096, device=device).round().long()
    eng64 = MicroEngine(micro, dtype=torch.float64, device=device)
    A64 = _map_chunked(lambda c: tensors_chunk_plain(eng64, flagship, c),
                       hmm._sys.centers[idx].double(), 2048)
    rel = float((A32[idx].double() - A64).abs().max() / A64.abs().max())
    emit({"phase": "slice_astar_check", "cells": 4096, "rel_err": rel})
    if not rel < SLICE_ASTAR_RTOL:
        raise AssertionError(f"slice A* off the float64 plain port: {rel}")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import hommx_tpu_torch  # noqa: F401  (fails outside a checkout)

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    name, smi = phase_device()
    phase_build()
    k2 = phase_dia(device)
    k1 = phase_stencil(device)
    phase_golden(device)
    launches = phase_slice(device)
    kernels = [
        {"name": "stencil_pcg", "route": "cuda",
         "source": "hommx_tpu_torch/micro/csrc/stencil_pcg.cu",
         "replaces": "hommx_tpu/micro/stencil_pcg.py:81",
         "launches": launches["stencil_pcg"], "max_abs_err": k1["max_abs_err"],
         "ms": k1["ms"], "plain_ms": k1["plain_ms"]},
        {"name": "dia_spmv", "route": "cuda",
         "source": "hommx_tpu_torch/ops/csrc/dia_spmv.cu",
         "replaces": "hommx_tpu/ops/dia.py:145",
         "launches": launches["dia_spmv"], "max_abs_err": k2["max_abs_err"],
         "ms": k2["ms"], "plain_ms": k2["plain_ms"]},
    ]
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
