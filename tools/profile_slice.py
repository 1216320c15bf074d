#!/usr/bin/env python3
"""Where the time of the hommx_tpu_torch slice goes, on one NVIDIA GPU.

    python3 tools/profile_slice.py [--mode poisson|elasticity|micro16|routes|amg|sharded|fem3d]
                                   [--macro 512] [--micro 16] [--pc auto|jacobi] [--out FILE]

Run from the repository root on a machine with one CUDA card; it fails
without one.  It prints one JSON line per measurement; the full records,
with each stage's top kernels, go to ``--out`` (default
``chiprun_out/profile_<mode>.json``).

``--mode poisson`` (default) drives the Poisson slice of ``chip_smoke.py``
(flagship coefficient, float32, chunk 2048, CG to rtol 1e-5 preconditioned
by ``--pc``: ``auto``, the default options' multigrid V-cycle, or
``jacobi``):

- ``dia_loop``: K2 (the prepared operator, as the macro CG calls it) and
  its plain version, 200 back-to-back calls per turn
  in the order plain, kernel, kernel, plain (CUDA events, ms per call), on
  the macro DIA systems of 32², 63², 64², 128² and 512² meshes (N from
  1,089 to 263,169 dofs);
- ``k1_chunk``: device time of one K1 launch on a 2048-cell chunk;
- ``solve``: three solves, each on a fresh model (host clock, the
  ``diagnostics`` of each);
- ``stage``: ``torch.profiler`` over the micro stage
  (``homogenized_tensors``), the guard (``nocorrector_tensors``) and the
  macro stage (a solve with the micro stage cached: guard, assembly, CG):
  wall seconds, device busy seconds (union of the device's kernel and copy
  intervals), idle share of the wall, kernel count, kernel launches of K1
  and K2, top kernels by device time;
- ``macro_pc``: the macro stage alone (the micro stage's A* cached, one
  warm-up solve first) with the multigrid and the Jacobi preconditioner,
  in the order jacobi, auto, auto, jacobi, profiled as above, with each
  solve's iterations, loop steps and host readbacks of the stop flag.

``--mode elasticity`` drives the rotated-fiber beam of ``chip_smoke.py``
(``make_beam``: 4320 cells, 4³ micro cube, n = 192, s = 6, float32, direct
float64 macro solve):

- ``k3_chunk``: device time of one K3 launch on the beam's first
  1080-cell chunk;
- ``solve``: three solves, each on a fresh model;
- ``stage``: ``torch.profiler`` over the micro stage, the guard and the
  macro stage, as above, with K3's launches;
- ``micro_bench``: the micro stage alone at the bench row's size (8640
  fresh cells, x-dependent fibre modulus, chunk 1080), profiled.

``--mode micro16`` drives the 16³ elasticity cells of ``chip_smoke.py``'s
``micro_highres`` (rotated stiff fibre, float32, the torus-multigrid PCG):
``mg16``, ``torch.profiler`` over 8 cells at chunk 8 and over 128 cells at
the auto chunk (fresh centres each, one warm-up first), with the top
kernels by device time.

``--mode routes`` profiles the flagship's micro stage (``--macro``² cells,
dedup off, float32, chunk 2048) on three routes, one warm-up model first
for each: ``k1`` (16² micro, K1), ``fft`` (16² micro, ``cell_prec='fft'``:
the chunk PCG in plain torch with cuFFT) and ``p2`` (8² micro,
``micro_degree=2``: the matrix-free gather with K0⁻¹).

``--mode amg`` profiles the unstructured macro stage of ``chip_smoke.py``'s
``amg`` phase: ``examples/diffusion/unstructured.py``'s jittered Delaunay
mesh at ``--macro``² (PoissonHMM, 16² micro, float32, CG to rtol 1e-5
preconditioned by the aggregation-AMG V-cycle, one warm-up solve first,
so the micro stage is cached): ``amg_build`` (the host build's seconds and
the levels), then ``torch.profiler`` over the macro stage (a solve:
guard, assembly, ``amg_setup``, the CG), over ``amg_setup`` alone and
over 10 V-cycles (``launches_per_vcycle``: device events over 10), each
with device busy and idle share and the top kernels.

``--mode sharded`` profiles the Poisson slice (``--macro``², 16² micro,
float32, dedup off, multigrid CG to rtol 1e-5) unsharded and on
``ShardMesh(["cuda:0"] * 4)``, one warm-up solve each (the micro
stage then cached): the micro stage of a fresh model of each, then the
macro stage (a solve: guard, assembly, the CG) in the order unsharded,
sharded, sharded, unsharded, each with its ``diagnostics``, K2's launches,
device busy and idle share and the top kernels.

``--mode fem3d`` drives the fine FEM of ``examples/hmm_3d.py`` at its 64³
default (``hommx_tpu_torch.examples.hmm_3d``'s coefficient, 274,625 dofs,
float32 multigrid CG through K2): three ``fem_solve`` calls (set-up,
assembly and solve seconds, CG iterations, the multigrid grids), then one
under ``torch.profiler`` (device busy and idle share of the whole call).
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def device_busy(prof) -> tuple:
    """(busy seconds, span seconds, kernel count, top kernels) of the device
    events of a finished ``torch.profiler`` run."""
    from torch.autograd import DeviceType

    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    ivs = sorted((e.time_range.start, e.time_range.end) for e in evs)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in ivs:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    span = (ivs[-1][1] - ivs[0][0]) if ivs else 0.0
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in evs:
        by_name[e.name][0] += 1
        by_name[e.name][1] += (e.time_range.end - e.time_range.start) / 1e3
    top = sorted(([k[:90], n, round(ms, 3)] for k, (n, ms) in by_name.items()),
                 key=lambda r: -r[2])[:8]
    return busy / 1e6, span / 1e6, len(evs), top


def profiled(tag, fn, kernels):
    import torch
    from torch.profiler import ProfilerActivity, profile

    for k in kernels.values():
        k.reset_counts()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, span, n, top = device_busy(prof)
    return {"stage": tag, "wall_s": wall, "device_busy_s": busy, "kernel_span_s": span,
            "idle_share_of_wall": 1.0 - busy / wall, "n_device_events": n,
            "launches": {name: k.launches for name, k in kernels.items()}, "top": top}


def dia_loop(n, device, reps=200):
    import torch

    from hommx_tpu_torch import create_unit_square
    from hommx_tpu_torch.ops.dia import DIAOperator, build_dia_from_ell, dia_spmv
    from hommx_tpu_torch.ops.sparse import build_ell_pattern

    mesh = create_unit_square(n, n)
    dia = build_dia_from_ell(build_ell_pattern(mesh.cells, mesh.num_vertices))
    g = torch.Generator(device=device).manual_seed(3)
    vals = torch.randn((dia.num_diagonals, dia.num_dofs), generator=g, device=device)
    x = torch.randn((dia.num_dofs,), generator=g, device=device)
    op = DIAOperator(vals, dia.offsets)
    fns = {"plain": lambda: dia_spmv(vals, dia.offsets, x),
           "kernel": lambda: op(x, out=op.out)}  # as the macro CG calls it
    out = {"macro": n, "N": dia.num_dofs, "plain_ms": [], "kernel_ms": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        fn = fns[name]
        for _ in range(5):
            fn()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        out[f"{name}_ms"].append(a.elapsed_time(b) / reps)
    return out


def poisson(args, device, keep, kernels):
    import torch

    from chip_smoke import flagship
    from hommx_tpu_torch import MicroEngine, PoissonHMM, SolverOptions, create_unit_square
    from hommx_tpu_torch.micro import stencil_pcg
    from hommx_tpu_torch.micro.chunk import chunk_system

    for n in (32, 63, 64, 128, 512):
        keep({"tag": "dia_loop", **dia_loop(n, device)})

    eng = MicroEngine(create_unit_square(args.micro, args.micro), device=device,
                      dtype=torch.float32)
    centers = torch.rand((2048, 2), generator=torch.Generator(device=device).manual_seed(0),
                         device=device)
    cs = chunk_system(eng, flagship, centers)
    ws_s, Fs = cs.scaled()
    k1_args = (ws_s, Fs, cs.Minv, cs.st.shape, cs.st.offsets, eng.pcg_tol, eng.pcg_maxiter)
    stencil_pcg.stencil_pcg_cuda(*k1_args)
    rec = profiled("k1_chunk", lambda: stencil_pcg.stencil_pcg_cuda(*k1_args), kernels)
    keep({"tag": "k1_chunk", **rec})

    macro = create_unit_square(args.macro, args.macro)
    micro = create_unit_square(args.micro, args.micro)
    return lambda pc=args.pc: PoissonHMM(
        macro, flagship, 1.0, micro, 2**-5,
        SolverOptions(method="cg", pc=pc, rtol=1e-5, maxiter=20000),
        dtype=torch.float32, device=device, chunk=2048)


def macro_pc(make, A_star, keep, kernels):
    """The Poisson macro stage alone with each preconditioner, in turns."""
    from hommx_tpu_torch.ops import solvers

    models = {}
    for pc in ("jacobi", "auto"):
        models[pc] = make(pc)
        models[pc]._A_star = A_star
        models[pc].solve()  # warm-up: the load vector and the hierarchy
    for pc in ("jacobi", "auto", "auto", "jacobi"):
        reads0 = solvers.STOP_TEST.readbacks
        rec = profiled(f"macro_{pc}", models[pc].solve, kernels)
        dg = models[pc].diagnostics
        keep({"tag": "macro_pc", "pc": pc, **rec, "macro_seconds": dg["macro_seconds"],
              "macro_iterations": dg["macro_iterations"], "macro_steps": dg["macro_steps"],
              "host_readbacks": solvers.STOP_TEST.readbacks - reads0})


def elasticity(args, device, keep, kernels):
    import numpy as np
    import torch

    from chip_smoke import _cell_systems, beam_coeff, beam_rotation, make_beam
    from hommx_tpu_torch import MicroEngine, create_unit_cube
    from hommx_tpu_torch.ops.chol_kernel import fused_chol_solve_cuda

    hmm = make_beam(device)
    eng = hmm._engine
    Ks, Fs, _ = _cell_systems(eng, beam_coeff(False), hmm._sys.centers[:1080], beam_rotation)
    fused_chol_solve_cuda(Ks, Fs)
    keep({"tag": "k3_chunk", **profiled("k3_chunk", lambda: fused_chol_solve_cuda(Ks, Fs),
                                        kernels)})

    eng = MicroEngine(create_unit_cube(4), bs=3, coeff_kind="tensor4", dtype=torch.float32,
                      device=device)
    centers = torch.as_tensor(np.random.default_rng(1).uniform(0, 1, (8640, 3)),
                              dtype=torch.float32, device=device)
    coeff = beam_coeff(True)
    bench = lambda: eng.tensors_for_centers(coeff, centers, G_fn=beam_rotation, chunk=1080)
    bench()
    keep({"tag": "micro_bench", **profiled("micro_bench", bench, kernels)})
    return lambda: make_beam(device)


def micro16(device, keep, kernels):
    import numpy as np
    import torch

    from chip_smoke import beam_coeff, beam_rotation
    from hommx_tpu_torch import MicroEngine, create_unit_cube

    eng = MicroEngine(create_unit_cube(16), bs=3, coeff_kind="tensor4", solver="pcg",
                      pcg_strategy="matfree", cell_prec="mg", dtype=torch.float32,
                      device=device)
    coeff, rng = beam_coeff(True), np.random.default_rng(5)

    def run(cells, chunk):
        c = torch.as_tensor(rng.uniform(0, 1, (cells, 3)), dtype=torch.float32, device=device)
        with torch.no_grad():
            eng.tensors_for_centers(coeff, c, G_fn=beam_rotation, chunk=chunk)

    run(8, 8)  # warm-up
    for cells, chunk in ((8, 8), (128, 0)):
        keep({"tag": "mg16", "cells": cells, "chunk": chunk or eng._auto_chunk(cells),
              **profiled(f"mg16_{cells}", lambda: run(cells, chunk), kernels)})


def routes(args, device, keep, kernels):
    import torch

    from chip_smoke import flagship
    from hommx_tpu_torch import PoissonHMM, SolverOptions, create_unit_square

    cases = {"k1": (16, {}), "fft": (16, {"cell_prec": "fft"}), "p2": (8, {"micro_degree": 2})}
    for route, (micro_n, kw) in cases.items():
        def make():
            return PoissonHMM(create_unit_square(args.macro, args.macro), flagship, 1.0,
                              create_unit_square(micro_n, micro_n), 2**-5,
                              SolverOptions(rtol=1e-5, maxiter=20000), dtype=torch.float32,
                              device=device, chunk=2048, dedup_cells=False, engine_kwargs=kw)

        make().homogenized_tensors()  # warm-up
        hmm = make()
        keep({"tag": "route", "route": route, "micro_n": micro_n, "cells": args.macro**2 * 2,
              **profiled(f"micro_{route}", hmm.homogenized_tensors, kernels)})


def amg(args, device, keep, kernels):
    import torch

    from chip_smoke import flagship, jittered_delaunay
    from hommx_tpu_torch import PoissonHMM, SolverOptions, create_unit_square
    from hommx_tpu_torch.ops.amg import amg_setup, amg_vcycle

    mesh, t_del = jittered_delaunay(args.macro)
    hmm = PoissonHMM(mesh, flagship, 1.0, create_unit_square(args.micro, args.micro), 2**-5,
                     SolverOptions(rtol=1e-5, maxiter=20000), dtype=torch.float32,
                     device=device, chunk=2048)
    t0 = time.perf_counter()
    struct = hmm._sys.amg
    keep({"tag": "amg_build", "delaunay_s": t_del, "build_s": time.perf_counter() - t0,
          "timings": dict(struct.timings), "levels": struct.level_sizes,
          "dofs": hmm.function_space.num_dofs})
    hmm.solve()  # warm-up: the micro stage (then cached) and the device tables
    rec = profiled("macro_amg", hmm.solve, kernels)
    dg = hmm.diagnostics
    keep({"tag": "stage", **rec, "macro_seconds": dg["macro_seconds"],
          "macro_iterations": dg["macro_iterations"], "macro_steps": dg["macro_steps"]})
    vals, b = hmm._last_vals_bc, torch.ones(hmm.function_space.num_dofs, device=device)
    keep({"tag": "stage", **profiled("amg_setup", lambda: amg_setup(struct, vals), kernels)})
    state = amg_setup(struct, vals)
    reps = 10
    rec = profiled("vcycle", lambda: [amg_vcycle(struct, state, b) for _ in range(reps)],
                   kernels)
    keep({"tag": "stage", **rec, "launches_per_vcycle": rec["n_device_events"] / reps,
          "ms_per_vcycle": rec["wall_s"] / reps * 1e3})


def sharded(args, device, keep, kernels):
    import torch

    from chip_smoke import flagship
    from hommx_tpu_torch import PoissonHMM, ShardMesh, SolverOptions, create_unit_square

    shards = 4  # chip_smoke.py's sharded phase
    mesh = ShardMesh([device] * shards)

    def make(shard):
        return PoissonHMM(create_unit_square(args.macro, args.macro), flagship, 1.0,
                          create_unit_square(args.micro, args.micro), 2**-5,
                          SolverOptions(rtol=1e-5, maxiter=20000), dtype=torch.float32,
                          device=device, chunk=2048, dedup_cells=False, shard_mesh=shard)

    models = {}
    for label, shard in (("unsharded", None), ("sharded", mesh)):
        make(shard).homogenized_tensors()  # warm-up
        hmm = make(shard)
        keep({"tag": "micro", "run": label, **profiled(f"micro_{label}",
                                                        hmm.homogenized_tensors, kernels)})
        hmm.solve()  # warm-up of the macro stage
        models[label] = hmm
    for label in ("unsharded", "sharded", "sharded", "unsharded"):
        hmm = models[label]
        rec = profiled(f"macro_{label}", hmm.solve, kernels)
        dg = hmm.diagnostics
        keep({"tag": "macro", "run": label, "shards": shards if label == "sharded" else 1,
              **rec, "macro_seconds": dg["macro_seconds"],
              "macro_iterations": dg["macro_iterations"], "macro_steps": dg["macro_steps"]})


def fem3d(args, device, keep, kernels):
    """The fine FEM of ``hmm_3d.py`` at its 64³ default (274,625 dofs,
    float32 multigrid CG through K2): three solves, each with its set-up
    (MacroSystem, DIA view, hierarchy), assembly and solve seconds, CG
    iterations and the multigrid grids, then one under the profiler."""
    from hommx_tpu_torch import create_unit_cube
    from hommx_tpu_torch.examples import hmm_3d
    from hommx_tpu_torch.models.fem import fem_solve
    from hommx_tpu_torch.ops.function_space import FunctionSpace, boundary_dofs, dirichletbc

    V = FunctionSpace(create_unit_cube(2**6), 1)
    bcs = [dirichletbc(0.0, boundary_dofs(V), V)]

    def solve():
        return fem_solve(V, lambda x: hmm_3d.A(x, x / hmm_3d.eps), hmm_3d.f, bcs,
                         device=device)

    for rep in range(3):
        t0 = time.perf_counter()
        u = solve()
        keep({"tag": "solve", "rep": rep, "seconds": time.perf_counter() - t0,
              "dofs": V.num_dofs, **u.diagnostics, "iterations": u.solver_iterations,
              "mg_grids": [list(lev.grid) for lev in u.system.mg.levels]})
    keep({"tag": "stage", **profiled("fem3d", solve, kernels)})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=("poisson", "elasticity", "micro16", "routes", "amg",
                                       "sharded", "fem3d"), default="poisson")
    ap.add_argument("--macro", type=int, default=512)
    ap.add_argument("--micro", type=int, default=16)
    ap.add_argument("--pc", choices=("auto", "jacobi"), default="auto")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    out = args.out or str(ROOT / "chiprun_out" / f"profile_{args.mode}.json")

    import torch

    if not torch.cuda.is_available():
        print("profile_slice: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import emit, phase_build, phase_device

    from hommx_tpu_torch.micro import stencil_pcg
    from hommx_tpu_torch.ops import chol_kernel, dia

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    records = []

    def keep(rec):
        emit(rec)
        records.append(rec)

    name, smi = phase_device()
    records.append({"device": name, "nvidia_smi": smi})
    phase_build()
    kernels = {"stencil_pcg": stencil_pcg.KERNEL, "dia_spmv": dia.KERNEL,
               "chol_solve": chol_kernel.KERNEL}
    make = None
    if args.mode == "micro16":
        micro16(device, keep, kernels)
    elif args.mode == "routes":
        routes(args, device, keep, kernels)
    elif args.mode == "amg":
        amg(args, device, keep, kernels)
    elif args.mode == "sharded":
        sharded(args, device, keep, kernels)
    elif args.mode == "fem3d":
        fem3d(args, device, keep, kernels)
    else:
        make = (poisson if args.mode == "poisson" else elasticity)(args, device, keep, kernels)
    if make is not None:
        _solves_and_stages(args, make, keep, kernels)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as fh:
        json.dump(records, fh, indent=1)
    return 0


def _solves_and_stages(args, make, keep, kernels):
    import torch

    device = torch.device("cuda", 0)
    make().solve()  # warm-up
    for rep in range(3):
        hmm = make()
        hmm.solve()
        dg = hmm.diagnostics
        keep({"tag": "solve", "rep": rep, **{k: dg[k] for k in (
            "micro_seconds", "macro_seconds", "macro_iterations", "macro_residual",
            "num_cells")}, "cell_solves": dg["num_cells"] * hmm._engine.s})

    hmm = make()
    torch.cuda.reset_peak_memory_stats(device)
    keep({"tag": "stage", **profiled("micro", hmm.homogenized_tensors, kernels)})
    A_star = hmm.homogenized_tensors()
    keep({"tag": "stage", **profiled("guard", lambda: hmm._guard(A_star), kernels)})
    keep({"tag": "stage", **profiled("macro", hmm.solve, kernels)})
    keep({"tag": "memory", "peak_gib": torch.cuda.max_memory_allocated(device) / 2**30,
          "macro_iterations": hmm.diagnostics["macro_iterations"]})
    if args.mode == "poisson":
        macro_pc(make, A_star, keep, kernels)


if __name__ == "__main__":
    sys.exit(main())
