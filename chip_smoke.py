#!/usr/bin/env python3
"""Smoke run of the hommx_tpu_torch main path on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Phases (each prints one JSON line; any failure raises, exits non-zero and
prints no result line):

1. device      the card's name, and ``nvidia-smi`` name + power limit
2. build       the three CUDA kernels compiled from the repository's
               sources, one nvcc each, all started together
3. dia_spmv    K2 vs its plain version on the 512x512 macro DIA pattern
               (7 diagonals) and on a 62³ box (15 diagonals), with a
               cuSPARSE CSR matvec of the same matrix as yardstick: single
               call (as the CG makes it, and through ``dia_spmv_cuda``),
               back to back, 200 launches in one CUDA graph, and at a cold
               L2 (flushed by a write, and by a read)
4. stencil     K1 vs its plain version at the kernel's block size on one
               2048-cell chunk of the 16x16 micro engine (flagship
               coefficient), on a ragged 37-cell chunk and on a 1000-cell
               chunk of an 8x8x8 micro mesh; the first and the last timed,
               with one float32 matmul of Minv by the chunk's loads as a
               yardstick for the product alone
5. chol_solve  K3 (the blocked Cholesky over packed lower tiles) vs its
               plain version on (a) one 1080-cell chunk of the beam's
               equilibrated cell systems (n = 192, s = 6; timed, with
               torch.linalg.solve as yardstick, and the launch
               configuration, resident blocks per SM and ptxas's registers
               and spills), (b) a ragged 37-cell chunk on the 3x3x3 micro
               cube (n = 81), (c) the 2D 4x4 micro square (n = 32, s = 3),
               (d) a batch with one indefinite cell, (e) a well-conditioned
               random SPD batch at n = 192, s = 6, (f) the refinement sweep
               against its float64 model, with the unrefined plain version
               as the control that must fail, and (g) a well-conditioned
               SPD batch at the kernel's largest n (max_kernel_n(6) = 288)
6. golden      PoissonHMM golden configuration (8x8 macro, 8x8 micro) in
               float32 through K1 and the direct macro solve, vs the frozen
               float64 functionals
7. golden_elasticity  the elasticity_stratified_3d golden configuration in
               float32 through K3 and the float64 direct macro solve
8. slice       PoissonHMM on a 512x512 macro mesh (524,288 cells, 263,169
               dofs) with a 16x16 micro mesh, float32, Jacobi CG macro solve
               through K2 — cold then warm — with K1's and K2's launch
               counts, and A* on 4096 cells vs the plain PCG loop in float64
9. slice_elasticity  the rotated-fiber beam (LinearElasticityStratifiedHMM,
               20x6x6 macro box: 4320 cells, 3087 dofs; 4x4x4 micro cube:
               n = 192, s = 6) in float32, cold then warm, with K3's launch
               count; then the micro stage at the bench row's size (8640
               fresh cells, x-dependent fibre modulus, chunk 1080) and A* on
               512 of its cells vs the plain solve in float64

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
from concurrent.futures import ThreadPoolExecutor

# frozen float64 functionals (L2 norm, max|u|) of the golden poisson_hmm
# configuration, computed by the JAX reference package on the CPU
GOLDEN_POISSON_HMM = (0.13615178178157605, 0.26585257192673567)
GOLDEN_ELASTICITY_3D = (0.0003321179417961123, 0.05658411139956721)
GOLDEN_RTOL = 1e-4  # float32 on the card
GOLDEN_ELASTICITY_RTOL = 2e-3  # float32 elasticity, the bar of the TPU run
K1_RTOL = 5e-5  # A* relative error, kernel vs plain
K1_ITER_SLACK = 2
K2_RTOL = 1e-5  # max abs error / max |y|
K3_RTOL = 5e-5  # residual, A*, X where well-conditioned, X vs the refinement model
K3_PLAIN_FACTOR = 2.0  # kernel residual and float64 distance, at most this times plain's
SLICE_ASTAR_RTOL = 1e-4  # float32 slice vs plain float64 port

# NVIDIA H100 SXM peaks (data sheet, dense): float32 outside the tensor
# cores and device memory bandwidth, for each kernel's least time
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# the rotated-fiber beam (examples/linear_elasticity/rotated_fibers.py)
BEAM_L, BEAM_W, BEAM_H = 1.0, 0.4, 0.1


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


def bound(flops: float, nbytes: float) -> tuple:
    """(bound_ms, bound_by): the larger of the operation time at the
    float32 peak and the byte time at the memory peak."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")


def fibre(a, b):
    """Circular fibre cross-section in the (a, b) plane of the unit cell."""
    import torch

    da = torch.arccos(torch.cos(2 * torch.pi * (a - 0.5)))
    db = torch.arccos(torch.cos(2 * torch.pi * (b - 0.5)))
    return (da**2 + db**2) < ((2 * torch.pi) ** 2 / 16)


def beam_coeff(x_dependent: bool):
    """Hooke tensor of the beam: μ = 100 in the fibre (times 1 + 0.001·x₀
    for the bench row's x-dependent cell), 0.001 outside, λ = 1."""
    import torch

    from hommx_tpu_torch.utils.validation import hooke_tensor

    def mu(x, y):
        one = torch.ones((), dtype=y.dtype, device=y.device)
        stiff = 100.0 * (1.0 + 0.001 * x[0]) * one if x_dependent else 100.0 * one
        return torch.where(fibre(y[1], y[2]), stiff, 0.001 * one)

    return hooke_tensor(3, mu, lambda x, y: 1.0)


def beam_rotation(x):
    """Dθᵀ(x): rotation by γ = π/2 · x₁/W in the (0, 2) plane, transposed."""
    import torch

    g = 0.5 * torch.pi * x[1] / BEAM_W
    c, s = torch.cos(g), torch.sin(g)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, z, s]), torch.stack([z, o, z]),
                        torch.stack([-s, z, c])]).T


def clamp_x0(hmm):
    """Clamp every dof on the x₀ = 0 face."""
    import numpy as np

    from hommx_tpu_torch import dirichletbc
    from hommx_tpu_torch.ops.function_space import boundary_dofs

    V = hmm.function_space
    hmm.set_boundary_conditions(
        dirichletbc(np.zeros(V.bs), boundary_dofs(V, lambda x: np.isclose(x[0], 0)), V)
    )


def make_beam(device, macro_n=(20, 6, 6)):
    """The rotated-fiber beam of examples/linear_elasticity/rotated_fibers.py
    in float32: LinearElasticityStratifiedHMM on a macro box of
    ``macro_n`` cells per axis with a 4³ micro cube, f = (0, 0, −0.05·W²),
    clamped at x₀ = 0, no cell dedup."""
    import torch

    from hommx_tpu_torch import LinearElasticityStratifiedHMM, create_box, create_unit_cube

    macro = create_box([[0, 0, 0], [BEAM_L, BEAM_W, BEAM_H]], list(macro_n))
    f = torch.tensor([0.0, 0.0, -0.05 * (BEAM_W / BEAM_L) ** 2], dtype=torch.float64)
    hmm = LinearElasticityStratifiedHMM(macro, beam_coeff(False), lambda x: f,
                                        create_unit_cube(4), 2**-5, beam_rotation,
                                        dtype=torch.float32, device=device, dedup_cells=False)
    clamp_x0(hmm)
    return hmm


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
    from hommx_tpu_torch.ops import chol_kernel, dia

    kernels = {"stencil_pcg": stencil_pcg.KERNEL, "dia_spmv": dia.KERNEL,
               "chol_solve": chol_kernel.KERNEL}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernels)) as pool:
        for fut in [pool.submit(k.library) for k in kernels.values()]:
            fut.result()
    out = {"phase": "build", "wall_seconds": time.perf_counter() - t0}
    for key, kern in kernels.items():
        out[f"{key}_seconds"] = kern.build_seconds
        out[f"{key}_ptxas"] = [line.strip() for line in kern.build_log.splitlines()
                               if any(w in line for w in ("entry function", "registers", "spill"))]
    emit(out)


def _loop_us(fn, reps: int = 200) -> float:
    """µs per call of ``reps`` back-to-back calls between two events: the
    larger of the host's and the device's time per call."""
    import torch

    for _ in range(5):
        fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return 1e3 * a.elapsed_time(b) / reps


def _cold_l2_us(fn, device, reps: int = 50, clean: bool = False) -> float:
    """Median device time of one ``fn()`` after the L2 is flushed before
    each call by a 256 MB write (5× the H100's 50 MB L2), which leaves the
    L2 full of dirty lines that ``fn`` must write back as it evicts them,
    or with ``clean`` by a 256 MB read, which leaves clean lines."""
    import torch

    flush = torch.zeros(64 << 20, dtype=torch.float32, device=device)
    events = []
    for r in range(reps):
        if clean:
            flush.sum()
        else:
            flush.fill_(float(r))
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    return 1e3 * statistics.median(a.elapsed_time(b) for a, b in events)


def _graph_us(op, x, launches: int = 200):
    """K2's device time without the host path: ``launches`` launches into
    one preallocated buffer captured in one CUDA graph, replayed; µs per
    launch (median of 5 replays) and the buffer after the replays."""
    import torch

    buf = torch.empty_like(x)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream
        op(x, out=buf)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            op(x, out=buf)
    graph.replay()
    times = []
    for _ in range(5):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(1e3 * a.elapsed_time(b) / launches)
    return statistics.median(times), buf


def _k2_case(name, mesh, device, seed):
    """K2 on the macro DIA pattern of ``mesh`` with seeded random values:
    against its plain version and against a cuSPARSE CSR product of the
    same matrix, with its single-call, back-to-back, graph and cold-L2
    times."""
    import torch

    from hommx_tpu_torch.ops.dia import DIAOperator, build_dia_from_ell, dia_spmv, dia_spmv_cuda
    from hommx_tpu_torch.ops.sparse import build_ell_pattern

    dia = build_dia_from_ell(build_ell_pattern(mesh.cells, mesh.num_vertices))
    N, nd = dia.num_dofs, dia.num_diagonals
    g = torch.Generator(device=device).manual_seed(seed)
    vals = torch.randn((nd, N), generator=g, device=device, dtype=torch.float32)
    x = torch.randn((N,), generator=g, device=device, dtype=torch.float32)
    op = DIAOperator(vals, dia.offsets)  # as the macro CG makes it, once per solve
    y_k = op(x).clone()
    y_w = dia_spmv_cuda(vals, dia.offsets, x)
    y_p = dia_spmv(vals, dia.offsets, x)
    # the same matrix in CSR (entries whose column falls outside are
    # dropped, as the DIA product drops them) for the library yardstick
    rows = torch.arange(N, device=device).repeat(nd)
    cols = rows + torch.as_tensor(dia.offsets, device=device).repeat_interleave(N)
    inside = (cols >= 0) & (cols < N)
    csr = torch.sparse_coo_tensor(
        torch.stack([rows[inside], cols[inside]]), vals.reshape(-1)[inside], (N, N)
    ).coalesce().to_sparse_csr()
    y_l = csr @ x
    graph_us, y_g = _graph_us(op, x)
    torch.cuda.synchronize()
    ymax = float(y_p.abs().max())
    abs_err = float((y_k - y_p).abs().max())
    kernel_call = lambda: op(x, out=op.out)  # noqa: E731  (the CG's call)
    # each input read once, the output written once; 2 flops per entry
    bound_ms, bound_by = bound(2.0 * nd * N, 4.0 * (nd * N + 2 * N))
    rec = {"phase": "dia_spmv", "case": name, "N": N, "offsets": list(dia.offsets),
           "max_abs_err": abs_err, "rel_err": abs_err / ymax,
           "wrapper_rel_err": float((y_w - y_p).abs().max()) / ymax,
           "library_rel_err": float((y_l - y_p).abs().max()) / ymax,
           "graph_equal": bool(torch.equal(y_g, y_k)),
           "ms": time_ms(kernel_call),
           "wrapper_ms": time_ms(lambda: dia_spmv_cuda(vals, dia.offsets, x)),
           "plain_ms": time_ms(lambda: dia_spmv(vals, dia.offsets, x)),
           "library_ms": time_ms(lambda: csr @ x),
           "loop_us": _loop_us(kernel_call), "library_loop_us": _loop_us(lambda: csr @ x),
           "graph_us_per_launch": graph_us,
           "cold_l2_us": _cold_l2_us(kernel_call, device),
           "cold_l2_clean_us": _cold_l2_us(kernel_call, device, clean=True),
           "library_cold_l2_us": _cold_l2_us(lambda: csr @ x, device),
           "bound_ms": bound_ms, "bound_by": bound_by}
    emit(rec)
    ok = (rec["rel_err"] < K2_RTOL and rec["wrapper_rel_err"] < K2_RTOL
          and rec["library_rel_err"] < K2_RTOL and rec["graph_equal"])
    return rec, ok


def phase_dia(device):
    """K2 on the 512x512 macro pattern (7 diagonals, the slice's) and on a
    62³ box (250,047 dofs, 15 diagonals, 3D P1)."""
    from hommx_tpu_torch import create_unit_cube, create_unit_square

    main, ok = _k2_case("2d512", create_unit_square(512, 512), device, 2)
    rec3, ok3 = _k2_case("3d62", create_unit_cube(62), device, 3)
    if not (ok and ok3):
        raise AssertionError(f"DIA kernel, its graph replay or the CSR yardstick disagrees "
                             f"with the plain version: {main}, {rec3}")
    return main


def _k1_case(eng, centers, timed):
    """K1 vs its plain version at the kernel's own block size on one chunk
    of the main path's scaled system, both taken through the chunk's own
    clamp and A* contraction, with the iteration counts of each block side
    by side.  Timed: the kernel, the unblocked plain loop, the bound and
    ``prec_library_us``, one float32 ``torch.matmul`` of Minv by the chunk's
    (n, s·C) right-hand sides (TF32 off): a yardstick for one
    preconditioner apply of the chunk, not for the whole PCG."""
    import torch

    from hommx_tpu_torch.micro.chunk import chunk_system
    from hommx_tpu_torch.micro.stencil_pcg import launch_config, stencil_pcg_cuda, stencil_pcg_plain

    cs = chunk_system(eng, flagship, centers)
    ws_s, Fs = cs.scaled()
    args = (ws_s, Fs, cs.Minv, cs.st.shape, cs.st.offsets, eng.pcg_tol, eng.pcg_maxiter)
    n, s, C, K = eng.n_reduced, eng.s, centers.shape[0], len(cs.st.offsets)
    cfg = launch_config(n, s)
    Yk, itk = stencil_pcg_cuda(*args, per_block=True)
    Yp, itp = stencil_pcg_plain(*args, block=cfg.cells_per_block, per_block=True)
    itk = [int(k) for k in itk.cpu()]
    Ak, Ap = cs.astar(eng, Yk, max(itk)), cs.astar(eng, Yp, max(itp))
    torch.cuda.synchronize()
    abs_err = float((Ak - Ap).abs().max())
    slack = max(abs(a - b) for a, b in zip(itk, itp))
    rec = {"cells": C, "dim": eng.d, "n": n, "K": K, "s": s,
           "cells_per_block": cfg.cells_per_block, "threads": cfg.threads,
           "rows_per_thread": cfg.rows_per_thread, "smem_bytes": cfg.smem_bytes,
           "iters_kernel": max(itk), "iters_plain": max(itp),
           "iters_per_block": [list(p) for p in zip(itk, itp)],
           "iters_max_block_diff": slack, "max_abs_err": abs_err,
           "rel_err": abs_err / float(Ap.abs().max())}
    if timed:
        rec["ms"] = time_ms(lambda: stencil_pcg_cuda(*args), reps=20)
        rec["plain_ms"] = time_ms(lambda: stencil_pcg_plain(*args), reps=5, warmup=1)
        R2 = Fs.reshape(n, s * C).contiguous()
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        rec["prec_library_us"] = 1e3 * time_ms(lambda: torch.matmul(cs.Minv, R2), reps=50)
        torch.backends.cuda.matmul.allow_tf32 = tf32
        # this run's work: iters + 2 preconditioner products 2n²sC (the
        # first iterate, its residual, one per iteration) and iters + 1
        # stencil matvecs 2KnsC, at each block's own count; bytes: weights,
        # loads, K0⁻¹ read, X written
        cb = cfg.cells_per_block
        flops = sum(min(cb, C - b * cb) * ((it + 2) * 2.0 * n * n * s + (it + 1) * 2.0 * K * n * s)
                    for b, it in enumerate(itk))
        rec["gflop"] = flops / 1e9
        rec["bound_ms"], rec["bound_by"] = bound(flops, 4.0 * (K * n * C + 2 * n * s * C + n * n))
    ok = (math.isfinite(rec["rel_err"]) and rec["rel_err"] < K1_RTOL and slack <= K1_ITER_SLACK)
    return rec, ok


def phase_stencil(device):
    """K1 at the main path's chunk (16x16 micro, 2048 cells), at a ragged
    chunk (padded blocks) and on an 8x8x8 micro mesh (n = 512, s = 3,
    K = 15: the widest shape, 8 cells a block); the first and the last
    timed."""
    import numpy as np
    import torch

    from hommx_tpu_torch import MicroEngine, create_unit_cube, create_unit_square

    rng = np.random.default_rng(0)
    eng2 = MicroEngine(create_unit_square(16, 16), device=device, dtype=torch.float32)
    eng3 = MicroEngine(create_unit_cube(8), device=device, dtype=torch.float32)
    cases = (("2d16_C2048", eng2, 2048, True), ("2d16_C37", eng2, 37, False),
             ("3d8_C1000", eng3, 1000, True))
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


def _plain_unrefined(Ks, Fs):
    """The plain version without its refinement sweep: the control that
    shows whether a check can see the sweep."""
    from hommx_tpu_torch.ops.batched_chol import _pad_spd, blocked_cho_solve, blocked_cholesky

    Kp, Bp, n = _pad_spd(Ks, Fs.permute(2, 0, 1), 32)
    panels, dinvs = blocked_cholesky(Kp, 32)
    return blocked_cho_solve(panels, dinvs, Bp, 32)[:, :n].permute(1, 2, 0)


def _k3_compare(Ks, Fs, ok_cells=None, astar=None, strict=False):
    """K3 against its plain version on one batch of equilibrated cell
    systems.  The fibre cells keep condition numbers near 1e6 after the
    equilibration, so two correct float32 solves differ by percents in X
    itself (forward error ~ κ·eps; the plain version is that far from the
    float64 solution too).  What a correct float32 solve meets is checked:
    the kernel's residual ‖F − K X‖∞/‖F‖∞ (in float64) under K3_RTOL and
    within K3_PLAIN_FACTOR of the plain version's; its distance to the
    float64 solution within K3_PLAIN_FACTOR of the plain version's; and,
    where ``astar`` maps a solve to A*, A*'s relative difference.
    ``strict`` also holds X itself to the bar (well-conditioned batches).
    The checks cover the cells in ``ok_cells`` (all by default); the whole
    output must be finite."""
    import torch

    from hommx_tpu_torch.ops.chol_kernel import fused_chol_solve_cuda, fused_chol_solve_plain

    Xk = fused_chol_solve_cuda(Ks, Fs)
    Xp = fused_chol_solve_plain(Ks, Fs)
    torch.cuda.synchronize()
    sel = slice(None) if ok_cells is None else torch.as_tensor(ok_cells, device=Ks.device)
    K64, F64 = Ks[sel].double(), Fs[:, :, sel].double()

    def residual(X):
        R = F64 - torch.einsum("cij,jsc->isc", K64, X[:, :, sel].double())
        return float(R.abs().max() / F64.abs().max())

    def x_rel(X, Y):
        return float((X[:, :, sel] - Y).abs().max() / Y.abs().max())

    # what a float32 solve of these cells can reach: their condition
    # numbers, and each solve's distance to the float64 solution
    ev = torch.linalg.eigvalsh(K64)
    L64 = torch.linalg.cholesky(K64)
    X64 = torch.cholesky_solve(F64.permute(2, 0, 1).contiguous(), L64).permute(1, 2, 0)
    x_abs = float((Xk[:, :, sel] - Xp[:, :, sel]).abs().max())
    rec = {"finite": bool(torch.isfinite(Xk).all()),
           "x_max_abs_err": x_abs, "x_rel_err": x_abs / float(Xp[:, :, sel].abs().max()),
           "residual": residual(Xk), "plain_residual": residual(Xp),
           "plain_unrefined_residual": residual(_plain_unrefined(Ks, Fs)),
           "cond_max": float((ev[:, -1] / ev[:, 0]).max()),
           "x_rel_err_f64": x_rel(Xk.double(), X64), "plain_x_rel_err_f64": x_rel(Xp.double(), X64)}
    ok = (rec["finite"] and rec["residual"] < K3_RTOL
          and rec["residual"] <= K3_PLAIN_FACTOR * rec["plain_residual"]
          and rec["x_rel_err_f64"] <= K3_PLAIN_FACTOR * rec["plain_x_rel_err_f64"])
    if astar is not None:
        Ak, Ap = astar(Xk), astar(Xp)
        rec["max_abs_err"] = float((Ak - Ap).abs().max())
        rec["astar_rel_err"] = rec["max_abs_err"] / float(Ap.abs().max())
        ok = ok and rec["astar_rel_err"] < K3_RTOL
    else:
        rec["max_abs_err"] = x_abs
    if strict:
        ok = ok and rec["x_rel_err"] < K3_RTOL
    return rec, ok


def _k3_refinement(device, n, s, C=64):
    """The refinement sweep made visible: K = S + N with S SPD and N a small
    antisymmetric part.  A factorization reads one triangle of K, that is
    the symmetric M = S ± (the triangle of N, mirrored), while the sweep
    R = F − K X runs against the full K, so the sweep moves X by percents,
    far above float32 rounding.  X is held to the float64 model of one
    sweep, X₀ = M⁻¹F, X = X₀ + M⁻¹(F − K X₀), with M from the upper or
    the lower triangle (either reads a symmetric input right); the plain
    version must meet its model too, and the plain version without the
    sweep must miss both by over 100× the bar, else this check could not
    see a kernel that skips the sweep."""
    import torch

    from hommx_tpu_torch.ops.chol_kernel import fused_chol_solve_cuda, fused_chol_solve_plain

    g = torch.Generator(device=device).manual_seed(11)
    f64 = dict(generator=g, device=device, dtype=torch.float64)
    G = torch.randn((C, n, n), **f64)
    W = torch.randn((C, n, n), **f64) * (0.02 / n**0.5)
    K = G @ G.transpose(1, 2) / n + torch.eye(n, device=device) + W - W.transpose(1, 2)
    F = torch.randn((n, s, C), **f64)
    Fb = F.permute(2, 0, 1)

    def model(M):
        L = torch.linalg.cholesky(M)
        X0 = torch.cholesky_solve(Fb, L)
        return (X0 + torch.cholesky_solve(Fb - K @ X0, L)).permute(1, 2, 0)

    models = (model(torch.triu(K) + torch.triu(K, 1).transpose(1, 2)),
              model(torch.tril(K) + torch.tril(K, -1).transpose(1, 2)))

    def err(X):  # relative distance to the nearer model
        return min(float((X.double() - Xm).abs().max() / Xm.abs().max()) for Xm in models)

    K32, F32 = K.float(), F.float()
    Xk = fused_chol_solve_cuda(K32, F32)
    rec = {"kernel_err": err(Xk), "plain_err": err(fused_chol_solve_plain(K32, F32)),
           "unrefined_err": err(_plain_unrefined(K32, F32)),
           "models_gap": float((models[0] - models[1]).abs().max() / models[0].abs().max()),
           "finite": bool(torch.isfinite(Xk).all())}
    rec["max_abs_err"] = rec["kernel_err"]
    ok = (rec["finite"] and rec["kernel_err"] < K3_RTOL and rec["plain_err"] < K3_RTOL
          and rec["unrefined_err"] > 100 * K3_RTOL)
    return {"phase": "chol_solve", "case": f"f_refinement_C{C}_n{n}", "cells": C, "n": n,
            "s": s, **rec}, ok


def _cell_systems(eng, coeff, centers, G_fn=None):
    """The equilibrated (Ks, Fs) of one chunk of centers on the main path's
    Cholesky route, and the map from a solve of them to A*."""
    from hommx_tpu_torch.micro.chunk import chol_system

    cs = chol_system(eng, coeff, centers, G_fn)
    Ks, Fs, sc = cs.equilibrated(eng)
    return Ks, Fs, lambda X: cs.astar(eng, X * sc[:, None, :])


def _spd_batch(device, C, n, s, seed):
    """A well-conditioned random SPD batch: K (C, n, n), F (n, s, C)."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    G = torch.randn((C, n, n), generator=g, device=device)
    K = G @ G.transpose(1, 2) / n + torch.eye(n, device=device)
    return K, torch.randn((n, s, C), generator=g, device=device)


def _ptxas_lines(kernel) -> list:
    """ptxas's registers and spills from ``kernel``'s build in this process."""
    return [line.strip() for line in kernel.build_log.splitlines()
            if any(w in line for w in ("registers", "spill"))]


def phase_chol(device, chunk: int = 1080):
    """K3 at the beam's chunk (timed), on a ragged chunk of the 3³ cube, on
    the 2D 4² square, on a batch with one indefinite cell, on a
    well-conditioned random batch at the beam's n and s, against the
    float64 model of its refinement sweep, and at its largest n."""
    import numpy as np
    import torch

    from hommx_tpu_torch import MicroEngine, create_box, create_unit_cube, create_unit_square
    from hommx_tpu_torch.ops import chol_kernel
    from hommx_tpu_torch.ops.chol_kernel import fused_chol_solve_cuda, fused_chol_solve_plain
    from hommx_tpu_torch.utils.validation import hooke_tensor

    def engine(mesh):
        return MicroEngine(mesh, bs=mesh.dim, coeff_kind="tensor4", dtype=torch.float32,
                           device=device)

    def centers_of(C, d, seed):
        rng = np.random.default_rng(seed)
        return torch.as_tensor(rng.uniform(0, 1, (C, d)), dtype=torch.float32, device=device)

    failed, main = [], None
    # (a) the first 1080 cells of the beam, as the beam's solve builds them
    eng = engine(create_unit_cube(4))
    macro = create_box([[0, 0, 0], [BEAM_L, BEAM_W, BEAM_H]], [20, 6, 6])
    centers = torch.as_tensor(macro.vertices[macro.cells].mean(axis=1)[:chunk],
                              dtype=torch.float32, device=device)
    Ks, Fs, astar = _cell_systems(eng, beam_coeff(False), centers, beam_rotation)
    rec, ok = _k3_compare(Ks, Fs, astar=astar)
    C, n, s = centers.shape[0], eng.n_reduced, eng.s
    # factor n³/3, four triangular solves n²s, the refinement matvec 2n²s;
    # Ks read once, Fs read and X written
    flops = C * (n**3 / 3 + 4.0 * n * n * s + 2.0 * n * n * s)
    bound_ms, bound_by = bound(flops, 4.0 * C * (n * n + 2 * n * s))
    Fb = Fs.permute(2, 0, 1).contiguous()
    cfg = chol_kernel.chol_launch_config(n, s)
    main = {"phase": "chol_solve", "case": f"a_beam_C{C}", "cells": C, "n": n, "s": s,
            "threads": cfg.threads, "panels": cfg.panels, "smem_bytes": cfg.smem_bytes,
            "blocks_per_sm_config": cfg.blocks_per_sm,
            "blocks_per_sm": chol_kernel.blocks_per_sm(cfg),
            "ptxas": _ptxas_lines(chol_kernel.KERNEL), **rec,
            "ms": time_ms(lambda: fused_chol_solve_cuda(Ks, Fs), reps=20),
            "plain_ms": time_ms(lambda: fused_chol_solve_plain(Ks, Fs), reps=5, warmup=1),
            "library_ms": time_ms(lambda: torch.linalg.solve(Ks, Fb), reps=20),
            "bound_ms": bound_ms, "bound_by": bound_by, "gflop": flops / 1e9}
    emit(main)
    if not ok:
        failed.append(main["case"])
    # (b) ragged chunk on the 3³ micro cube (n = 81), bench coefficient
    Ks, Fs, astar = _cell_systems(engine(create_unit_cube(3)), beam_coeff(True),
                                  centers_of(37, 3, 5), beam_rotation)
    cases = [("b_cube3_C37", Ks, Fs, None, astar, False)]
    # (c) 2D elasticity on the 4² micro square (n = 32, s = 3)

    def mu2(x, y):
        one = torch.ones((), dtype=y.dtype, device=y.device)
        inc = (y[0] - 0.5) ** 2 + (y[1] - 0.5) ** 2 < 0.09
        return torch.where(inc, 50.0 * (1.0 + 0.2 * x[0]) * one,
                           0.5 + 0.3 * torch.sin(2 * torch.pi * y[1]))

    Ks2, Fs2, astar2 = _cell_systems(engine(create_unit_square(4)),
                                     hooke_tensor(2, mu2, lambda x, y: 1.0), centers_of(200, 2, 6))
    cases.append(("c_square4_C200", Ks2, Fs2, None, astar2, False))
    # (d) case (b) with the last pivot of cell 3 made negative
    Kd = Ks.clone()
    Kd[3, -1, -1] = -Kd[3, -1, -1]
    cases.append(("d_indefinite_cell3", Kd, Fs, [c for c in range(Ks.shape[0]) if c != 3],
                  None, False))
    # (e) well-conditioned SPD batch at the beam's n and s: X itself agrees
    Ke, Fe = _spd_batch(device, 256, n, s, 7)
    cases.append((f"e_spd_C256_n{n}", Ke, Fe, None, None, True))
    # (g) the same at the kernel's largest n: the limit runs
    n_max = chol_kernel.max_kernel_n(s)
    Kg, Fg = _spd_batch(device, 264, n_max, s, 8)
    cases.append((f"g_spd_C264_n{n_max}", Kg, Fg, None, None, True))
    for name, K, F, ok_cells, amap, strict in cases:
        rec, ok = _k3_compare(K, F, ok_cells, amap, strict)
        emit({"phase": "chol_solve", "case": name, "cells": K.shape[0], "n": K.shape[1],
              "s": F.shape[1], **rec})
        if not ok:
            failed.append(name)
    # (f) the refinement sweep, against its float64 model
    rec, ok = _k3_refinement(device, n, s)
    emit(rec)
    if not ok:
        failed.append(rec["case"])
    if failed:
        raise AssertionError(f"Cholesky kernel disagrees with its plain version: {failed}")
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


def phase_golden_elasticity(device):
    """The elasticity_stratified_3d golden (5x2x2 box, 3³ micro cube) in
    float32 on the card; the functional is the golden test's: the L2 norm
    of the solution array read as a scalar P1 function, and max |u|."""
    import torch

    from hommx_tpu_torch import LinearElasticityStratifiedHMM, create_box, create_unit_cube
    from hommx_tpu_torch.ops.assembly import l2_norm_fn

    macro = create_box([[0, 0, 0], [BEAM_L, BEAM_W, BEAM_H]], [5, 2, 2])
    f = torch.tensor([0.0, 0.0, -0.008], dtype=torch.float64)
    hmm = LinearElasticityStratifiedHMM(macro, beam_coeff(False), lambda x: f,
                                        create_unit_cube(3), 2**-5, beam_rotation,
                                        dtype=torch.float32, device=device)
    clamp_x0(hmm)
    u = hmm.solve().array
    l2 = float(l2_norm_fn(hmm._sys.verts64, hmm._sys.cells, u.double()))
    umax = float(u.abs().max())
    rel = [abs(g - w) / abs(w) for g, w in zip((l2, umax), GOLDEN_ELASTICITY_3D)]
    emit({"phase": "golden_elasticity", "l2": l2, "max_u": umax, "rel_err": rel,
          "macro_method": hmm._macro_method, "solver": hmm._engine.solver})
    if not all(math.isfinite(r) and r < GOLDEN_ELASTICITY_RTOL for r in rel):
        raise AssertionError(f"elasticity golden functionals off: {rel}")


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
        k2_before = dia.KERNEL.launches
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
               "dia_spmv_launches": dia.KERNEL.launches - k2_before,
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
        # the CG's initial residual and one product per iteration
        if not (finite and dg["macro_iterations"] < opts.maxiter
                and rec["dia_spmv_launches"] == dg["macro_iterations"] + 1
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


def phase_slice_elasticity(device, macro_n=(20, 6, 6), cells: int = 8640, chunk: int = 1080,
                           checked: int = 512):
    """The rotated-fiber beam through LinearElasticityStratifiedHMM, cold
    then warm; then the micro stage at the bench row's size and A* on
    ``checked`` of its cells against the plain solve in float64."""
    import numpy as np
    import torch

    from hommx_tpu_torch import MicroEngine, create_unit_cube
    from hommx_tpu_torch.micro.chunk import tensors_chunk_chol_plain
    from hommx_tpu_torch.micro.krylov import _map_chunked
    from hommx_tpu_torch.ops import chol_kernel

    micro = create_unit_cube(4)
    chol_kernel.KERNEL.launches = 0
    for label in ("cold", "warm"):
        t0 = time.perf_counter()
        hmm = make_beam(device, macro_n)
        t_setup = time.perf_counter() - t0
        u = hmm.solve().array
        torch.cuda.synchronize()
        t_total = time.perf_counter() - t0
        dg = hmm.diagnostics
        cell_solves = dg["num_cells"] * hmm._engine.s
        vals = u.reshape(-1, 3)
        rec = {"phase": f"slice_elasticity_{label}", "setup_seconds": t_setup,
               "total_seconds": t_total, "micro_seconds": dg["micro_seconds"],
               "macro_seconds": dg["macro_seconds"], "num_cells": dg["num_cells"],
               "dofs": hmm.function_space.num_dofs, "n_reduced": hmm._engine.n_reduced,
               "chunk": hmm._engine._auto_chunk(dg["num_cells"]),
               "cell_solves": cell_solves,
               "cell_solves_per_s": cell_solves / dg["micro_seconds"],
               "diverged_cells": int(dg["diverged_cells"].size),
               "fallback_cells": int(dg["fallback_cells"].size),
               "nan_cells": int(dg["nan_cells"].size),
               "finite": bool(torch.isfinite(u).all()), "max_u": float(u.abs().max()),
               "tip_uz_min": float(vals[:, 2].min())}
        emit(rec)
        # fallback_cells is printed for the record only: the zero-corrector
        # fallback is the PCG clamp's, and the direct route reports none
        if not (rec["finite"] and rec["diverged_cells"] == 0 and rec["nan_cells"] == 0):
            raise AssertionError(f"beam run failed its checks: {rec}")
    launches = chol_kernel.KERNEL.launches
    if launches < 1:
        raise AssertionError("the beam never launched the Cholesky kernel")

    # the micro stage at the bench row's size: 8640 fresh cells
    eng = MicroEngine(micro, bs=3, coeff_kind="tensor4", dtype=torch.float32, device=device)
    centers = torch.as_tensor(np.random.default_rng(1).uniform(0, 1, (cells, 3)),
                              dtype=torch.float32, device=device)
    coeff_x = beam_coeff(True)
    chol_kernel.KERNEL.launches = 0
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        A32 = eng.tensors_for_centers(coeff_x, centers, G_fn=beam_rotation, chunk=chunk)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    stage_launches = chol_kernel.KERNEL.launches
    idx = torch.linspace(0, cells - 1, checked, device=device).round().long()
    eng64 = MicroEngine(micro, bs=3, coeff_kind="tensor4", dtype=torch.float64, device=device)
    A64 = _map_chunked(lambda c: tensors_chunk_chol_plain(eng64, coeff_x, c, beam_rotation),
                       centers[idx].double(), checked)
    rel = float((A32[idx].double() - A64).abs().max() / A64.abs().max())
    rec = {"phase": "micro_elasticity", "cells": cells, "chunk": chunk,
           "seconds": times, "cell_solves_per_s": [cells * eng.s / t for t in times],
           "k3_launches": stage_launches, "checked_cells": checked, "astar_rel_err_f64": rel,
           "finite": bool(torch.isfinite(A32).all())}
    emit(rec)
    if not (rec["finite"] and stage_launches >= 1 and rel < SLICE_ASTAR_RTOL):
        raise AssertionError(f"bench-size micro stage failed its checks: {rec}")
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
    k3 = phase_chol(device)
    phase_golden(device)
    phase_golden_elasticity(device)
    launches = phase_slice(device)
    launches["chol_solve"] = phase_slice_elasticity(device)
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    kernels = [
        {"name": "stencil_pcg", "route": "cuda",
         "source": "hommx_tpu_torch/micro/csrc/stencil_pcg.cu",
         "replaces": "hommx_tpu/micro/stencil_pcg.py:81",
         "launches": launches["stencil_pcg"], **{k: k1[k] for k in keys}, "library_ms": None},
        {"name": "dia_spmv", "route": "cuda",
         "source": "hommx_tpu_torch/ops/csrc/dia_spmv.cu",
         "replaces": "hommx_tpu/ops/dia.py:145",
         "launches": launches["dia_spmv"], **{k: k2[k] for k in keys},
         "library_ms": k2["library_ms"]},
        {"name": "chol_solve", "route": "cuda",
         "source": "hommx_tpu_torch/ops/csrc/chol_solve.cu",
         "replaces": "hommx_tpu/ops/chol_kernel.py:451",
         "launches": launches["chol_solve"], **{k: k3[k] for k in keys},
         "library_ms": k3["library_ms"]},
    ]
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
