#!/usr/bin/env python3
"""Smoke run of the hommx_tpu_torch main path on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Phases (each prints one JSON line; any failure raises, exits non-zero and
prints no result line):

1. device      the card's name, and ``nvidia-smi`` name + power limit
2. build       the three CUDA kernels compiled from the repository's
               sources, one nvcc each, all started together
3. dia_spmv    K2 vs its plain version on the 512x512 macro DIA pattern
               (7 diagonals), on a 62³ box (15 diagonals) and on the
               jittered 512² Delaunay mesh of phase amg (9 diagonals), with a
               cuSPARSE CSR matvec of the same matrix as yardstick: single
               call (as the CG makes it, and through ``dia_spmv_cuda``),
               back to back, 200 launches in one CUDA graph, and at a cold
               L2 (flushed by a write, and by a read); then K2's float64
               instance the same way on the 512x512 pattern and on the
               40x12x12 elasticity pattern (bs = 3), against the float64
               CSR product; and K2 at a shard's shape of the 4-shard CG,
               float32 on the 512x512 pattern (``shard512``) and float64 on
               the beam's (``beam40x12x12_f64_shard``), against its plain
               version and the whole system's plain product
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
               as the control that must fail, (g) a well-conditioned SPD
               batch at the small instance's largest n (max_small_n(6) =
               288), and (h) the large instance (n above 288): SPD batches
               at n = 289, 512 (s = 3), 648, 1536 and 3000, the beam's
               cells on the 5³, 6³ and 8³ cubes and the 2D inclusion's on
               the 16² square at their chunks (timed, with the bound, the
               workspace's traffic and torch.linalg.solve), a ragged 37
               cells, an indefinite cell at n = 648
6. golden      PoissonHMM golden configuration (8x8 macro, 8x8 micro) in
               float32 through K1 and the direct macro solve, vs the frozen
               float64 functionals
7. golden_elasticity  the elasticity_stratified_3d golden configuration in
               float32 through K3 and the float64 direct macro solve
8. slice       PoissonHMM on a 512x512 macro mesh (524,288 cells, 263,169
               dofs) with a 16x16 micro mesh, float32, Jacobi CG macro solve
               through K2 — cold then warm — with K1's and K2's launch
               counts, and A* on 4096 cells vs the plain PCG loop in float64
   slice_mg    the same slice with the default solver options (multigrid
               CG, rtol 1e-5), cold then warm: iterations, loop steps, host
               readbacks, K2 launches, the hierarchy's grids, mg_setup's
               seconds, the multigrid and Jacobi CG loops at host check
               intervals of 16, 4 and 1, and u against a float64 multigrid
               CG solve of the same system (through K2's float64 instance)
               and against the Jacobi run's u
9. slice_elasticity  the rotated-fiber beam (LinearElasticityStratifiedHMM,
               20x6x6 macro box: 4320 cells, 3087 dofs; 4x4x4 micro cube:
               n = 192, s = 6) in float32, cold then warm, with K3's launch
               count; then the micro stage at the bench row's size (8640
               fresh cells, x-dependent fibre modulus, chunk 1080) and A* on
               512 of its cells vs the plain solve in float64
   slice_elasticity_cg  the beam on a 40x12x12 macro box (34,560 cells,
               20,787 dofs) with default options: K3's micro stage, then
               the float64 multigrid CG through K2's float64 instance, held
               against a float64 LU solve of the same system (and beside
               the direct route's Cholesky of its symmetric part)
10. default-argument runs (cell dedup on, the models' default):
   slice_default  the flagship of slice_mg with dedup: unique cells (2 per
               macro column), the fingerprint's seconds; A*, the float64
               solutions of both systems and u against slice_mg's run
   golden_stratified  the poisson_stratified golden (PoissonStratifiedHMM,
               8x8 macro, 8x8 micro) in float32 through K1
   slice_stratified  examples/diffusion/laminate.py's coefficient and map
               (contrast 100), Darcy boundary conditions, 512x512 macro,
               30x30 micro (K1 at n = 900): unique cells, K1's iterations
               per block, diverged cells
   slice_stratified_full  the same at 128x128 with dedup off (every cell
               through K1) and on: u against u, A* of 1024 cells against the
               plain route in float64
   slice_elasticity_dedup  the beam with dedup at 20x6x6 and at 40x12x12
               (with the audit, dedup_verify=8), A* and u against the
               dedup-off runs of slice_elasticity and slice_elasticity_cg

11. the periodic, FEM and per-cell slice (float32 unless stated):
   fem_flagship  examples/hmm.py's fine-mesh reference at 1024x1024 on the
               5x5 rectangle (1,050,625 dofs, A(x, x/ε), ε = 1/32, f = 0,
               Darcy BCs) through fem_solve with the default options
               (multigrid CG, K2), held to a float64 multigrid CG solve of
               its system; the example's 15x15 HMM against it (relative L2)
   golden_periodic_fem  the goldens periodic_tensor (PoissonPeriodicHMM
               through K1) and fem (PoissonFEM, 32x32)
   periodic_identity  PoissonPeriodicHMM against PoissonHMM (dedup on: one
               unique cell) for A = 2 + sin 2πy₀, 512x512 macro, 16x16
               micro: u and the assembled macro ELL values
   elasticity_periodic  ElasticityPeriodicHMM with the beam's Hooke tensor
               (rotation frozen at x = 0) on the 4³ cube (K3) and the
               40x12x12 beam box (float64 multigrid CG, K2 f64), A_hom
               against the float64 plain route; LinearElasticityFEM against
               LinearElasticityHMM with one constant Hooke tensor, 20x6x6
   chol_batched  the 8640-cell elasticity micro stage with
               HOMMX_CHOL_SOLVE_BATCH=1 (one K3 launch over the whole batch)
               against the in-chunk route, the launch timed
   kc_gather   the fixed-order Kc assembly (the CUDA default): two identical
               dedup solves of the 40x12x12 beam bitwise equal, gather
               against scatter, the 8640-cell stage in turns

12. differentiation (J = Σu², θ a parameter of the coefficient, float32
   on the card, each float64 reference on the CPU through the plain
   versions; the forward and backward passes' seconds, peak memory and
   each kernel's launches per pass):
   pipeline_grad  PoissonHMM.build_pipeline on the 512x512 slice (16x16
               micro, default options, A = 1.1 + θx₀ + sin 2πy₀): u
               against solve() with dedup off, dJ/dθ (a first pass and a
               warm one) through K1 and the
               multigrid CG through K2 forward and adjoint (K1's iterations
               and time per launch, the adjoint CG's iterations) against a
               central difference; at 64x64 against the CPU's float64
               gradient; d²J/dθ² at 8x8 (K1 twice, the direct macro solve)
               against the CPU's float64 value
   pipeline_grad_elasticity  the 20x6x6 rotated-fibre beam, θ scaling the
               fibre modulus: dJ/dθ through K3 forward and adjoint against
               the CPU's float64 gradient
   fem_grad    fem_solve_fn on fem_flagship's 1024x1024 configuration
               (A = 1.1 + θx₀ + sin(2πx₀/ε)): dJ/dθ through the multigrid
               CG (K2 forward and adjoint) against a central difference; at
               64x64 against the CPU's float64 gradient

13. the FFT cell preconditioner and P2 elements (float32 unless stated;
   cuFFT through torch.fft; K1 launches must be 0 on every FFT and P2
   run):
   micro_fft   benchmarks/suite.py's stratified configuration (48² macro,
               24² micro, the wavy laminate, dedup off) on the FFT route
               beside K1's: iterations per chunk and per block, A* of every
               cell against the float64 Cholesky route, u against the
               float64 solve of its system; the 512² flagship on the FFT
               route (multigrid CG through K2) beside K1's micro stage; the
               block symbol on the 20x6x6 beam's cells (4³ cube) with the
               dense-K and block-stencil matvecs against the K3 route's
               float64 A*; the contrast-1e5 stiff-fibre cells at 8³ in
               float64 (iterations, fallback cells)
   p2          the 512² flagship with P2 cells on 8² (matrix-free gather,
               K0⁻¹), the beam with P2 cells on the 2³ cube through K3 and
               the 8640-cell stage beside the P1 4³ one, PoissonFEM(degree=2)
               L2 rates (8², 16², 31²), the 513² P2 system by the Jacobi CG
               against its float64 solve

14. the unstructured macro path (smoothed-aggregation AMG preconditioning
   the macro CG; plain torch with fixed-order gathers, float32 unless
   stated):
   amg         (a) examples/diffusion/unstructured.py at 512² (jittered
               Delaunay, 263,169 dofs; PoissonHMM, 16² micro, dedup on),
               cold then warm: setup seconds (Delaunay, MacroSystem, the
               AMG host build), levels, amg_setup seconds, iterations, ms
               per V-cycle, K1's and K2's launches; u against the float64
               solve of its own system (through the ELL gather, not K2)
               and the structured 512² u at its nodes; Jacobi CG's iterations; two identical macro solves
               bitwise equal.  (b) a random-point Delaunay mesh of 263,169
               vertices (no DIA view) through PoissonFEM.  (c)
               PoissonFEM(degree=2) at 256² with pc='auto'.  (d)
               LinearElasticityFEM(degree=2) on the 20x6x6 beam box
               (float64, six rigid modes, beside the translations).  (e)
               build_pipeline's dJ/dθ on a 64² jittered mesh through K1 and
               the AMG-CG against the CPU's float64 gradient

15. multi-device solves, on ``ShardMesh(["cuda:0"] * 4)``: four
   logical shards on the one card, each with its own K1/K3 block and K2
   launch; float32 unless stated:
   sharded     (a) the 512² slice (16² micro, slice_mg's options, dedup
               off) sharded against unsharded, each solved twice: A*, u
               against the float64 solve of its own system, iterations,
               K2 launches = 4 × the CG's products (its loop steps and
               each solve's initial residual), K1's launches; the
               same on ``device_mesh()`` (one card) bitwise equal to the
               unsharded u.  (b) build_pipeline's dJ/dθ at 64² in 'auto'
               mode against the unsharded gradient; the 512² forward in
               'shard_map' mode against 'auto'.  (c) the 40x12x12 beam's
               float64 multigrid CG sharded (K3 per shard, K2 f64 per
               shard) against the unsharded u.  (d)
               ``dryrun_multichip(4)``, whose launches count nowhere: each
               of its checks also runs the unsharded pipeline.  Phase dia
               holds K2 at a shard's shapes (``shard512``,
               ``beam40x12x12_f64_shard``).

16. the native host runtime and the utilities:
   host_native  on the card machine's CPU, each native route against its
               numpy version, three times each in turns, outputs equal:
               the ELL pattern of the 512² slice and of the 1024² FEM, the
               periodic map of the 30² micro mesh and of a P2 point set,
               the aggregation of phase amg's jittered 512² mesh, the
               location of 10⁴ seeded points on it; the slice's and the
               FEM's MacroSystem with and without HOMMX_TPU_NO_NATIVE=1
   utils       a traced, timed 512² solve (slice_mg's options) whose
               trace file names K1's and K2's launches; the checkpoint
               saved and loaded into a fresh solver: 0 K1 launches, u
               bitwise equal; a 256² solver refuses it; plot_solution
               PNGs of the 512² u and of the warped 20x6x6 beam (K3)

17. K1's large instance (n above the small one's reach, up to 4096):
   k1_large    (a) K1 against its plain version at the kernel's block size
               on an auto-sized chunk of the 33², 48², 64², 10³, 12³ and
               16³ micro meshes, a ragged and a mixed-stop chunk of 64²
               (alternate blocks of contrast-100 cells), two identical 64²
               launches bitwise equal, 33², 64² and 16³ timed; (b)
               PoissonHMM, 128² macro, 64² micro, float32,
               dedup off: large launches = chunks, A* of 256 cells against
               a float64 engine, u against the float64 solve of its own
               system, the micro stage beside cell_prec='mg' on the same
               cells; (c) the same on the 6³ cube with a 16³ micro cube

18. K3's large instance (n above 288) on the main path:
   k3_large    (a) the rotated-fibre beam at 20x6x6 with 6³ micro cubes (n
               = 648, 4320 cells) and (b) LinearElasticityHMM on a 32²
               macro with 16² micro squares (n = 512, s = 3), float32,
               dedup off: large launches = chunks, no small one, A* of 256
               cells against a float64 engine (and the plain float32
               route's distance beside it), u against the float64 solve of
               its own system; (c) MicroEngine with default arguments on
               the 5³, 6³, 8³ cubes and 13², 16² squares, 8 cells each;
               (d) build_pipeline's dJ/dθ on the 10x3x3 beam with 6³ cells
               against the CPU's float64 gradient

19. the example scripts (``hommx_tpu_torch/examples/``, the counterparts of
   ``examples/``), each through its ``run`` at its default size, float32
   but for the three float64 solves named below:
   examples    hmm (15² macro and micro, K1; the 128² FEM, K2), laminate
               and inclusion (30² × 30², K1 at n = 900; the 256² and 512²
               FEMs, K2; laminate's 512² one in float64, K2 f64), hmm_3d (6³ × 6³, K1 at n = 216, s = 3; the 64³
               FEM, 274,625 dofs, K2), periodic_cell_load (float64 per-cell
               solves on 8²–64², no kernel), rotated_fibers (20x6x6, K3),
               high_res_micro (4³ K3, 8³ K3 large, 16³ float64 MG),
               unstructured (the jittered n = 72 mesh, AMG-CG, K1, K2),
               inverse_design (damped Newton, second derivatives through
               K1): the printed numbers against the JAX examples' float64
               values, each PNG, each run's launches

Phases 1-9 pass ``dedup_cells=False`` and so solve every cell, as before
the models' default became dedup.  ``--only fem_flagship,kc_gather`` runs
the named phases of parts 11 to 19 alone (after the build) and prints no
result line.  The line before the last is the kernels' JSON record, the last line
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
K2_F64_RTOL = 1e-12  # the float64 instance: fma against the plain mul + add
SLICE_MG_RTOL = 1e-4  # float32 MG solve of the slice vs the float64 solve of its system
BEAM_CG_RTOL = 1e-6  # float64 MG-CG of the beam vs the float64 LU solve of its system
K3_RTOL = 5e-5  # residual, A*, X where well-conditioned, X vs the refinement model
K3_PLAIN_FACTOR = 2.0  # kernel residual and float64 distance, at most this times plain's
SLICE_ASTAR_RTOL = 1e-4  # float32 slice vs plain float64 port
DEDUP_RTOL = 1e-4  # the answer with dedup vs without, max norm, relative
GOLDEN_POISSON_STRATIFIED = (0.03822425690690816, 0.06951174381273492)
# frozen float64 goldens of tests/test_golden.py: periodic_tensor (A_hom[0, 0],
# A_hom[1, 1]) and fem (L2 norm, max|u|)
GOLDEN_PERIODIC_TENSOR = (1.7357329281298157, 1.9999999999999982)
GOLDEN_FEM = (0.04186291691698005, 0.07429713437642609)
FEM_FLAGSHIP_RTOL = 5e-4  # float32 MG-CG FEM vs the float64 solve of its system
IDENTITY_U_RTOL = 1e-4  # PoissonPeriodicHMM vs PoissonHMM for A = A(y), u
IDENTITY_ELL_RTOL = 1e-5  # the same, assembled macro ELL values
PERIODIC_ASTAR_RTOL = 1e-4  # float32 A_hom vs the float64 plain route
FEM_HMM_RTOL = 1e-5  # LinearElasticityFEM vs LinearElasticityHMM, constant tensor
GATHER_RTOL = 1e-6  # beam A*, gather assembly vs scatter
# differentiation (the bars that PERF.md states with its prediction, before the run)
PIPELINE_U_RTOL = 1e-6  # step(centers) vs solve(dedup_cells=False), max norm
GRAD_FD_H = 0.05  # central-difference step in θ of the float32 checks
GRAD_FD_RTOL = 2e-2  # float32 dJ/dθ vs the central difference of the float32 forward
GRAD_F64_RTOL = 1e-3  # float32 dJ/dθ on the card vs the CPU's float64 gradient
GRAD2_F64_RTOL = 1e-3  # float32 d²J/dθ² on the card (8²) vs the CPU's float64
BEAM_GRAD_RTOL = 1e-3  # the beam's float32 dJ/dθ vs the CPU's float64 (10x its measured error)
# the FFT cell preconditioner and P2 elements
FFT_ASTAR_RTOL = 1e-4  # float32 A* of the FFT route vs the float64 Cholesky route
FFT_U_RTOL = 1e-4  # float32 u vs the float64 solve of its system
FFT_STRATEGY_RTOL = 1e-5  # block FFT: dense-K vs block-stencil matvec, float32
FFT_STIFF_RTOL = 1e-6  # contrast-1e5 cells, float64: A* of the converged cells vs Cholesky
P2_FEM_RATE = 2.8  # least L2 convergence rate of PoissonFEM(degree=2)
P2_FEM_CG_RTOL = 1e-3  # float32 Jacobi CG of the 513² P2 system vs its float64 solve
# the unstructured macro path (aggregation AMG); the bars that PERF.md states
# with its prediction, before the run
AMG_U_RTOL = 1e-4  # float32 AMG-CG u vs the float64 solve of its own system
AMG_STRUCTURED_RTOL = 5e-2  # unstructured u vs the structured u at its nodes (the example's bar)
AMG_JACOBI_FACTOR = 3  # Jacobi CG takes at least this many times AMG-CG's iterations
AMG_FEM_RTOL = 1e-3  # float32 AMG-CG FEM u vs the float64 solve of its system
AMG_OPTIONS = {"rtol": 1e-5, "maxiter": 20000}  # the float32 CG runs (as slice_default)
SHARD_GRAD_RTOL = 1e-3  # float32 dJ/dθ, sharded pipeline vs unsharded
# K1's large instance (n above the small instance's reach, up to 4096)
K1_LARGE_ASTAR_RTOL = 1e-4  # float32 A* of sampled cells vs the float64 engine
K1_LARGE_U_RTOL = 1e-4  # float32 u vs the float64 solve of its own system
K3_LARGE_ASTAR_RTOL = 1e-4  # float32 A* of sampled cells vs the float64 engine
K3_LARGE_ASTAR_SLACK = 1e-6  # ... and at most 2x the plain float32 route's distance + this
K3_LARGE_U_RTOL = 1e-6  # float32 u vs the float64 solve of its own (direct) system
SHARD_MODES_RTOL = 1e-6  # float32 u, the 'shard_map' forward vs the 'auto' one

# NVIDIA H100 SXM peaks (data sheet, dense): float32 outside the tensor
# cores and device memory bandwidth, for each kernel's least time
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# float64 outside the tensor cores (the same data sheet)
PEAK_F64_FLOPS = 34e12

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


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_F32_FLOPS) -> tuple:
    """(bound_ms, bound_by): the larger of the operation time at the
    float32 (or the given) peak and the byte time at the memory peak."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")


def inclusion_mu(x, y):
    """Shear modulus of the 2D inclusion cell (tests/test_chol_kernel.py's):
    50(1 + 0.2x₀) inside a disc of radius 0.3, 0.5 + 0.3 sin 2πy₁ outside."""
    import torch

    one = torch.ones((), dtype=y.dtype, device=y.device)
    inc = (y[0] - 0.5) ** 2 + (y[1] - 0.5) ** 2 < 0.09
    return torch.where(inc, 50.0 * (1.0 + 0.2 * x[0]) * one,
                       0.5 + 0.3 * torch.sin(2 * torch.pi * y[1]))


def beam_coeff(x_dependent: bool):
    """Hooke tensor of the beam: μ = 100 in the fibre (times 1 + 0.001·x₀
    for the bench row's x-dependent cell), 0.001 outside, λ = 1."""
    import torch

    from hommx_tpu_torch.examples._common import circle_indicator
    from hommx_tpu_torch.utils.validation import hooke_tensor

    def mu(x, y):
        one = torch.ones((), dtype=y.dtype, device=y.device)
        stiff = 100.0 * (1.0 + 0.001 * x[0]) * one if x_dependent else 100.0 * one
        return torch.where(circle_indicator(y[1], y[2]), stiff, 0.001 * one)

    return hooke_tensor(3, mu, lambda x, y: 1.0)


def beam_rotation(x):
    """Dθᵀ(x): rotation by γ = π/2 · x₁/W in the (0, 2) plane, transposed."""
    import torch

    g = 0.5 * torch.pi * x[1] / BEAM_W
    c, s = torch.cos(g), torch.sin(g)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, z, s]), torch.stack([z, o, z]),
                        torch.stack([-s, z, c])]).T


def golden_stratified_coeff(x, y):
    """The golden poisson_stratified wavy laminate: 2 or 0.5 in y₁."""
    import torch

    one = torch.ones((), dtype=y.dtype, device=y.device)
    return torch.where(torch.sin(2 * torch.pi * y[1]) > 0.0, 2.0 * one, 0.5 * one)


def golden_stratified_dtheta(x):
    """Dθᵀ for θ(x) = (x₀, x₁ − sin 2πx₀)."""
    import torch

    z, o = torch.zeros_like(x[0]), torch.ones_like(x[0])
    return torch.stack([torch.stack([o, -2.0 * torch.pi * torch.cos(2.0 * torch.pi * x[0])]),
                        torch.stack([z, o])])


def darcy(hmm):
    """examples/diffusion/laminate.py's boundary conditions on ``hmm``: u = 1
    on the left edge, 0 on the right, natural elsewhere."""
    from hommx_tpu_torch.examples._common import darcy_bcs

    hmm.set_boundary_conditions(darcy_bcs(hmm.function_space))


def rel_diff(u, v) -> float:
    """max |u − v| / max |v| in float64."""
    return float((u.double() - v.double()).abs().max() / v.double().abs().max())


def clamp_x0(hmm):
    """Clamp every dof on the x₀ = 0 face."""
    import numpy as np

    from hommx_tpu_torch import dirichletbc
    from hommx_tpu_torch.ops.function_space import boundary_dofs

    V = hmm.function_space
    hmm.set_boundary_conditions(
        dirichletbc(np.zeros(V.bs), boundary_dofs(V, lambda x: np.isclose(x[0], 0)), V)
    )


def make_beam(device, macro_n=(20, 6, 6), micro_n: int = 4, **kw):
    """The rotated-fiber beam of examples/linear_elasticity/rotated_fibers.py
    in float32: LinearElasticityStratifiedHMM on a macro box of
    ``macro_n`` cells per axis with a ``micro_n``³ micro cube (4³ unless
    given), f = (0, 0, −0.05·W²), clamped at x₀ = 0; no cell dedup unless
    ``kw`` asks for it."""
    import torch

    from hommx_tpu_torch import LinearElasticityStratifiedHMM, create_box, create_unit_cube

    macro = create_box([[0, 0, 0], [BEAM_L, BEAM_W, BEAM_H]], list(macro_n))
    f = torch.tensor([0.0, 0.0, -0.05 * (BEAM_W / BEAM_L) ** 2], dtype=torch.float64)
    hmm = LinearElasticityStratifiedHMM(macro, beam_coeff(False), lambda x: f,
                                        create_unit_cube(micro_n), 2**-5, beam_rotation,
                                        dtype=torch.float32, device=device,
                                        **{"dedup_cells": False, **kw})
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


def _k2_case(name, mesh, device, seed, dtype=None, bs=1, shard=None):
    """K2 on the macro DIA pattern of ``mesh`` (block size ``bs``) with
    seeded random values in ``dtype`` (float32 by default): against its
    plain version and against a cuSPARSE CSR product of the same matrix,
    with its single-call, back-to-back, graph and cold-L2 times.  With
    ``shard = (i, n)`` the operator is shard i of n of the sharded macro
    CG (parallel/macro.py): the shard's rows of the values zero-extended by
    the halo on each side, applied to the extended vector; its middle rows
    are also held against the plain product of the whole system."""
    import torch
    import torch.nn.functional as F

    from hommx_tpu_torch import FunctionSpace
    from hommx_tpu_torch.ops.dia import DIAOperator, build_dia_from_ell, dia_spmv, dia_spmv_cuda
    from hommx_tpu_torch.ops.sparse import build_ell_pattern

    dtype = dtype or torch.float32
    V = FunctionSpace(mesh, bs)
    dia = build_dia_from_ell(build_ell_pattern(V.cell_dofs_unrolled(), V.num_dofs))
    N, nd = dia.num_dofs, dia.num_diagonals
    g = torch.Generator(device=device).manual_seed(seed)
    vals = torch.randn((nd, N), generator=g, device=device, dtype=dtype)
    x = torch.randn((N,), generator=g, device=device, dtype=dtype)
    if shard is not None:
        i, n_sh = shard
        halo = max(abs(o) for o in dia.offsets)
        block = -(-N // n_sh)
        y_rows = dia_spmv(vals, dia.offsets, x)[i * block:(i + 1) * block]
        vals = F.pad(F.pad(vals, (0, block * n_sh - N))[:, i * block:(i + 1) * block],
                     (halo, halo)).contiguous()
        x = F.pad(x, (halo, block * n_sh - N + halo))[i * block:(i + 1) * block + 2 * halo]
        x = x.contiguous()
        N = block + 2 * halo
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
    f64 = dtype == torch.float64
    item = 8 if f64 else 4
    bound_ms, bound_by = bound(2.0 * nd * N, item * (nd * N + 2 * N),
                               PEAK_F64_FLOPS if f64 else PEAK_F32_FLOPS)
    rec = {"phase": "dia_spmv", "case": name, "dtype": str(dtype).split(".")[-1], "bs": bs,
           "N": N, "diagonals": nd, "offsets": list(dia.offsets),
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
    tol = K2_F64_RTOL if f64 else K2_RTOL
    shard_ok = True
    if shard is not None:
        rows = y_k[halo:halo + y_rows.shape[0]]
        rec.update({"shard": list(shard), "halo": halo, "block": block,
                    "shard_rel_err": float((rows - y_rows).abs().max()) / float(y_rows.abs().max())})
        shard_ok = rec["shard_rel_err"] < tol
    emit(rec)
    ok = (rec["rel_err"] < tol and rec["wrapper_rel_err"] < tol
          and rec["library_rel_err"] < tol and rec["graph_equal"] and shard_ok)
    return rec, ok


def phase_dia(device):
    """K2 on the 512x512 macro pattern (7 diagonals, the slice's), on a
    62³ box (250,047 dofs, 15 diagonals, 3D P1) and on the jittered 512²
    Delaunay mesh of phase amg (263,169 dofs, its irregular offsets: the
    AMG-CG's outer product, through the kernel's run-time diagonal count);
    its float64 instance on the 512x512 pattern and on the elasticity
    pattern of the 40x12x12 beam (20,787 dofs, bs = 3, the float64 CG's);
    ``shard512``: shard 1 of the 4-shard CG on the 512x512 pattern (65,793
    rows, halo 514: the operator over 66,821 rows), and
    ``beam40x12x12_f64_shard``, shard 1 of the beam's 4-shard float64 CG,
    each against its plain version and the plain product of the whole
    system.  Returns the float32 2d512 record and the
    float64 beam record."""
    import torch

    from hommx_tpu_torch import create_box, create_unit_cube, create_unit_square

    beam = create_box([[0, 0, 0], [BEAM_L, BEAM_W, BEAM_H]], [40, 12, 12])
    cases = [("2d512", create_unit_square(512, 512), 2, torch.float32, 1, None),
             ("3d62", create_unit_cube(62), 3, torch.float32, 1, None),
             ("jittered512", jittered_delaunay(512)[0], 6, torch.float32, 1, None),
             ("2d512_f64", create_unit_square(512, 512), 4, torch.float64, 1, None),
             ("beam40x12x12_f64", beam, 5, torch.float64, 3, None),
             ("shard512", create_unit_square(512, 512), 7, torch.float32, 1, (1, 4)),
             ("beam40x12x12_f64_shard", beam, 8, torch.float64, 3, (1, 4))]
    recs, failed = {}, []
    for name, mesh, seed, dtype, bs, shard in cases:
        recs[name], ok = _k2_case(name, mesh, device, seed, dtype, bs, shard)
        if not ok:
            failed.append(name)
    if failed:
        raise AssertionError(f"DIA kernel, its graph replay or the CSR yardstick disagrees "
                             f"with the plain version: {failed}")
    return recs["2d512"], recs["beam40x12x12_f64"]


def _k1_case(eng, centers, timed, coeff=None, repeat=False, iter_slack=K1_ITER_SLACK):
    """K1 vs its plain version at the kernel's own block size on one chunk
    of the main path's scaled system (the flagship coefficient unless
    ``coeff``), both taken through the chunk's own clamp and A*
    contraction, with the iteration counts of each block side by side.
    Timed: the kernel, the unblocked plain loop, the bound and
    ``prec_library_us``, one float32 ``torch.matmul`` of Minv by the chunk's
    (n, s·C) right-hand sides (TF32 off): a yardstick for one
    preconditioner apply of the chunk, not for the whole PCG.  ``repeat``:
    a second identical launch must give bitwise the same X and counts.
    ``iter_slack``: the bar on each block's count against the plain
    version's; None records the counts beside the plain float64 version's
    (stop tolerance 1e-5) instead, for chunks whose float32 loop is itself
    several iterations from float64 (PERF.md, PR 20)."""
    import torch

    from hommx_tpu_torch.micro.chunk import chunk_system
    from hommx_tpu_torch.micro.stencil_pcg import (large_grid_on_card, launch_config,
                                                   stencil_pcg_cuda, stencil_pcg_plain)

    cs = chunk_system(eng, coeff or flagship, centers)
    ws_s, Fs = cs.scaled()
    args = (ws_s, Fs, cs.Minv, cs.st.shape, cs.st.offsets, eng.pcg_tol, eng.pcg_maxiter)
    n, s, C, K = eng.n_reduced, eng.s, centers.shape[0], len(cs.st.offsets)
    cfg = launch_config(n, s, C)
    Yk, itk = stencil_pcg_cuda(*args, per_block=True)
    repeat_equal = None
    if repeat:
        Y2, it2 = stencil_pcg_cuda(*args, per_block=True)
        repeat_equal = bool(torch.equal(Yk, Y2) and torch.equal(itk, it2))
    Yp, itp = stencil_pcg_plain(*args, block=cfg.cells_per_block, per_block=True)
    itk = [int(k) for k in itk.cpu()]
    Ak, Ap = cs.astar(eng, Yk, max(itk)), cs.astar(eng, Yp, max(itp))
    torch.cuda.synchronize()
    abs_err = float((Ak - Ap).abs().max())
    slack = max(abs(a - b) for a, b in zip(itk, itp))
    per_block = [list(v) for v in zip(itk, itp)]
    if iter_slack is None:  # beside the plain float64 version's counts
        args64 = ([w.double() for w in ws_s], Fs.double(), cs.Minv.double(), *args[3:5], 1e-5,
                  eng.pcg_maxiter)
        _, it64 = stencil_pcg_plain(*args64, block=cfg.cells_per_block, per_block=True)
        per_block = [v + [k64] for v, k64 in zip(per_block, it64)]
    rec = {"cells": C, "dim": eng.d, "n": n, "K": K, "s": s,
           "cells_per_block": cfg.cells_per_block, "threads": cfg.threads,
           "rows_per_thread": cfg.rows_per_thread, "smem_bytes": cfg.smem_bytes,
           "large": cfg.large, "stages": cfg.stages, "tile_cols": cfg.tile_cols,
           "grid": cfg.grid,
           "grid_on_card": large_grid_on_card(cfg) if cfg.large else None,
           "state_bytes": cfg.state_bytes, "bitwise_repeat": repeat_equal,
           "iters_kernel": max(itk), "iters_plain": max(itp), "iters_per_block": per_block,
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
    ok = (math.isfinite(rec["rel_err"]) and rec["rel_err"] < K1_RTOL
          and (iter_slack is None or slack <= iter_slack) and repeat_equal is not False)
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
    ks, Fs, _ = cs.scaled(eng)
    return cs.dense(ks), Fs, lambda Xs: cs.astar(eng, Xs, ks, Fs)


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
    float64 model of its refinement sweep, at the small instance's largest
    n, and the large instance's cases (:func:`_k3_large_cases`)."""
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
    Ks2, Fs2, astar2 = _cell_systems(engine(create_unit_square(4)),
                                     hooke_tensor(2, inclusion_mu, lambda x, y: 1.0),
                                     centers_of(200, 2, 6))
    cases.append(("c_square4_C200", Ks2, Fs2, None, astar2, False))
    # (d) case (b) with the last pivot of cell 3 made negative
    Kd = Ks.clone()
    Kd[3, -1, -1] = -Kd[3, -1, -1]
    cases.append(("d_indefinite_cell3", Kd, Fs, [c for c in range(Ks.shape[0]) if c != 3],
                  None, False))
    # (e) well-conditioned SPD batch at the beam's n and s: X itself agrees
    Ke, Fe = _spd_batch(device, 256, n, s, 7)
    cases.append((f"e_spd_C256_n{n}", Ke, Fe, None, None, True))
    # (g) the same at the small instance's largest n
    n_max = chol_kernel.max_small_n(s)
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
    # (h) the large instance
    failed += _k3_large_cases(device)
    if failed:
        raise AssertionError(f"Cholesky kernel disagrees with its plain version: {failed}")
    return main


#: the record of K3's large instance at the 6³ beam chunk (phase 5 (h)), for
#: the kernels line
K3_LARGE = {}


def _k3_large_cases(device, sizes=((5, 720), (6, 309), (8, 76)), square=(16, 683),
                    spd=((289, 6, 64), (512, 3, 128), (648, 6, 64), (1536, 6, 16),
                         (3000, 6, 4)), checked: int = 32) -> list:
    """K3's large instance against its plain version at the K3 bar (the
    residual, A*, the float64 distance; X too on the well-conditioned
    batches): (h1) well-conditioned SPD batches at n = 289 (ragged), 512 (s
    = 3), 648, 1536 and 3000; (h2) the beam's equilibrated cell systems on
    the 5³, 6³ and 8³ cubes (n = 375, 648, 1536) at the chunks a 4320-cell
    beam gives them, and the 2D inclusion's on the 16² square (n = 512, s =
    3) at the 2048-cell run's chunk, timed (the kernel, its plain version,
    torch.linalg.solve, the bound, the workspace's traffic by
    ``chol_kernel.workspace_traffic_bytes``), the float64 checks on
    ``checked`` of their cells, and at the 6³ cube two identical launches
    bitwise equal; (h3) a ragged 37 cells of the 5³ cube (four CTAs a
    cell); (h4) 16 cells of the 6³ cube with cell 3's last pivot made
    negative.  Returns the failed cases."""
    import numpy as np
    import torch

    from hommx_tpu_torch import MicroEngine, create_box, create_unit_cube, create_unit_square
    from hommx_tpu_torch.ops import chol_kernel
    from hommx_tpu_torch.ops.chol_kernel import fused_chol_solve_cuda, fused_chol_solve_plain
    from hommx_tpu_torch.utils.validation import hooke_tensor

    failed = []
    macro = create_box([[0, 0, 0], [BEAM_L, BEAM_W, BEAM_H]], [20, 6, 6])
    beam_centers = torch.as_tensor(macro.vertices[macro.cells].mean(axis=1), dtype=torch.float32,
                                   device=device)

    def engine(mesh):
        return MicroEngine(mesh, bs=mesh.dim, coeff_kind="tensor4", dtype=torch.float32,
                           device=device)

    def check(name, K, F, ok_cells=None, astar=None, strict=False, timed=False):
        C, n, s = K.shape[0], K.shape[1], F.shape[1]
        cfg = chol_kernel.chol_launch_config(n, s, C)
        if ok_cells is None and C > checked:
            ok_cells = np.linspace(0, C - 1, checked).round().astype(int).tolist()
        rec, ok = _k3_compare(K, F, ok_cells, astar, strict)
        rec = {"phase": "chol_solve", "case": name, "cells": C, "n": n, "s": s,
               "large": cfg.large, "panels": cfg.panels, "cluster": cfg.cluster,
               "apart": cfg.apart,
               "workspace_bytes": cfg.workspace_bytes,
               "checked_cells": C if ok_cells is None else len(ok_cells), **rec}
        if timed:
            Fb = F.permute(2, 0, 1).contiguous()
            flops = C * (n**3 / 3 + 4.0 * n * n * s + 2.0 * n * n * s)
            bound_ms, bound_by = bound(flops, 4.0 * C * (n * n + 2 * n * s))
            rmw = chol_kernel.workspace_traffic_bytes(n, C)
            rec.update({"card": _card_line(), "smem_bytes": cfg.smem_bytes,
                        "occupancy": list(chol_kernel.large_occupancy(cfg)),
                        "ms": time_ms(lambda: fused_chol_solve_cuda(K, F), reps=10),
                        "plain_ms": time_ms(lambda: fused_chol_solve_plain(K, F), reps=3,
                                            warmup=1),
                        "library_ms": time_ms(lambda: torch.linalg.solve(K, Fb), reps=5),
                        "bound_ms": bound_ms, "bound_by": bound_by, "gflop": flops / 1e9,
                        "workspace_rmw_gb": rmw / 1e9,
                        "workspace_rmw_hbm_ms": rmw / PEAK_BYTES_PER_S * 1e3})
            rec["share_of_bound"] = bound_ms / rec["ms"]
        emit(rec)
        if not (ok and cfg.large):
            failed.append(name)
        return rec

    for n, s, C in spd:  # (h1)
        K, F = _spd_batch(device, C, n, s, 20 + n)
        check(f"h1_spd_C{C}_n{n}_s{s}", K, F, strict=True)
        del K, F
    for m, C in sizes:  # (h2) the beam's cells on the m³ cube
        eng = engine(create_unit_cube(m))
        K, F, astar = _cell_systems(eng, beam_coeff(False), beam_centers[:C], beam_rotation)
        rec = check(f"h2_beam_cube{m}_C{C}", K, F, astar=astar, timed=True)
        if m == 6:
            K3_LARGE.update(rec)
            # no sum runs in atomic order: two identical launches agree bitwise
            same = bool(torch.equal(fused_chol_solve_cuda(K, F), fused_chol_solve_cuda(K, F)))
            emit({"phase": "chol_solve", "case": f"h5_bitwise_cube6_C{C}", "bitwise_equal": same})
            if not same:
                failed.append(f"h5_bitwise_cube6_C{C}")
        if m == 5:  # (h3) a ragged cell count
            K37, F37, astar37 = _cell_systems(eng, beam_coeff(False), beam_centers[:37],
                                              beam_rotation)
            check("h3_beam_cube5_C37", K37, F37, astar=astar37)
        if m == 6:  # (h4) an indefinite cell
            Kd, Fd = K[:16].clone(), F[:, :, :16].contiguous()
            Kd[3, -1, -1] = -Kd[3, -1, -1]
            check("h4_indefinite_cube6_cell3", Kd, Fd, ok_cells=[c for c in range(16) if c != 3])
        del eng, K, F, astar
        torch.cuda.empty_cache()
    m, C = square  # (h2) the 2D inclusion on the 16² square
    rng = np.random.default_rng(21)
    c2 = torch.as_tensor(rng.uniform(0, 1, (C, 2)), dtype=torch.float32, device=device)
    K, F, astar = _cell_systems(engine(create_unit_square(m)),
                                hooke_tensor(2, inclusion_mu, lambda x, y: 1.0), c2)
    check(f"h2_square{m}_C{C}", K, F, astar=astar, timed=True)
    return failed


def phase_golden(device):
    import torch

    from hommx_tpu_torch import PoissonHMM, create_unit_square
    from hommx_tpu_torch.ops.assembly import l2_norm_fn

    macro, micro = create_unit_square(8, 8), create_unit_square(8, 8)
    hmm = PoissonHMM(macro, golden_coeff, lambda x: 1.0, micro, 0.1 / 8,
                     dtype=torch.float32, device=device, dedup_cells=False)
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
                                        dtype=torch.float32, device=device, dedup_cells=False)
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
    stencil_pcg.KERNEL.reset_counts()
    dia.KERNEL.reset_counts()
    runs = []
    hmm = None
    for label in ("cold", "warm"):
        t0 = time.perf_counter()
        hmm = PoissonHMM(macro, flagship, 1.0, micro, 2**-5, opts,
                         dtype=torch.float32, device=device, chunk=2048, dedup_cells=False)
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
               "macro_iterations": dg["macro_iterations"], "macro_steps": dg["macro_steps"],
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
        if not (finite and dg["macro_iterations"] < opts.maxiter and _cg_counts_ok(rec)
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
    return launches, u, runs[-1]


def _cg_counts_ok(rec, key="dia_spmv_launches") -> bool:
    """The CG's initial residual and one product per loop step; the steps
    past the last iteration are the frozen ones before the host's next
    check of the stop flag."""
    from hommx_tpu_torch.ops.solvers import _CHECK_EVERY

    steps, iters = rec["macro_steps"], rec["macro_iterations"]
    return rec[key] == steps + 1 and iters <= steps < iters + _CHECK_EVERY


def _grids(struct):
    return [list(lev.grid) for lev in struct.levels]


def _rebuild_system(hmm, macro_f64: bool):
    """The BC-applied macro ELL system that ``hmm.solve()`` solved, from its
    cached A* and load vector."""
    import torch

    from hommx_tpu_torch.models.common import assemble_macro_system, merge_bcs

    sys = hmm._sys
    mask, bvals = merge_bcs(hmm._bcs, hmm.function_space.num_dofs, torch.float64, hmm._device)
    return assemble_macro_system(sys, hmm.homogenized_tensors(), hmm._b_load, mask, bvals,
                                 macro_f64=macro_f64)


def phase_slice_mg(device, u_jacobi, jacobi):
    """The 512²/16² slice with the default solver options: multigrid CG
    (pc 'auto') to rtol 1e-5, cold then warm; then, on the warm run's
    system, mg_setup's time, the multigrid and Jacobi CG loops at host
    check intervals of 16, 4 and 1, a float64 multigrid CG solve of the
    same system, and u's float64 true residual (beside the float32 floor)
    and distance to the float64 solution and to the Jacobi run's u."""
    import torch

    from hommx_tpu_torch import PoissonHMM, SolverOptions, create_unit_square
    from hommx_tpu_torch.micro import stencil_pcg
    from hommx_tpu_torch.ops import dia, multigrid, solvers
    from hommx_tpu_torch.ops.sparse import spmv

    macro, micro = create_unit_square(512, 512), create_unit_square(16, 16)
    opts = SolverOptions(rtol=1e-5, maxiter=20000)
    stencil_pcg.KERNEL.reset_counts()
    dia.KERNEL.reset_counts()
    hmm, u = None, None
    for label in ("cold", "warm"):
        t0 = time.perf_counter()
        hmm = PoissonHMM(macro, flagship, 1.0, micro, 2**-5, opts,
                         dtype=torch.float32, device=device, chunk=2048, dedup_cells=False)
        t_setup = time.perf_counter() - t0
        k2_before = dia.KERNEL.launches
        solvers.STOP_TEST.readbacks = 0
        u = hmm.solve().array
        torch.cuda.synchronize()
        t_total = time.perf_counter() - t0
        dg = hmm.diagnostics
        rec = {"phase": f"slice_mg_{label}", "pc": opts.pc, "macro_method": hmm._macro_method,
               "setup_seconds": t_setup, "total_seconds": t_total,
               "micro_seconds": dg["micro_seconds"], "macro_seconds": dg["macro_seconds"],
               "macro_iterations": dg["macro_iterations"], "macro_steps": dg["macro_steps"],
               "jacobi_iterations": jacobi["macro_iterations"],
               "jacobi_macro_seconds": jacobi["macro_seconds"],
               "host_readbacks": solvers.STOP_TEST.readbacks,
               "check_every": solvers._CHECK_EVERY,
               "dia_spmv_launches": dia.KERNEL.launches - k2_before,
               "levels": _grids(hmm._sys.mg), "macro_residual": dg["macro_residual"],
               "diverged_cells": int(dg["diverged_cells"].size),
               "nan_cells": int(dg["nan_cells"].size),
               "finite": bool(torch.isfinite(u).all())}
        emit(rec)
        it = rec["macro_iterations"]
        if not (rec["finite"] and rec["macro_method"] == "cg" and _cg_counts_ok(rec)
                and 3 * it <= jacobi["macro_iterations"]
                and rec["host_readbacks"] <= math.ceil(it / solvers._CHECK_EVERY) + 2
                and rec["diverged_cells"] == 0 and rec["nan_cells"] == 0):
            raise AssertionError(f"multigrid slice run failed its checks: {rec}")
    launches = {"stencil_pcg": stencil_pcg.KERNEL.launches, "dia_spmv": dia.KERNEL.launches}
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the multigrid path was never launched: {launches}")

    sys = hmm._sys
    vals_bc, b_bc = _rebuild_system(hmm, macro_f64=False)
    t0 = time.perf_counter()
    struct = multigrid.build_mg_structure(macro.structure, 1, sys.dia)
    t_build = time.perf_counter() - t0
    dvals = dia.ell_vals_to_dia(sys.dia, vals_bc)
    setup_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = multigrid.mg_setup(sys.mg, dvals)
        torch.cuda.synchronize()
        setup_s.append(time.perf_counter() - t0)
    r = torch.randn(b_bc.shape, generator=torch.Generator(device=device).manual_seed(9),
                    device=device)
    vcycle_ms = time_ms(lambda: multigrid.mg_vcycle(sys.mg, state, r), reps=10)
    # the CG loop alone on this system (operator and hierarchy prepared),
    # multigrid and Jacobi, at three host check intervals, in turns
    op = dia.DIAOperator(dvals, sys.dia.offsets)
    matvec = lambda v: op(v, out=op.out)  # noqa: E731
    diag = solvers._ell_diag(vals_bc, sys.cols)
    stop = dict(atol=opts.atol, rtol=opts.rtol, maxiter=opts.maxiter)
    loops = {
        "mg": lambda: solvers.pcg_prec(
            matvec, lambda v: multigrid.mg_vcycle(sys.mg, state, v), b_bc, **stop),
        "jacobi": lambda: solvers.cg_matfree(matvec, diag, b_bc, **stop),
    }
    cg = {}
    saved = solvers._CHECK_EVERY
    try:
        for every in (16, 4, 1, 1, 4, 16):
            solvers._CHECK_EVERY = every
            for pc, loop in loops.items():
                steps0, reads0 = solvers.STOP_TEST.steps, solvers.STOP_TEST.readbacks
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, k, res = loop()
                float(res)
                cg.setdefault(f"{pc}_every_{every}", []).append(
                    {"seconds": time.perf_counter() - t0, "iterations": k,
                     "steps": solvers.STOP_TEST.steps - steps0,
                     "readbacks": solvers.STOP_TEST.readbacks - reads0})
    finally:
        solvers._CHECK_EVERY = saved
    A64, b64 = vals_bc.double(), b_bc.double()
    # the same system solved in float64 (float64 multigrid CG through K2's
    # float64 instance on this pattern) to near float64 accuracy
    x64, k64, _ = solvers.solve_ell(A64, sys.cols, b64,
                                    SolverOptions(rtol=1e-12, atol=0.0, maxiter=20000),
                                    dia=sys.dia, mg=sys.mg)

    def true_residual(v):
        return float(torch.linalg.vector_norm(b64 - spmv(A64, sys.cols, v.double()))
                     / torch.linalg.vector_norm(b64))

    scale = float(x64.abs().max())
    du = float((u.double() - u_jacobi.double()).abs().max())
    rec = {"phase": "slice_mg_check", "build_mg_structure_seconds": t_build,
           "mg_setup_seconds": setup_s, "vcycle_ms": vcycle_ms,
           "levels": _grids(struct), "structure_equal": _grids(struct) == _grids(sys.mg),
           "cg_loop": cg, "true_rel_residual_f64": true_residual(u),
           "jacobi_true_rel_residual_f64": true_residual(u_jacobi),
           # the float64 solution rounded to float32: the least true
           # residual a float32 u can have on this system
           "float32_floor_rel_residual": true_residual(x64.float()),
           "f64_iterations": k64, "f64_true_rel_residual": true_residual(x64),
           "max_rel_diff_to_f64": float((u.double() - x64).abs().max()) / scale,
           "jacobi_max_rel_diff_to_f64": float((u_jacobi.double() - x64).abs().max()) / scale,
           "max_abs_diff_to_jacobi": du,
           "max_rel_diff_to_jacobi": du / float(u_jacobi.double().abs().max())}
    emit(rec)
    if not (rec["max_rel_diff_to_f64"] <= SLICE_MG_RTOL and rec["structure_equal"]
            and rec["f64_true_rel_residual"] <= 1e-10
            and all(c["iterations"] == cg[f"{pc}_every_1"][0]["iterations"]
                    for pc in loops for key, runs in cg.items() if key.startswith(pc)
                    for c in runs)):
        raise AssertionError(f"multigrid slice check failed: {rec}")
    return launches, hmm


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
    chol_kernel.KERNEL.reset_counts()
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
    chol_kernel.KERNEL.reset_counts()
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
    return {"chol_solve": launches}, hmm


def phase_slice_elasticity_cg(device, macro_n=(40, 12, 12)):
    """The rotated-fibre beam on a 40x12x12 macro box with the default
    solver options: 20,787 dofs, above the direct threshold, so the macro
    solve is the float64 multigrid CG through K2's float64 instance; u
    against float64 dense solves of the same BC-applied system."""
    import torch

    from hommx_tpu_torch.ops import chol_kernel, dia, solvers
    from hommx_tpu_torch.ops.solvers import dense_solve_ell, solve_ell
    from hommx_tpu_torch.ops.sparse import ell_to_dense

    chol_kernel.KERNEL.reset_counts()
    dia.KERNEL.reset_counts()
    solvers.STOP_TEST.readbacks = 0
    t0 = time.perf_counter()
    hmm = make_beam(device, macro_n)
    t_setup = time.perf_counter() - t0
    u = hmm.solve().array
    torch.cuda.synchronize()
    t_total = time.perf_counter() - t0
    dg = hmm.diagnostics
    rec = {"phase": "slice_elasticity_cg", "macro_method": hmm._macro_method,
           "macro_f64": hmm._macro_f64, "setup_seconds": t_setup, "total_seconds": t_total,
           "micro_seconds": dg["micro_seconds"], "macro_seconds": dg["macro_seconds"],
           "macro_iterations": dg["macro_iterations"], "macro_steps": dg["macro_steps"],
           "host_readbacks": solvers.STOP_TEST.readbacks,
           "num_cells": dg["num_cells"], "dofs": hmm.function_space.num_dofs,
           "levels": _grids(hmm._sys.mg),
           "dia_spmv_f64_launches": dia.KERNEL.counts["hommx_dia_spmv_f64"],
           "dia_spmv_f32_launches": dia.KERNEL.counts["hommx_dia_spmv_f32"],
           "k3_launches": chol_kernel.KERNEL.launches,
           "diverged_cells": int(dg["diverged_cells"].size),
           "nan_cells": int(dg["nan_cells"].size), "finite": bool(torch.isfinite(u).all())}
    launches = {"dia_spmv_f64": rec["dia_spmv_f64_launches"], "chol_solve": rec["k3_launches"]}
    opts = hmm._options_global
    vals_bc, b_bc = _rebuild_system(hmm, macro_f64=True)
    # the main path's solve again, its float64 x kept
    x64, _, _ = solve_ell(vals_bc, hmm._sys.cols, b_bc, opts, dia=hmm._sys.dia, mg=hmm._sys.mg)
    torch.cuda.reset_peak_memory_stats(device)
    # float64 dense solves: LU of the very matrix the CG solved, and the
    # direct route's Cholesky of its symmetric part.  The float32 micro
    # stage leaves A* asymmetric by ~1e-7, so the two differ by ~κ·1e-7
    A = ell_to_dense(vals_bc, hmm._sys.cols)
    asym = float((A - A.T).abs().max() / A.abs().max())
    x_lu = torch.linalg.solve(A, b_bc)
    del A
    x_chol = dense_solve_ell(vals_bc, hmm._sys.cols, b_bc)
    scale = float(x_lu.abs().max())
    rec.update({"tol": max(opts.atol, opts.rtol * float(torch.linalg.vector_norm(b_bc))),
                "matrix_asymmetry": asym,
                "max_rel_diff_to_lu_f64": float((u.double() - x_lu).abs().max()) / scale,
                "solve_ell_f64_rel_diff_to_lu": float((x64 - x_lu).abs().max()) / scale,
                "solve_ell_f64_rel_diff_to_cholesky": float((x64 - x_chol).abs().max()) / scale,
                "dense_peak_gib": torch.cuda.max_memory_allocated(device) / 2**30})
    del x_lu, x_chol
    torch.cuda.empty_cache()
    emit(rec)
    if not (rec["finite"] and rec["macro_method"] == "cg"
            and rec["macro_iterations"] < opts.maxiter and dg["macro_residual"] <= rec["tol"]
            and _cg_counts_ok(rec, "dia_spmv_f64_launches") and rec["dia_spmv_f32_launches"] == 0
            and rec["k3_launches"] >= 1 and rec["max_rel_diff_to_lu_f64"] < BEAM_CG_RTOL
            and rec["solve_ell_f64_rel_diff_to_lu"] < BEAM_CG_RTOL
            and rec["diverged_cells"] == 0 and rec["nan_cells"] == 0):
        raise AssertionError(f"beam multigrid CG run failed its checks: {rec}")
    return launches, hmm


def _solve_record(phase, hmm, t_setup):
    """Time the dedup fingerprint (when dedup is on; ``solve()`` then finds
    it cached) and the solve; the record of the run and its u."""
    import torch

    from hommx_tpu_torch.ops import dia

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if hmm._dedup_cells:
        hmm._dedup_classes(hmm._sys.centers)
    torch.cuda.synchronize()
    t_fp = time.perf_counter() - t0
    k2_before = dia.KERNEL.launches
    t0 = time.perf_counter()
    u = hmm.solve().array
    torch.cuda.synchronize()
    dg = hmm.diagnostics
    rec = {"phase": phase, "dedup_cells": hmm._dedup_cells, "setup_seconds": t_setup,
           "fingerprint_seconds": t_fp, "solve_seconds": time.perf_counter() - t0,
           "micro_seconds": dg["micro_seconds"], "macro_seconds": dg["macro_seconds"],
           "macro_method": hmm._macro_method, "macro_iterations": dg["macro_iterations"],
           "macro_steps": dg["macro_steps"], "dia_spmv_launches": dia.KERNEL.launches - k2_before,
           "num_cells": dg["num_cells"], "unique_cells": dg["unique_cells"],
           "dofs": hmm.function_space.num_dofs,
           "diverged_cells": int(dg["diverged_cells"].size),
           "fallback_cells": int(dg["fallback_cells"].size),
           "nan_cells": int(dg["nan_cells"].size),
           "finite": bool(torch.isfinite(u).all()), "max_u": float(u.abs().max())}
    return rec, u


def _run_ok(rec) -> bool:
    """Finite u, no NaN or diverged cell, and a CG that stopped in time with
    one K2 launch per loop step."""
    cg_ok = rec["macro_method"] != "cg" or (rec["macro_iterations"] < 20000 and _cg_counts_ok(rec))
    return rec["finite"] and rec["diverged_cells"] == 0 and rec["nan_cells"] == 0 and cg_ok


def _k1_block_iters(hmm):
    """K1's iterations per block over the chunks the solve gave it (the
    class representatives with dedup, every cell without), relaunched with
    ``per_block``: the same inputs, so the same counts."""
    import torch

    from hommx_tpu_torch.micro.chunk import chunk_system
    from hommx_tpu_torch.micro.stencil_pcg import launch_config, stencil_pcg_cuda

    eng, centers = hmm._engine, hmm._sys.centers
    classes = hmm._dedup_classes(centers) if hmm._dedup_cells else None
    if classes is not None:
        centers = centers[torch.as_tensor(classes[0], device=centers.device)]
    cfg = launch_config(eng.n_reduced, eng.s)

    n = centers.shape[0]
    chunk = min(hmm._chunk or eng._auto_chunk(n), n)
    # padded as the engine pads its last chunk (copies of the first cell)
    pad = (-n) % chunk
    centers = torch.cat([centers, centers[:1].expand(pad, -1)])
    its = []
    for i in range(0, n + pad, chunk):
        sys_ = chunk_system(eng, hmm._coeff, centers[i : i + chunk], hmm._G_fn())
        ws_s, Fs = sys_.scaled()
        _, it = stencil_pcg_cuda(ws_s, Fs, sys_.Minv, sys_.st.shape, sys_.st.offsets,
                                 eng.pcg_tol, eng.pcg_maxiter, per_block=True)
        its += [int(v) for v in it.cpu()]
    return {"cells_per_block": cfg.cells_per_block, "threads": cfg.threads,
            "smem_bytes": cfg.smem_bytes, "blocks": len(its),
            "iters_per_block_min": min(its), "iters_per_block_median": statistics.median(its),
            "iters_per_block_max": max(its),
            "blocks_at_maxiter": sum(v >= eng.pcg_maxiter for v in its)}


def _f64_solution(hmm):
    """The float64 solution of the macro system assembled in float64 from
    the run's A*: the answer that its A* gives without the float32 macro
    matrix."""
    return _f64_solution_of(hmm, *_rebuild_system(hmm, macro_f64=True))


def _own_system_f64(hmm):
    """The float64 solve of the macro system ``hmm.solve()`` solved, as it
    was stored (a float32 CG system rounded once; a direct system in
    float64): the distance of u from it is the solve's alone, without the
    ~1e-4 that storing the 512² matrix in float32 costs (PR 8)."""
    vals, b = _rebuild_system(hmm, macro_f64=hmm._macro_f64)
    return _f64_solution_of(hmm, vals.double(), b.double())


def _f64_solution_of(hmm, vals, b):
    """Multigrid (or AMG) CG to 1e-12 on a float64 system of ``hmm``'s
    pattern."""
    from hommx_tpu_torch import SolverOptions
    from hommx_tpu_torch.ops import solvers

    x, _, _ = solvers.solve_ell(vals, hmm._sys.cols, b,
                                SolverOptions(rtol=1e-12, atol=0.0, maxiter=20000),
                                dia=hmm._sys.dia, mg=hmm._sys.mg, amg=hmm._sys.amg)
    return x


def _against_no_dedup(hmm, u, hmm_full, u_full) -> dict:
    """A dedup run against the dedup-off run of the same configuration:
    A*, the float64 answers of both runs' A* (their systems assembled and
    solved in float64), u against the float64 solve of its own float32
    system, and, printed only, u against the float64 answer and against the
    other run's u.  A float32 macro matrix rounds each entry on its own,
    which leaves any float32 u ~1e-4 from the float64 answer at these
    sizes, so two float32 runs whose A* differ at all land ~2e-4 apart."""
    x64, x64_full = _f64_solution(hmm), _f64_solution(hmm_full)
    vals32, b32 = _rebuild_system(hmm, macro_f64=False)
    x_own = _f64_solution_of(hmm, vals32.double(), b32.double())
    return {"astar_rel_diff_to_no_dedup": rel_diff(hmm.homogenized_tensors(),
                                                   hmm_full.homogenized_tensors()),
            "f64_solution_rel_diff_to_no_dedup": rel_diff(x64, x64_full),
            "max_rel_diff_to_own_system_f64": rel_diff(u, x_own),
            "max_rel_diff_to_f64_answer": rel_diff(u, x64),
            "no_dedup_rel_diff_to_f64_answer": rel_diff(u_full, x64_full),
            "max_rel_diff_to_no_dedup": rel_diff(u, u_full)}


def _no_dedup_ok(rec) -> bool:
    """A* within the bar of A* against float64, the float64 answers within
    DEDUP_RTOL, and u within slice_mg's bar of its own system's solve."""
    return (rec["astar_rel_diff_to_no_dedup"] <= SLICE_ASTAR_RTOL
            and rec["f64_solution_rel_diff_to_no_dedup"] <= DEDUP_RTOL
            and rec["max_rel_diff_to_own_system_f64"] <= SLICE_MG_RTOL)


def phase_slice_default(device, hmm_mg, macro_n: int = 512, micro_n: int = 16):
    """The flagship as the entry point builds it, default dedup on, with
    slice_mg's options: the same run as slice_mg but for dedup, held to
    slice_mg's run (dedup off) in this process by ``_against_no_dedup``."""
    import torch

    from hommx_tpu_torch import PoissonHMM, SolverOptions, create_unit_square
    from hommx_tpu_torch.micro import stencil_pcg
    from hommx_tpu_torch.ops import dia

    macro, micro = create_unit_square(macro_n, macro_n), create_unit_square(micro_n, micro_n)
    opts = SolverOptions(rtol=1e-5, maxiter=20000)
    stencil_pcg.KERNEL.reset_counts()
    dia.KERNEL.reset_counts()
    t0 = time.perf_counter()
    hmm = PoissonHMM(macro, flagship, 1.0, micro, 2**-5, opts, dtype=torch.float32,
                     device=device, chunk=2048)
    rec, u = _solve_record("slice_default", hmm, time.perf_counter() - t0)
    launches = {"stencil_pcg": stencil_pcg.KERNEL.launches, "dia_spmv": dia.KERNEL.launches}
    rec.update({"k1_launches": launches["stencil_pcg"], "expected_unique_cells": 2 * macro_n,
                **_against_no_dedup(hmm, u, hmm_mg, hmm_mg._u.array)})
    emit(rec)
    if not (_run_ok(rec) and rec["unique_cells"] == 2 * macro_n and _no_dedup_ok(rec)
            and min(launches.values()) >= 1):
        raise AssertionError(f"default-argument slice failed its checks: {rec}")
    return launches


def phase_golden_stratified(device):
    """The golden poisson_stratified configuration (8x8 macro, 8x8 micro,
    wavy laminate, default dedup) in float32 through K1."""
    import torch

    from hommx_tpu_torch import PoissonStratifiedHMM, create_unit_square
    from hommx_tpu_torch.micro import stencil_pcg
    from hommx_tpu_torch.ops.assembly import l2_norm_fn

    stencil_pcg.KERNEL.reset_counts()
    hmm = PoissonStratifiedHMM(create_unit_square(8, 8), golden_stratified_coeff, lambda x: 1.0,
                               create_unit_square(8, 8), 2**-4, golden_stratified_dtheta,
                               dtype=torch.float32, device=device)
    u = hmm.solve().array
    launches = {"stencil_pcg": stencil_pcg.KERNEL.launches}
    l2 = float(l2_norm_fn(hmm._sys.verts64, hmm._sys.cells, u.double()))
    umax = float(u.abs().max())
    rel = [abs(g - w) / abs(w) for g, w in zip((l2, umax), GOLDEN_POISSON_STRATIFIED)]
    emit({"phase": "golden_stratified", "l2": l2, "max_u": umax, "rel_err": rel,
          "unique_cells": hmm.diagnostics["unique_cells"], "k1_launches": launches["stencil_pcg"],
          "macro_method": hmm._macro_method})
    if not (all(math.isfinite(r) and r < GOLDEN_RTOL for r in rel)
            and launches["stencil_pcg"] >= 1):
        raise AssertionError(f"stratified golden functionals off: {rel}")
    return launches


def _laminate(device, macro_n, micro_n, **kw):
    """PoissonStratifiedHMM on examples/diffusion/laminate.py's coefficient
    and map, f = 1, Darcy boundary conditions, slice_mg's options."""
    import torch

    from hommx_tpu_torch import PoissonStratifiedHMM, SolverOptions, create_unit_square
    from hommx_tpu_torch.examples.diffusion import laminate

    t0 = time.perf_counter()
    hmm = PoissonStratifiedHMM(create_unit_square(macro_n, macro_n), laminate.A,
                               lambda x: 1.0, create_unit_square(micro_n, micro_n), 2**-5,
                               laminate.Dtheta, SolverOptions(rtol=1e-5, maxiter=20000),
                               dtype=torch.float32, device=device, **kw)
    darcy(hmm)
    return hmm, time.perf_counter() - t0


def phase_slice_stratified(device, macro_n: int = 512, micro_n: int = 30, checked: int = 1024):
    """The laminate on a 512² macro mesh with the example's 30² micro mesh,
    default arguments (dedup on): K1 at n = 900, s = 2, its iterations per
    block, and A* of up to ``checked`` cells the fallback detector flags
    against the plain route in float64."""
    import torch

    from hommx_tpu_torch import MicroEngine, create_unit_square
    from hommx_tpu_torch.examples.diffusion import laminate
    from hommx_tpu_torch.micro import stencil_pcg
    from hommx_tpu_torch.micro.chunk import tensors_chunk_plain
    from hommx_tpu_torch.ops import dia

    stencil_pcg.KERNEL.reset_counts()
    dia.KERNEL.reset_counts()
    hmm, t_setup = _laminate(device, macro_n, micro_n)
    rec, _ = _solve_record("slice_stratified", hmm, t_setup)
    launches = {"stencil_pcg": stencil_pcg.KERNEL.launches, "dia_spmv": dia.KERNEL.launches}
    rec.update({"k1_launches": launches["stencil_pcg"], **_k1_block_iters(hmm)})
    # cells that the zero-corrector fallback detector flags, against the
    # plain route in float64: a generator along the layers has a zero
    # corrector, A* = A⁰ there, which the detector cannot tell from a
    # clamped solve
    flagged = torch.as_tensor(hmm.diagnostics["fallback_cells"][:checked], device=device)
    if flagged.numel():
        eng64 = MicroEngine(create_unit_square(micro_n, micro_n), dtype=torch.float64,
                            device=device)
        A64 = tensors_chunk_plain(eng64, laminate.A, hmm._sys.centers[flagged].double(),
                                  laminate.Dtheta)
        rec["fallback_astar_rel_err_f64"] = rel_diff(hmm.homogenized_tensors()[flagged], A64)
    emit(rec)
    if not (_run_ok(rec) and rec["blocks_at_maxiter"] == 0
            and rec.get("fallback_astar_rel_err_f64", 0.0) < SLICE_ASTAR_RTOL
            and rec["unique_cells"] < rec["num_cells"] and min(launches.values()) >= 1):
        raise AssertionError(f"stratified slice failed its checks: {rec}")
    return launches


def phase_slice_stratified_full(device, macro_n: int = 128, micro_n: int = 30,
                                checked: int = 1024):
    """The laminate at 128² with dedup off (every cell through K1) and on,
    the second held to the first by ``_against_no_dedup``, and A* of
    ``checked`` cells against the plain route in float64."""
    import torch

    from hommx_tpu_torch import MicroEngine, create_unit_square
    from hommx_tpu_torch.examples.diffusion import laminate
    from hommx_tpu_torch.micro import stencil_pcg
    from hommx_tpu_torch.micro.chunk import tensors_chunk_plain
    from hommx_tpu_torch.micro.krylov import _map_chunked
    from hommx_tpu_torch.ops import dia

    stencil_pcg.KERNEL.reset_counts()
    dia.KERNEL.reset_counts()
    recs, us, hmms = [], [], []
    for dedup in (False, True):
        hmm, t_setup = _laminate(device, macro_n, micro_n, dedup_cells=dedup)
        rec, u = _solve_record("slice_stratified_full" if not dedup else
                               f"slice_stratified_{macro_n}_dedup", hmm, t_setup)
        recs.append(rec)
        us.append(u)
        hmms.append(hmm)
    launches = {"stencil_pcg": stencil_pcg.KERNEL.launches, "dia_spmv": dia.KERNEL.launches}
    full = hmms[0]
    recs[0].update(_k1_block_iters(full))
    recs[1].update(_against_no_dedup(hmms[1], us[1], full, us[0]))
    A32 = full.homogenized_tensors()
    idx = torch.linspace(0, A32.shape[0] - 1, checked, device=device).round().long()
    eng64 = MicroEngine(create_unit_square(micro_n, micro_n), dtype=torch.float64, device=device)
    A64 = _map_chunked(lambda c: tensors_chunk_plain(eng64, laminate.A, c, laminate.Dtheta),
                       full._sys.centers[idx].double(), checked)
    recs[0].update({"k1_launches": launches["stencil_pcg"], "checked_cells": checked,
                    "astar_rel_err_f64": rel_diff(A32[idx], A64)})
    for rec in recs:
        emit(rec)
    if not (all(_run_ok(r) for r in recs) and recs[0]["blocks_at_maxiter"] == 0
            and recs[0]["unique_cells"] == recs[0]["num_cells"]
            and recs[0]["astar_rel_err_f64"] < SLICE_ASTAR_RTOL
            and _no_dedup_ok(recs[1]) and min(launches.values()) >= 1):
        raise AssertionError(f"full stratified slice failed its checks: {recs}")
    return launches


def phase_slice_elasticity_dedup(device, beam, beam_cg):
    """The beam with the default dedup at 20x6x6 and at 40x12x12 (with
    ``dedup_verify=8``), each held to the dedup-off run of this process
    (``beam``, ``beam_cg``): A* within the bar of A* against float64, and u
    within the bar of a float32 elasticity solution (GOLDEN_ELASTICITY_RTOL:
    A*'s float32 rounding, 5e-7 of its largest entry, reaches u amplified by
    the beam's conditioning, ~1e-4 at 40x12x12)."""
    from hommx_tpu_torch.ops import chol_kernel, dia

    chol_kernel.KERNEL.reset_counts()
    dia.KERNEL.reset_counts()
    failed = []
    for macro_n, full, verify in (((20, 6, 6), beam, 0), ((40, 12, 12), beam_cg, 8)):
        k3_before = chol_kernel.KERNEL.launches
        t0 = time.perf_counter()
        hmm = make_beam(device, macro_n, dedup_cells=True, dedup_verify=verify)
        rec, u = _solve_record("slice_elasticity_dedup_" + "x".join(map(str, macro_n)), hmm,
                               time.perf_counter() - t0)
        rec.update({"dedup_verify": verify, "k3_launches": chol_kernel.KERNEL.launches - k3_before,
                    "astar_rel_diff_to_no_dedup": rel_diff(hmm.homogenized_tensors(),
                                                           full.homogenized_tensors()),
                    "max_rel_diff_to_no_dedup": rel_diff(u, full._u.array)})
        emit(rec)
        if not (_run_ok(rec) and rec["unique_cells"] < rec["num_cells"] and rec["k3_launches"] >= 1
                and rec["astar_rel_diff_to_no_dedup"] <= SLICE_ASTAR_RTOL
                and rec["max_rel_diff_to_no_dedup"] <= GOLDEN_ELASTICITY_RTOL):
            failed.append(rec["phase"])
    if failed:
        raise AssertionError(f"beam runs with dedup failed their checks: {failed}")
    return {"chol_solve": chol_kernel.KERNEL.launches,
            "dia_spmv_f64": dia.KERNEL.counts["hommx_dia_spmv_f64"]}


# -- phases of the periodic, FEM and per-cell slice ---------------------------


def _true_residual(vals, cols, b, x) -> float:
    """‖b − A x‖ / ‖b‖ in float64."""
    import torch

    from hommx_tpu_torch.ops.sparse import spmv

    b = b.double()
    return float(torch.linalg.vector_norm(b - spmv(vals.double(), cols, x.double()))
                 / torch.linalg.vector_norm(b))


def phase_fem_flagship(device, n: int = 1024, hmm_n: int = 15):
    """examples/hmm.py's fine-mesh reference at n² on the 5x5 rectangle:
    fem_solve of A(x, x/ε) (ε = 1/32), f = 0, Darcy boundary conditions,
    default SolverOptions (multigrid CG, float32, K2), held to a float64
    multigrid CG solve of the same system; then the example's HMM (hmm_n²
    macro, hmm_n² micro) against this FEM, as the example prints it."""
    import torch

    from hommx_tpu_torch import PoissonHMM, SolverOptions, create_rectangle, create_unit_square
    from hommx_tpu_torch.examples._common import darcy_bcs
    from hommx_tpu_torch.micro import stencil_pcg
    from hommx_tpu_torch.models.common import merge_bcs
    from hommx_tpu_torch.models.fem import fem_solve, fem_system
    from hommx_tpu_torch.ops import dia, solvers
    from hommx_tpu_torch.ops.function_space import FunctionSpace
    from hommx_tpu_torch.utils.validation import relative_l2_vs_reference

    eps = 2**-5

    def coeff(x):
        return flagship(x, x / eps)

    dia.KERNEL.reset_counts()
    stencil_pcg.KERNEL.reset_counts()
    t0 = time.perf_counter()
    V = FunctionSpace(create_rectangle([[0, 0], [5, 5]], [n, n]), 1)
    bcs = darcy_bcs(V)
    u = fem_solve(V, coeff, 0.0, bcs, dtype=torch.float32, device=device)
    torch.cuda.synchronize()
    t_total = time.perf_counter() - t0
    k2 = dia.KERNEL.launches
    dg = u.diagnostics
    rec = {"phase": "fem_flagship", "n": n, "dofs": V.num_dofs, "cells": V.mesh.num_cells,
           "cells_per_period": n / 5 * eps, "total_seconds": t_total, **dg,
           "macro_method": u.macro_method, "macro_iterations": u.solver_iterations,
           "macro_residual": u.solver_residual, "dia_spmv_launches": k2,
           "finite": bool(torch.isfinite(u.array).all())}
    # the float64 multigrid CG of the same (float32-stored) system
    sys = u.system
    mask, bvals = merge_bcs(bcs, V.num_dofs, torch.float64, device)
    vals, b = fem_system(sys, coeff, "scalar", 0.0, mask, bvals)
    vals, b = vals.float().double(), b.float().double()
    x64, k64, _ = solvers.solve_ell(vals, sys.cols, b,
                                    SolverOptions(rtol=1e-12, atol=0.0, maxiter=20000),
                                    dia=sys.dia, mg=sys.mg)
    rec.update({"f64_iterations": k64, "f64_true_rel_residual": _true_residual(vals, sys.cols, b, x64),
                "true_rel_residual_f64": _true_residual(vals, sys.cols, b, u.array),
                "float32_floor_rel_residual": _true_residual(vals, sys.cols, b, x64.float()),
                "max_rel_diff_to_f64": rel_diff(u.array, x64)})
    # the example's HMM against this reference
    t0 = time.perf_counter()
    hmm = PoissonHMM(create_rectangle([[0, 0], [5, 5]], [hmm_n, hmm_n]), flagship, 0.0,
                     create_unit_square(hmm_n, hmm_n), eps, dtype=torch.float32, device=device)
    darcy(hmm)
    u_hmm = hmm.solve()
    torch.cuda.synchronize()
    rec.update({"hmm_seconds": time.perf_counter() - t0,
                "hmm_unique_cells": hmm.diagnostics["unique_cells"],
                "hmm_k1_launches": stencil_pcg.KERNEL.launches,
                "hmm_rel_l2_vs_fem": relative_l2_vs_reference(u_hmm, u)})
    emit(rec)
    if not (rec["finite"] and rec["macro_method"] == "cg" and _cg_counts_ok(rec)
            and rec["macro_iterations"] < SolverOptions().maxiter
            and rec["max_rel_diff_to_f64"] <= FEM_FLAGSHIP_RTOL
            and rec["f64_true_rel_residual"] <= 1e-10 and k2 >= 1
            and math.isfinite(rec["hmm_rel_l2_vs_fem"])):
        raise AssertionError(f"FEM flagship failed its checks: {rec}")
    return {"dia_spmv": k2, "stencil_pcg": stencil_pcg.KERNEL.launches}


def phase_golden_periodic_fem(device):
    """The goldens periodic_tensor (PoissonPeriodicHMM, 4x4 macro, 16x16
    micro, A = 2 + sin 2πy₀; through K1) and fem (PoissonFEM on 32x32,
    float64 direct solve of the float64-assembled system) in float32."""
    import torch

    from hommx_tpu_torch import PoissonFEM, PoissonPeriodicHMM, create_unit_square
    from hommx_tpu_torch.micro import stencil_pcg
    from hommx_tpu_torch.ops.assembly import l2_norm_fn

    stencil_pcg.KERNEL.reset_counts()
    t0 = time.perf_counter()
    ph = PoissonPeriodicHMM(create_unit_square(4), lambda y: 2.0 + torch.sin(2 * torch.pi * y[0]),
                            lambda x: 1.0, create_unit_square(16), dtype=torch.float32,
                            device=device)
    t_setup = time.perf_counter() - t0
    A = ph.compute_effective_tensor()
    torch.cuda.synchronize()
    t_micro = time.perf_counter() - t0 - t_setup
    k1 = stencil_pcg.KERNEL.launches
    got_p = (float(A[0, 0]), float(A[1, 1]))
    msh = create_unit_square(32)
    fem = PoissonFEM(msh, lambda x: 1.0 + 0.5 * torch.sin(2 * torch.pi * x[0])
                     * torch.sin(2 * torch.pi * x[1]), lambda x: 1.0, dtype=torch.float32,
                     device=device)
    u = fem.solve().array
    fem_dg = fem._u.diagnostics
    verts = torch.as_tensor(msh.vertices, device=device)
    cells = torch.as_tensor(msh.cells, device=device)
    got_f = (float(l2_norm_fn(verts, cells, u.double())), float(u.abs().max()))
    rel = {"periodic_tensor": [abs(g - w) / abs(w) for g, w in zip(got_p, GOLDEN_PERIODIC_TENSOR)],
           "fem": [abs(g - w) / abs(w) for g, w in zip(got_f, GOLDEN_FEM)]}
    emit({"phase": "golden_periodic_fem", "periodic_tensor": got_p, "fem": got_f,
          "rel_err": rel, "k1_launches": k1, "periodic_setup_seconds": t_setup,
          "periodic_micro_seconds": t_micro, "fem_macro_method": fem._u.macro_method,
          "fem_setup_seconds": fem_dg["setup_seconds"],
          "fem_assembly_seconds": fem_dg["assembly_seconds"],
          "fem_solve_seconds": fem_dg["solve_seconds"]})
    if not (all(math.isfinite(r) and r < GOLDEN_RTOL for v in rel.values() for r in v)
            and k1 >= 1):
        raise AssertionError(f"periodic / FEM goldens off: {rel}")
    return {"stencil_pcg": k1}


def phase_periodic_identity(device, macro_n: int = 512, micro_n: int = 16):
    """PoissonPeriodicHMM against PoissonHMM (default dedup: one unique
    cell) for A = 2 + sin 2πy₀ on the 512² macro mesh and the 16² micro
    mesh, zero box-boundary BCs, slice_mg's options: u and the assembled
    macro ELL values."""
    import torch

    from hommx_tpu_torch import PoissonHMM, PoissonPeriodicHMM, SolverOptions, create_unit_square
    from hommx_tpu_torch.micro import stencil_pcg
    from hommx_tpu_torch.ops import dia
    from hommx_tpu_torch.utils.validation import zero_dirichlet_bcs

    macro, micro = create_unit_square(macro_n), create_unit_square(micro_n)
    opts = SolverOptions(rtol=1e-5, maxiter=20000)
    stencil_pcg.KERNEL.reset_counts()
    dia.KERNEL.reset_counts()
    t0 = time.perf_counter()
    per = PoissonPeriodicHMM(macro, lambda y: 2.0 + torch.sin(2 * torch.pi * y[0]), lambda x: 1.0,
                             micro, 2**-5, opts, dtype=torch.float32, device=device)
    per.set_boundary_conditions(zero_dirichlet_bcs(per.function_space))
    t_setup = time.perf_counter() - t0
    u_p = per.solve().array
    torch.cuda.synchronize()
    t_per = time.perf_counter() - t0
    k1_per, k2_per = stencil_pcg.KERNEL.launches, dia.KERNEL.launches
    t0 = time.perf_counter()
    hmm = PoissonHMM(macro, lambda x, y: 2.0 + torch.sin(2 * torch.pi * y[0]), lambda x: 1.0,
                     micro, 2**-5, opts, dtype=torch.float32, device=device)
    hmm.set_boundary_conditions(zero_dirichlet_bcs(hmm.function_space))
    u_h = hmm.solve().array
    torch.cuda.synchronize()
    t_hmm = time.perf_counter() - t0
    v_p, v_h = per._last_vals_bc.double(), hmm._last_vals_bc.double()
    dp = per.diagnostics
    rec = {"phase": "periodic_identity", "dofs": per.function_space.num_dofs,
           "periodic_setup_seconds": t_setup, "periodic_total_seconds": t_per,
           "periodic_micro_seconds": dp["micro_seconds"],
           "periodic_macro_seconds": dp["macro_seconds"],
           "periodic_macro_iterations": dp["macro_iterations"],
           "hmm_total_seconds": t_hmm, "hmm_micro_seconds": hmm.diagnostics["micro_seconds"],
           "hmm_macro_seconds": hmm.diagnostics["macro_seconds"],
           "hmm_macro_iterations": hmm.diagnostics["macro_iterations"],
           "hmm_unique_cells": hmm.diagnostics["unique_cells"],
           "A_hom": per.A_hom.tolist(),
           "astar_rel_diff": rel_diff(hmm.homogenized_tensors()[0], per.A_hom),
           "k1_launches_periodic": k1_per, "k2_launches_periodic": k2_per,
           "k1_launches": stencil_pcg.KERNEL.launches, "dia_spmv_launches": dia.KERNEL.launches,
           "u_rel_diff": rel_diff(u_p, u_h),
           "ell_rel_diff": float((v_p - v_h).abs().max() / v_h.abs().max()),
           "finite": bool(torch.isfinite(u_p).all() and torch.isfinite(u_h).all())}
    emit(rec)
    if not (rec["finite"] and rec["hmm_unique_cells"] == 1 and k1_per >= 1 and k2_per >= 1
            and rec["u_rel_diff"] <= IDENTITY_U_RTOL and rec["ell_rel_diff"] <= IDENTITY_ELL_RTOL):
        raise AssertionError(f"PoissonPeriodicHMM vs PoissonHMM identity failed: {rec}")
    return {"stencil_pcg": rec["k1_launches"], "dia_spmv": rec["dia_spmv_launches"]}


def phase_elasticity_periodic(device, macro_n=(40, 12, 12), fem_n=(20, 6, 6)):
    """ElasticityPeriodicHMM with the beam's Hooke tensor as A(y) (its
    rotation frozen at x = 0, where it is the identity) on the 4³ cube (K3,
    n = 192, s = 6) and the beam box with the beam's load and clamp
    (default options: float64 multigrid CG through K2's float64 instance);
    A_hom against the float64 plain route; then LinearElasticityFEM
    against LinearElasticityHMM with one constant Hooke tensor on 20x6x6."""
    import torch

    from hommx_tpu_torch import (
        ElasticityPeriodicHMM,
        LinearElasticityFEM,
        LinearElasticityHMM,
        MicroEngine,
        create_box,
        create_unit_cube,
    )
    from hommx_tpu_torch.micro.chunk import tensors_chunk_chol_plain
    from hommx_tpu_torch.ops import chol_kernel, dia
    from hommx_tpu_torch.utils.validation import hooke_tensor

    chol_kernel.KERNEL.reset_counts()
    dia.KERNEL.reset_counts()
    coeff = beam_coeff(False)
    zero = torch.zeros(3, dtype=torch.float64)
    A_y = lambda y: coeff(zero.to(y.device), y)  # noqa: E731
    box = [[0, 0, 0], [BEAM_L, BEAM_W, BEAM_H]]
    f = torch.tensor([0.0, 0.0, -0.05 * (BEAM_W / BEAM_L) ** 2], dtype=torch.float64)
    t0 = time.perf_counter()
    per = ElasticityPeriodicHMM(create_box(box, list(macro_n)), A_y, lambda x: f,
                                create_unit_cube(4), 2**-5, dtype=torch.float32, device=device)
    clamp_x0(per)
    t_setup = time.perf_counter() - t0
    u = per.solve().array
    torch.cuda.synchronize()
    t_total = time.perf_counter() - t0
    dp = per.diagnostics
    k3, k2_64 = chol_kernel.KERNEL.launches, dia.KERNEL.counts["hommx_dia_spmv_f64"]
    eng64 = MicroEngine(create_unit_cube(4), bs=3, coeff_kind="tensor4", dtype=torch.float64,
                        device=device)
    A64 = tensors_chunk_chol_plain(eng64, lambda x, y: A_y(y),
                                   torch.zeros((1, 3), dtype=torch.float64, device=device))[0]
    rec = {"phase": "elasticity_periodic", "macro_n": list(macro_n),
           "dofs": per.function_space.num_dofs, "setup_seconds": t_setup,
           "total_seconds": t_total, "micro_seconds": dp["micro_seconds"],
           "macro_seconds": dp["macro_seconds"], "macro_method": dp["macro_method"],
           "macro_iterations": dp["macro_iterations"], "macro_steps": dp["macro_steps"],
           "k3_launches": k3, "dia_spmv_f64_launches": k2_64,
           "dia_spmv_f32_launches": dia.KERNEL.counts["hommx_dia_spmv_f32"],
           "A_hom_rel_err_f64": rel_diff(per.A_hom.reshape(9, 9), A64),
           "finite": bool(torch.isfinite(u).all()), "tip_uz_min": float(u.reshape(-1, 3)[:, 2].min())}
    # a constant Hooke tensor: the HMM's A* is the tensor itself
    C = hooke_tensor(3, lambda x, y: 1.0, lambda x, y: 0.5)
    runs = {}
    for name in ("fem", "hmm"):
        mesh = create_box(box, list(fem_n))
        if name == "fem":
            model = LinearElasticityFEM(mesh, lambda x: C(x, x), lambda x: f,
                                        dtype=torch.float32, device=device)
        else:
            model = LinearElasticityHMM(mesh, C, lambda x: f, create_unit_cube(4), 2**-5,
                                        dtype=torch.float32, device=device)
        clamp_x0(model)
        runs[name] = model.solve().array
    rec["fem_vs_hmm_rel_diff"] = rel_diff(runs["hmm"], runs["fem"])
    rec["k3_launches_all"] = chol_kernel.KERNEL.launches
    emit(rec)
    if not (rec["finite"] and rec["macro_method"] == "cg" and k3 >= 1
            and _cg_counts_ok(rec, "dia_spmv_f64_launches") and rec["dia_spmv_f32_launches"] == 0
            and rec["A_hom_rel_err_f64"] <= PERIODIC_ASTAR_RTOL
            and rec["fem_vs_hmm_rel_diff"] <= FEM_HMM_RTOL):
        raise AssertionError(f"elasticity periodic / FEM checks failed: {rec}")
    return {"chol_solve": rec["k3_launches_all"],
            "dia_spmv_f64": dia.KERNEL.counts["hommx_dia_spmv_f64"]}


def phase_chol_batched(device, cells: int = 8640, chunk: int = 1080):
    """The bench row's elasticity micro stage (8640 fresh cells, 4³ cube,
    chunk 1080) with HOMMX_CHOL_SOLVE_BATCH=1: one K3 launch over the whole
    batch.  A* against the in-chunk route's; the kernel's residual on the
    whole batch against the plain version's (phase 5's bar); the one
    launch timed beside the plain version and torch.linalg.solve (LU, no
    refinement) on the same batch, with its bound from the batch's
    shapes."""
    import numpy as np
    import torch

    from hommx_tpu_torch import MicroEngine, create_unit_cube
    from hommx_tpu_torch.micro.chunk import chol_batched_system
    from hommx_tpu_torch.ops import chol_kernel
    from hommx_tpu_torch.ops.chol_kernel import fused_chol_solve_cuda, fused_chol_solve_plain

    eng = MicroEngine(create_unit_cube(4), bs=3, coeff_kind="tensor4", dtype=torch.float32,
                      device=device)
    centers = torch.as_tensor(np.random.default_rng(1).uniform(0, 1, (cells, 3)),
                              dtype=torch.float32, device=device)
    coeff = beam_coeff(True)
    chol_kernel.KERNEL.reset_counts()
    times = {"in_chunk": [], "batched": []}
    out = {}
    saved = os.environ.get("HOMMX_CHOL_SOLVE_BATCH")
    try:
        for _ in range(2):
            for route, flag in (("in_chunk", "0"), ("batched", "1")):
                os.environ["HOMMX_CHOL_SOLVE_BATCH"] = flag
                before = chol_kernel.KERNEL.launches
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out[route] = eng.tensors_for_centers(coeff, centers, G_fn=beam_rotation,
                                                     chunk=chunk)
                torch.cuda.synchronize()
                times[route].append(time.perf_counter() - t0)
                out[route + "_launches"] = chol_kernel.KERNEL.launches - before
    finally:
        if saved is None:
            os.environ.pop("HOMMX_CHOL_SOLVE_BATCH", None)
        else:
            os.environ["HOMMX_CHOL_SOLVE_BATCH"] = saved
    launches = chol_kernel.KERNEL.launches
    Ks, Fs, _, _ = chol_batched_system(eng, coeff, centers, beam_rotation, chunk)
    Xk = fused_chol_solve_cuda(Ks, Fs)
    Xp = fused_chol_solve_plain(Ks, Fs)

    def residual(X):  # max over cells of ‖F − K X‖∞ / ‖F‖∞, float64
        R = Fs.double() - torch.einsum("cij,jsc->isc", Ks.double(), X.double())
        return float((R.abs().amax(dim=(0, 1)) / Fs.double().abs().amax(dim=(0, 1))).max())

    C, n, s = Ks.shape[0], eng.n_reduced, eng.s
    flops = C * (n**3 / 3 + 4.0 * n * n * s + 2.0 * n * n * s)
    bound_ms, bound_by = bound(flops, 4.0 * C * (n * n + 2 * n * s))
    rec = {"phase": "chol_batched", "cells": cells, "chunk": chunk, "n": n, "s": s,
           "seconds": times, "k3_launches_in_chunk": out["in_chunk_launches"],
           "k3_launches_batched": out["batched_launches"],
           "astar_rel_diff_to_in_chunk": rel_diff(out["batched"], out["in_chunk"]),
           "residual": residual(Xk), "plain_residual": residual(Xp),
           "whole_batch_ms": time_ms(lambda: fused_chol_solve_cuda(Ks, Fs), reps=10),
           "plain_ms": time_ms(lambda: fused_chol_solve_plain(Ks, Fs), reps=3, warmup=1),
           "library_ms": time_ms(lambda: torch.linalg.solve(Ks, Fs.permute(2, 0, 1)), reps=3,
                                 warmup=1),
           "bound_ms": bound_ms, "bound_by": bound_by, "gflop": flops / 1e9,
           "resident_gib": (Ks.numel() + Fs.numel()) * 4 / 2**30,
           "finite": bool(torch.isfinite(out["batched"]).all())}
    del Ks, Fs, Xk, Xp
    torch.cuda.empty_cache()
    emit(rec)
    if not (rec["finite"] and rec["k3_launches_batched"] == 1
            and rec["astar_rel_diff_to_in_chunk"] <= SLICE_ASTAR_RTOL
            and rec["residual"] < K3_RTOL
            and rec["residual"] <= K3_PLAIN_FACTOR * rec["plain_residual"]):
        raise AssertionError(f"whole-batch Cholesky route failed its checks: {rec}")
    return {"chol_solve": launches}


def phase_kc_gather(device, cells: int = 8640, chunk: int = 1080):
    """The fixed-order Kc assembly: two identical dedup solves of the
    40x12x12 beam (A* and u bitwise equal); the beam's A* with the gather
    against the scatter; the bench-size elasticity micro stage with the
    gather and the scatter in turns, timed."""
    import numpy as np
    import torch

    from hommx_tpu_torch import MicroEngine, create_unit_cube
    from hommx_tpu_torch.micro.chunk import _get_kc_gather
    from hommx_tpu_torch.ops import chol_kernel, dia

    chol_kernel.KERNEL.reset_counts()
    dia.KERNEL.reset_counts()
    saved = os.environ.pop("HOMMX_KC_ASSEMBLY", None)
    try:
        runs, seconds = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            hmm = make_beam(device, (40, 12, 12), dedup_cells=True)
            t_setup = time.perf_counter() - t0
            u = hmm.solve().array
            runs.append((hmm.homogenized_tensors(), u, hmm))
            seconds.append({"setup": t_setup, "micro": hmm.diagnostics["micro_seconds"],
                            "macro": hmm.diagnostics["macro_seconds"]})
        gathered = _get_kc_gather(runs[0][2]._engine) is not None
        launches = {"chol_solve": chol_kernel.KERNEL.launches,
                    "dia_spmv_f64": dia.KERNEL.counts["hommx_dia_spmv_f64"]}
        os.environ["HOMMX_KC_ASSEMBLY"] = "scatter"
        hmm_s = make_beam(device, (40, 12, 12), dedup_cells=True)
        A_s = hmm_s.homogenized_tensors()
        scattered = _get_kc_gather(hmm_s._engine) is None
        # the bench-size micro stage, gather and scatter in turns
        centers = torch.as_tensor(np.random.default_rng(1).uniform(0, 1, (cells, 3)),
                                  dtype=torch.float32, device=device)
        coeff = beam_coeff(True)
        engines = {}
        for mode in ("gather", "scatter"):
            os.environ["HOMMX_KC_ASSEMBLY"] = mode
            engines[mode] = MicroEngine(create_unit_cube(4), bs=3, coeff_kind="tensor4",
                                        dtype=torch.float32, device=device)
            _get_kc_gather(engines[mode])
            engines[mode].tensors_for_centers(coeff, centers[:chunk], G_fn=beam_rotation)
        times, A = {"gather": [], "scatter": []}, {}
        for mode in ("gather", "scatter", "scatter", "gather", "gather", "scatter"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            A[mode] = engines[mode].tensors_for_centers(coeff, centers, G_fn=beam_rotation,
                                                        chunk=chunk)
            torch.cuda.synchronize()
            times[mode].append(time.perf_counter() - t0)
    finally:
        if saved is None:
            os.environ.pop("HOMMX_KC_ASSEMBLY", None)
        else:
            os.environ["HOMMX_KC_ASSEMBLY"] = saved
    (A1, u1, h1), (A2, u2, h2) = runs
    rec = {"phase": "kc_gather", "gather_default_on_cuda": gathered,
           "scatter_when_asked": scattered, "unique_cells": h1.diagnostics["unique_cells"],
           "macro_iterations": [h1.diagnostics["macro_iterations"],
                                h2.diagnostics["macro_iterations"]],
           "beam_seconds": seconds,
           "astar_bitwise_equal": bool(torch.equal(A1, A2)),
           "u_bitwise_equal": bool(torch.equal(u1, u2)),
           "u_max_abs_diff": float((u1.double() - u2.double()).abs().max()),
           "astar_rel_diff_gather_vs_scatter": rel_diff(A1, A_s),
           "stage_astar_rel_diff_gather_vs_scatter": rel_diff(A["gather"], A["scatter"]),
           "stage_seconds_gather": times["gather"], "stage_seconds_scatter": times["scatter"],
           "cells": cells, "chunk": chunk, **{f"{k}_launches": v for k, v in launches.items()}}
    emit(rec)
    if not (gathered and scattered and rec["astar_bitwise_equal"] and rec["u_bitwise_equal"]
            and rec["astar_rel_diff_gather_vs_scatter"] <= GATHER_RTOL
            and rec["stage_astar_rel_diff_gather_vs_scatter"] <= SLICE_ASTAR_RTOL
            and min(launches.values()) >= 1):
        raise AssertionError(f"fixed-order Kc assembly failed its checks: {rec}")
    return launches


def _theta_flagship(holder):
    """The flagship coefficient with a parameter: A = 1.1 + θx₀ + sin 2πy₀,
    θ read from ``holder[0]`` at each evaluation."""
    import torch

    def A(x, y):
        return 1.1 + holder[0] * x[0] + torch.sin(2 * torch.pi * y[0])

    return A


def _grad_pass(loss, theta, order: int = 1) -> dict:
    """One forward and one backward pass of ``loss(theta)`` (the backward
    twice for ``order`` 2): J, the derivative, each pass's seconds, and on
    the card each kernel's launches in each pass and the peak memory after
    each."""
    import torch

    from hommx_tpu_torch.micro import stencil_pcg
    from hommx_tpu_torch.ops import chol_kernel, dia

    kernels = {"stencil_pcg": lambda: stencil_pcg.KERNEL.launches,
               "dia_spmv": lambda: dia.KERNEL.launches,
               "chol_solve": lambda: chol_kernel.KERNEL.counts["hommx_chol_solve_f32"],
               "chol_solve_large": lambda: chol_kernel.KERNEL.counts["hommx_chol_solve_large_f32"]}
    cuda = theta.is_cuda

    def mark():
        if cuda:
            torch.cuda.synchronize()
        return time.perf_counter(), {k: count() for k, count in kernels.items()}

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0, n0 = mark()
    J = loss(theta)
    t1, n1 = mark()
    rec = {"forward_seconds": t1 - t0}
    if cuda:
        rec["forward_peak_bytes"] = torch.cuda.max_memory_allocated()
    (g,) = torch.autograd.grad(J, theta, create_graph=order > 1)
    if order > 1:
        (g,) = torch.autograd.grad(g, theta)
    t2, n2 = mark()
    rec.update({"J": float(J.detach()), "derivative": float(g.detach()),
                "backward_seconds": t2 - t1})
    if cuda:
        rec["peak_bytes"] = torch.cuda.max_memory_allocated()
        rec["forward_launches"] = {k: n1[k] - n0[k] for k in kernels}
        rec["backward_launches"] = {k: n2[k] - n1[k] for k in kernels}
    return rec


def _k1_log():
    """Wrap the K1 wrapper that the chunk route calls, keeping each
    launch's iteration count and CUDA-event time (forward and adjoint
    solves alike); returns (log, restore)."""
    import torch

    from hommx_tpu_torch.micro import chunk

    orig = chunk.stencil_pcg
    log = []

    def pcg(*args):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = orig(*args)
        b.record()
        log.append((out[1], a, b))
        return out

    chunk.stencil_pcg = pcg
    return log, lambda: setattr(chunk, "stencil_pcg", orig)


def _k1_summary(entries) -> dict:
    its = [int(k) for k, _, _ in entries]
    ms = [a.elapsed_time(b) for _, a, b in entries]
    if not its:
        return {"launches": 0}
    return {"launches": len(its), "iters_min": min(its),
            "iters_median": statistics.median(its), "iters_max": max(its),
            "ms_total": sum(ms), "ms_median": statistics.median(ms)}


def _rel(a, b) -> float:
    return abs(a - b) / abs(b)


def _central_difference(loss, theta: float, h: float, device, dtype) -> float:
    """(J(θ + h) − J(θ − h)) / 2h of the forward alone."""
    import torch

    with torch.no_grad():
        jp, jm = (float(loss(torch.tensor(theta + d, dtype=dtype, device=device)))
                  for d in (h, -h))
    return (jp - jm) / (2 * h)


def _poisson_grad(device, dtype, macro_n, micro_n, order=1):
    """dJ/dθ (or d²J/dθ²) of J = Σu² through PoissonHMM.build_pipeline on
    the flagship with θ, at θ = 1, default options; (record, loss, step)."""
    import torch

    from hommx_tpu_torch import PoissonHMM, create_unit_square

    holder = [1.0]
    hmm = PoissonHMM(create_unit_square(macro_n, macro_n), _theta_flagship(holder),
                     lambda x: 1.0, create_unit_square(micro_n, micro_n), 2**-5,
                     dtype=dtype, device=device, dedup_cells=False)
    step, centers = hmm.build_pipeline()

    def loss(th):
        holder[0] = th
        return (step(centers).double() ** 2).sum()

    theta = torch.tensor(1.0, dtype=dtype, device=device, requires_grad=True)
    rec = _grad_pass(loss, theta, order)
    rec["macro_iterations"] = list(step.macro_solve.iterations)
    return rec, loss, (hmm, step, centers, holder)


def phase_pipeline_grad(device, macro_n: int = 512, micro_n: int = 16, check_n: int = 64,
                        d2_n: int = 8):
    """Differentiation of the Poisson pipeline (A = 1.1 + θx₀ + sin 2πy₀,
    J = Σu², default options, float32): at macro_n² (the 512² slice, 16²
    micro) step(centers) against solve() with dedup off, dJ/dθ with each
    pass's seconds, K1's and K2's launches, K1's iterations and time in
    the forward and adjoint launches, the adjoint CG's iterations and the
    peak memory, against a central difference of the float32 forward; at
    check_n² dJ/dθ against the CPU's float64 gradient of the same pipeline
    (plain versions); at d2_n² (the golden size: K1 twice, the direct macro
    solve) d²J/dθ² against the CPU's float64 value."""
    import torch

    from hommx_tpu_torch.micro import stencil_pcg
    from hommx_tpu_torch.ops import dia

    stencil_pcg.KERNEL.reset_counts()
    dia.KERNEL.reset_counts()
    log, restore = _k1_log()
    try:
        main, loss, (hmm, step, centers, holder) = _poisson_grad(
            device, torch.float32, macro_n, micro_n)
        torch.cuda.synchronize()
        n_fwd = main["forward_launches"]["stencil_pcg"]
        k1 = {"forward": _k1_summary(log[:n_fwd]), "adjoint": _k1_summary(log[n_fwd:])}
    finally:
        restore()
    theta = torch.tensor(1.0, device=device, requires_grad=True)
    warm = _grad_pass(loss, theta)  # the first pass paid one-time costs
    with torch.no_grad():
        holder[0] = torch.tensor(1.0, device=device)
        u_step = step(centers)
        u_solve = hmm.solve().array
    fd = _central_difference(loss, 1.0, GRAD_FD_H, device, torch.float32)
    rec = {"phase": "pipeline_grad", "macro_n": macro_n, "micro_n": micro_n,
           "cells": int(centers.shape[0]), "dofs": hmm.function_space.num_dofs,
           "macro_method": hmm._macro_method, **main, "k1": k1,
           "warm": {k: warm[k] for k in ("forward_seconds", "backward_seconds", "peak_bytes",
                                         "derivative")},
           "u_rel_diff_to_solve": rel_diff(u_step, u_solve),
           "u_bitwise_equal_to_solve": bool(torch.equal(u_step, u_solve)),
           "fd_h": GRAD_FD_H, "fd": fd, "rel_err_fd": _rel(main["derivative"], fd)}
    del hmm, step, centers, loss, u_step, u_solve
    torch.cuda.empty_cache()
    # the float32 gradient on the card against the CPU's float64 one
    card, _, _ = _poisson_grad(device, torch.float32, check_n, micro_n)
    cpu, _, _ = _poisson_grad("cpu", torch.float64, check_n, micro_n)
    rec["check"] = {"macro_n": check_n, "card": card, "cpu_f64": cpu,
                    "rel_err": _rel(card["derivative"], cpu["derivative"])}
    card, _, _ = _poisson_grad(device, torch.float32, d2_n, d2_n, order=2)
    cpu, _, _ = _poisson_grad("cpu", torch.float64, d2_n, d2_n, order=2)
    rec["second"] = {"macro_n": d2_n, "micro_n": d2_n, "card": card, "cpu_f64": cpu,
                     "rel_err": _rel(card["derivative"], cpu["derivative"])}
    emit(rec)
    bwd = main["backward_launches"]
    if not (math.isfinite(main["derivative"]) and rec["u_rel_diff_to_solve"] <= PIPELINE_U_RTOL
            and rec["rel_err_fd"] <= GRAD_FD_RTOL and rec["check"]["rel_err"] <= GRAD_F64_RTOL
            and rec["second"]["rel_err"] <= GRAD2_F64_RTOL
            and bwd["stencil_pcg"] >= 1 and bwd["dia_spmv"] >= 1
            and rec["second"]["card"]["backward_launches"]["stencil_pcg"] >= 1
            and len(main["macro_iterations"]) == 2):
        raise AssertionError(f"pipeline gradient failed its checks: {rec}")
    return {"stencil_pcg": stencil_pcg.KERNEL.launches, "dia_spmv": dia.KERNEL.launches}


def _beam_grad(device, dtype, macro_n, micro_n: int = 4):
    """dJ/dθ of J = Σu² through the rotated-fibre beam's pipeline (a
    ``micro_n``³ micro cube), θ scaling the fibre modulus (μ = 100θ in the
    fibre), at θ = 1."""
    import torch

    from hommx_tpu_torch import LinearElasticityStratifiedHMM, create_box, create_unit_cube
    from hommx_tpu_torch.examples._common import circle_indicator
    from hommx_tpu_torch.utils.validation import hooke_tensor

    holder = [1.0]

    def mu(x, y):
        one = torch.ones((), dtype=y.dtype, device=y.device)
        return torch.where(circle_indicator(y[1], y[2]), 100.0 * holder[0] * one, 0.001 * one)

    macro = create_box([[0, 0, 0], [BEAM_L, BEAM_W, BEAM_H]], list(macro_n))
    f = torch.tensor([0.0, 0.0, -0.05 * (BEAM_W / BEAM_L) ** 2], dtype=torch.float64)
    hmm = LinearElasticityStratifiedHMM(macro, hooke_tensor(3, mu, lambda x, y: 1.0),
                                        lambda x: f, create_unit_cube(micro_n), 2**-5,
                                        beam_rotation, dtype=dtype, device=device,
                                        dedup_cells=False)
    clamp_x0(hmm)
    step, centers = hmm.build_pipeline()

    def loss(th):
        holder[0] = th
        return (step(centers).double() ** 2).sum()

    theta = torch.tensor(1.0, dtype=dtype, device=device, requires_grad=True)
    rec = _grad_pass(loss, theta)
    rec.update({"cells": int(centers.shape[0]), "dofs": hmm.function_space.num_dofs,
                "macro_method": hmm._macro_method})
    return rec


def phase_pipeline_grad_elasticity(device, macro_n=(20, 6, 6)):
    """dJ/dθ through the rotated-fibre beam's pipeline (20x6x6: 4320 cells,
    3087 dofs, the float64 direct macro solve; θ scales the fibre modulus)
    in float32 through K3, forward and adjoint launches counted, against
    the CPU's float64 gradient of the same pipeline."""
    import torch

    from hommx_tpu_torch.ops import chol_kernel

    chol_kernel.KERNEL.reset_counts()
    card = _beam_grad(device, torch.float32, macro_n)
    cpu = _beam_grad("cpu", torch.float64, macro_n)
    rec = {"phase": "pipeline_grad_elasticity", "macro_n": list(macro_n), "card": card,
           "cpu_f64": cpu, "rel_err": _rel(card["derivative"], cpu["derivative"]),
           "bar": BEAM_GRAD_RTOL}
    emit(rec)
    if not (math.isfinite(card["derivative"]) and rec["rel_err"] <= BEAM_GRAD_RTOL
            and card["backward_launches"]["chol_solve"] >= 1):
        raise AssertionError(f"beam gradient failed its checks: {rec}")
    return {"chol_solve": chol_kernel.KERNEL.launches}


def _fem_grad(device, dtype, n):
    """dJ/dθ of J = Σu² through fem_solve_fn on examples/hmm.py's reference
    (5x5 rectangle, n², A = 1.1 + θx₀ + sin(2πx₀/ε), f = 0, Darcy BCs,
    default options), at θ = 1; (record, loss)."""
    import torch

    from hommx_tpu_torch import create_rectangle, fem_solve_fn
    from hommx_tpu_torch.examples._common import darcy_bcs
    from hommx_tpu_torch.ops.function_space import FunctionSpace

    eps = 2**-5

    def coeff(th, x):
        return 1.1 + th * x[0] + torch.sin(2 * torch.pi * x[0] / eps)

    t0 = time.perf_counter()
    V = FunctionSpace(create_rectangle([[0, 0], [5, 5]], [n, n]), 1)
    solve = fem_solve_fn(V, coeff, 0.0, darcy_bcs(V), dtype=dtype, device=device)
    t_setup = time.perf_counter() - t0

    def loss(th):
        return (solve(th).double() ** 2).sum()

    theta = torch.tensor(1.0, dtype=dtype, device=device, requires_grad=True)
    rec = {"n": n, "dofs": V.num_dofs, "setup_seconds": t_setup, **_grad_pass(loss, theta),
           "macro_iterations": list(solve.macro_solve.iterations)}
    return rec, loss


def phase_fem_grad(device, n: int = 1024, check_n: int = 64):
    """dJ/dθ through fem_solve_fn at fem_flagship's n² (1,050,625 dofs at
    1024², float32 multigrid CG through K2 forward and adjoint) against a
    central difference of the float32 forward; at check_n² against the
    CPU's float64 gradient."""
    import torch

    from hommx_tpu_torch.ops import dia

    dia.KERNEL.reset_counts()
    main, loss = _fem_grad(device, torch.float32, n)
    fd = _central_difference(loss, 1.0, GRAD_FD_H, device, torch.float32)
    del loss
    card, _ = _fem_grad(device, torch.float32, check_n)
    cpu, _ = _fem_grad("cpu", torch.float64, check_n)
    rec = {"phase": "fem_grad", **main, "fd_h": GRAD_FD_H, "fd": fd,
           "rel_err_fd": _rel(main["derivative"], fd),
           "check": {"n": check_n, "card": card, "cpu_f64": cpu,
                     "rel_err": _rel(card["derivative"], cpu["derivative"])}}
    emit(rec)
    if not (math.isfinite(main["derivative"]) and rec["rel_err_fd"] <= GRAD_FD_RTOL
            and rec["check"]["rel_err"] <= GRAD_F64_RTOL
            and main["backward_launches"]["dia_spmv"] >= 1
            and len(main["macro_iterations"]) == 2):
        raise AssertionError(f"FEM gradient failed its checks: {rec}")
    return {"dia_spmv": dia.KERNEL.launches}


def _guard_counts(eng, coeff, centers, A, G_fn=None) -> tuple:
    """(diverged, fallback) cell counts of A* against the zero-corrector
    tensors, by the models' guard (BaseHMM._guard): diag(A*) above 1.05
    times the zero corrector's diverged; at the zero corrector (ratio >
    0.999) where the median ratio is below 0.95, the PCG's clamp (a
    heuristic: a cell whose corrector is legitimately small in one
    direction is flagged too)."""
    import torch

    A0, _ = eng.nocorrector_tensors(coeff, centers, G_fn=G_fn)
    d_star = torch.diagonal(A, dim1=1, dim2=2).double()
    d_zero = torch.diagonal(A0, dim1=1, dim2=2).double()
    ratio = d_star / d_zero.clamp(min=1e-300)
    med = torch.quantile(ratio, 0.5, dim=0)
    fallback = ((ratio > 0.999) & (med[None, :] < 0.95)).any(dim=1)
    diverged = (d_star > 1.05 * d_zero + 1e-9).any(dim=1)
    return int(diverged.sum()), int(fallback.sum())


def _reps_record(times) -> dict:
    """Median, trimmed median (the fastest and slowest reps dropped) and
    spread of per-rep seconds, as bench.py reports them."""
    med = statistics.median(times)
    trimmed = statistics.median(sorted(times)[1:-1]) if len(times) > 2 else med
    return {"reps_seconds": times, "median_seconds": med, "trimmed_median_seconds": trimmed,
            "spread_pct": 100.0 * (max(times) - min(times)) / med}


def phase_micro_highres(device, reps: int = 5):
    """16³ elasticity cells by the torus-multigrid route (bench.py's
    micro_elasticity_16cubed_mg row): the rotated stiff fibre, float32,
    solver='pcg', pcg_strategy='matfree', cell_prec='mg', default ν and
    tolerance.  (a) 8 fresh cells at chunk 8, then 128 at the auto chunk,
    ``reps`` reps each with fresh centres: seconds, cell solves/s (cells ×
    6 / s), lockstep iterations, fallback cells, peak memory; (b) the same
    8 cells in float64 on the card (pcg_tol 1e-9), the float32 A* within
    2e-3 of it; (c) the reference's 16³ gate (ν = 10, tol 1e-7, float64, 2
    cells): at most 100 iterations, diag(A*) physical; (d) the example's
    micro-mesh sequence on its own routes (one centre), through
    ``hommx_tpu_torch.examples.linear_elasticity.high_res_micro.run``: 4³
    and 8³ on the default one, float32 through K3's small and large
    instance (one launch each, A* within 1e-4 of the float64 plain route),
    16³ on the MG route (float64, ν = 8, tol 1e-7)."""
    import numpy as np
    import torch

    from hommx_tpu_torch import MicroEngine, create_unit_cube
    from hommx_tpu_torch.ops import chol_kernel

    kw = dict(bs=3, coeff_kind="tensor4", solver="pcg", pcg_strategy="matfree",
              cell_prec="mg", device=device)
    coeff = beam_coeff(True)
    t0 = time.perf_counter()
    eng = MicroEngine(create_unit_cube(16), dtype=torch.float32, **kw)
    setup = time.perf_counter() - t0
    rng = np.random.default_rng(16)
    rec = {"phase": "micro_highres", "n_reduced": eng.n_reduced, "s": eng.s,
           "engine_setup_seconds": setup, "mg_nu": 4, "pcg_tol": eng.pcg_tol}

    def run(cells, chunk):
        times, sums, first = [], [], None
        torch.cuda.reset_peak_memory_stats()
        for _ in range(reps):
            c = torch.as_tensor(rng.uniform(0, 1, (cells, 3)), dtype=torch.float32,
                                device=device)
            torch.cuda.synchronize()
            t = time.perf_counter()
            with torch.no_grad():
                A = eng.tensors_for_centers(coeff, c, G_fn=beam_rotation, chunk=chunk)
            sums.append(float(A.double().sum()))
            times.append(time.perf_counter() - t)
            first = (c, A) if first is None else first
        out = _reps_record(times)
        out.update(cells=cells, chunk=chunk or eng._auto_chunk(cells),
                   solves_per_second=cells * eng.s / out["median_seconds"],
                   checksums_differ=len(set(sums)) == reps,
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        # lockstep iterations per chunk and the cells whose energy clamp
        # took the zero corrector (a column of X exactly 0), from one
        # untimed pass through the same chunk route on the first rep's
        # cells; the models' guard (a heuristic) beside them
        c, A = first
        its = _chunk_iters(eng, coeff, c, beam_rotation, out["chunk"])
        out["iterations"], out["fallback_cells"] = (its["iterations_per_chunk"],
                                                    its["zero_corrector_cells"])
        with torch.no_grad():
            out["diverged_cells"], out["guard_fallback_flags"] = _guard_counts(
                eng, coeff, c, A, G_fn=beam_rotation)
        out["finite"] = bool(torch.isfinite(A).all())
        return out, first

    rec["c8"], (c8, A8) = run(8, 8)
    rec["c128"], _ = run(128, 0)
    emit(rec)
    # (b) the same 8 cells in float64 on the card
    eng64 = MicroEngine(create_unit_cube(16), dtype=torch.float64, pcg_tol=1e-9, **kw)
    with torch.no_grad():
        A64, it64 = eng64.tensors_chunk_pcg(coeff, c8.double(), G_fn=beam_rotation,
                                            with_iters=True, implicit_diff=False)
    rec_b = {"phase": "micro_highres_f64", "iterations": int(it64),
             "f32_rel_diff_to_f64": rel_diff(A8, A64)}
    emit(rec_b)
    # (c) the reference's slow gate
    fibre_only = beam_coeff(False)
    eng_g = MicroEngine(create_unit_cube(16), dtype=torch.float64, mg_nu=10, pcg_tol=1e-7,
                        pcg_maxiter=2000, **kw)
    cg = torch.as_tensor(np.random.default_rng(0).uniform(0, 1, (2, 3)), dtype=torch.float64,
                         device=device)
    t = time.perf_counter()
    with torch.no_grad():
        Ag, itg = eng_g.tensors_chunk_pcg(fibre_only, cg, with_iters=True, implicit_diff=False)
    dg = Ag[0].diagonal().cpu()
    rec_c = {"phase": "micro_highres_gate", "iterations": int(itg),
             "seconds": time.perf_counter() - t, "diag": dg.tolist(),
             "finite": bool(torch.isfinite(Ag).all())}
    emit(rec_c)
    # (d) the example's micro-mesh sequence on its own routes, through the
    # port's script: 4³ and 8³ on the default one (on the card float32, the
    # chunk Cholesky: K3's small and then its large instance, one launch
    # each), 16³ on the MG route (ν = 8, tol 1e-7, in float64: the float32
    # route stalls short of that tolerance); the Cholesky cells also
    # against the float64 plain route
    from hommx_tpu_torch.examples.linear_elasticity import high_res_micro

    small, large = "hommx_chol_solve_f32", "hommx_chol_solve_large_f32"
    chol_kernel.KERNEL.reset_counts()
    seq = high_res_micro.run(device=device)["rows"]
    torch.cuda.synchronize()
    centre = torch.full((1, 3), 0.5, dtype=torch.float64, device=device)
    for row in seq:
        A = torch.tensor(row.pop("A"), dtype=torch.float64)
        row["finite"] = bool(torch.isfinite(A).all())
        if row["n"] <= 8:
            A64 = _f64_astar(create_unit_cube(row["n"]), high_res_micro.A_el, centre, bs=3,
                             coeff_kind="tensor4")[0]
            row["f64_rel_diff"] = rel_diff(A, A64.cpu())
    counts = {"k3_launches": chol_kernel.KERNEL.counts[small],
              "k3_large_launches": chol_kernel.KERNEL.counts[large]}
    emit({"phase": "micro_highres_sequence", "rows": seq, **counts,
          "bar": K3_LARGE_ASTAR_RTOL})
    seq_ok = (counts == {"k3_launches": 1, "k3_large_launches": 1}
              and [r["dtype"] for r in seq] == ["torch.float32"] * 2 + ["torch.float64"]
              and all(r["finite"] for r in seq)
              and all(r["f64_rel_diff"] <= K3_LARGE_ASTAR_RTOL for r in seq[:2]))
    ok = (rec["c8"]["finite"] and rec["c128"]["finite"] and rec["c8"]["checksums_differ"]
          and rec["c128"]["checksums_differ"] and rec["c8"]["fallback_cells"] == 0
          and rec["c8"]["diverged_cells"] == 0 and rec["c128"]["fallback_cells"] == 0
          and rec_b["f32_rel_diff_to_f64"] <= GOLDEN_ELASTICITY_RTOL
          and rec_c["finite"] and rec_c["iterations"] <= 100
          and dg[0] > 1.0 and dg[1] < 1.0 and bool((dg > 0).all()) and seq_ok)
    if not ok:
        raise AssertionError(f"16³ multigrid route or the micro sequence failed its checks: "
                             f"{rec} {rec_b} {rec_c} {seq}")
    return {"chol_solve": chol_kernel.KERNEL.counts[small],
            "chol_solve_large": chol_kernel.KERNEL.counts[large]}


def phase_micro_routes(device):
    """Each micro route this slice added, float32 on the card against the
    same engine in float64 on the card (bars: 1e-4 scalar, 2e-3
    elasticity): matrix coefficients and scalar solver='cholesky' (the
    per-cell route), the vector per-cell densek PCG at 4³, the matrix-free
    gather (HOMMX_MICRO_MATVEC=matfree), the MG route at 4³ elasticity
    (also against the K3 route at 4³), and the scalar MG route on a 64²
    micro mesh (n = 4096) over 256 fresh cells, timed, and on a
    contrast-100 inclusion beside the plain K0⁻¹ route.  Then K1's limit:
    a 64² k0inv float32 engine (n = 4096) is built, a 65² one raises
    naming B7."""
    import numpy as np
    import torch

    from hommx_tpu_torch import MicroEngine, create_unit_cube, create_unit_square
    from hommx_tpu_torch.micro.chunk import tensors_chunk_plain
    from hommx_tpu_torch.ops import chol_kernel
    from hommx_tpu_torch.utils.validation import hooke_tensor

    def scalar(x, y):
        return 1.1 + x[0] + torch.sin(2 * torch.pi * y[0]) * torch.cos(2 * torch.pi * y[1])

    def matrix(x, y):
        a = 2.0 + torch.sin(2 * torch.pi * y[0])
        b = 0.3 * x[0] * torch.ones_like(a)
        return torch.stack([torch.stack([a, b]), torch.stack([b, 1.5 + 0.5 * torch.cos(
            2 * torch.pi * y[1])])])

    def inclusion(x, y):
        inside = (torch.abs(y[0] - 0.5) < 0.25) & (torch.abs(y[1] - 0.5) < 0.25)
        one = torch.ones((), dtype=y.dtype, device=y.device)
        return torch.where(inside, 100.0 * (1.0 + x[0]) * one, one)

    lame = hooke_tensor(3, lambda x, y: 1.0 + 0.5 * torch.sin(2 * torch.pi * y[0]),
                        lambda x, y: 1.0)
    rng = np.random.default_rng(7)
    cases = [
        ("matrix_percell", create_unit_square(8), matrix, dict(coeff_kind="matrix"), 256, 1e-4),
        ("scalar_cholesky", create_unit_square(8), scalar, dict(solver="cholesky"), 256, 1e-4),
        ("vector_densek_pcg", create_unit_cube(4), lame,
         dict(bs=3, coeff_kind="tensor4", solver="pcg"), 64, 2e-3),
        ("matfree_gather", create_unit_square(16), scalar, dict(solver="pcg"), 256, 1e-4),
        ("mg_elasticity_4", create_unit_cube(4), beam_coeff(True),
         dict(bs=3, coeff_kind="tensor4", solver="pcg", pcg_strategy="matfree",
              cell_prec="mg"), 64, 2e-3),
        ("mg_scalar_64", create_unit_square(64), scalar,
         dict(solver="pcg", cell_prec="mg"), 256, 1e-4),
    ]
    out, k3 = [], 0
    saved = os.environ.get("HOMMX_MICRO_MATVEC")
    try:
        for name, mesh, coeff, kw, cells, bar in cases:
            if name == "matfree_gather":
                os.environ["HOMMX_MICRO_MATVEC"] = "matfree"
            e32 = MicroEngine(mesh, dtype=torch.float32, device=device, **kw)
            e64 = MicroEngine(mesh, dtype=torch.float64, device=device, **kw)
            c = torch.as_tensor(rng.uniform(0, 1, (cells, mesh.dim)), device=device)
            torch.cuda.synchronize()
            t = time.perf_counter()
            with torch.no_grad():
                A32 = e32.tensors_for_centers(coeff, c.float())
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
            with torch.no_grad():
                A64 = e64.tensors_for_centers(coeff, c)
            r = {"case": name, "cells": cells, "n_reduced": e32.n_reduced, "bar": bar,
                 "f32_seconds": secs, "f32_rel_diff_to_f64": rel_diff(A32, A64),
                 "k1_route": e32._k1_route(), "finite": bool(torch.isfinite(A32).all())}
            if name == "mg_elasticity_4":
                e_k3 = MicroEngine(mesh, bs=3, coeff_kind="tensor4", dtype=torch.float32,
                                   device=device)
                before = chol_kernel.KERNEL.launches
                with torch.no_grad():
                    A_k3 = e_k3.tensors_for_centers(coeff, c.float())
                k3 += chol_kernel.KERNEL.launches - before
                r["rel_diff_to_k3_route"] = rel_diff(A32, A_k3)
            if name == "matfree_gather":
                os.environ.pop("HOMMX_MICRO_MATVEC")
                r["stencil"] = e32._get_stencil() is not None
            if name == "mg_scalar_64":
                # a contrast-100 inclusion: the float32 A* of the MG route
                # against float64, beside the plain K0⁻¹ route's on the same
                # 32 cells (the bilinear A*'s float32 cancellation, not the
                # preconditioner, sets the distance there)
                ci = c[:32]
                with torch.no_grad():
                    A64i = e64.tensors_for_centers(inclusion, ci)
                    r["contrast100_mg_rel_diff"] = rel_diff(
                        e32.tensors_for_centers(inclusion, ci.float()), A64i)
                    r["contrast100_k0inv_rel_diff"] = rel_diff(
                        tensors_chunk_plain(e32, inclusion, ci.float()), A64i)
            out.append(r)
    finally:
        if saved is None:
            os.environ.pop("HOMMX_MICRO_MATVEC", None)
        else:
            os.environ["HOMMX_MICRO_MATVEC"] = saved
    fits = MicroEngine(create_unit_square(64), dtype=torch.float32, device=device)._k1_route()
    try:
        MicroEngine(create_unit_square(65), dtype=torch.float32, device=device)
        b7 = "did not raise"
    except NotImplementedError as err:
        b7 = str(err)
    emit({"phase": "micro_routes", "cases": out, "k1_route_64x64": fits,
          "k1_limit_65x65": b7[:160]})
    ok = all(r["finite"] and r["f32_rel_diff_to_f64"] <= r["bar"] and not r["k1_route"]
             for r in out)
    ok = ok and out[4]["rel_diff_to_k3_route"] <= GOLDEN_ELASTICITY_RTOL
    ok = ok and not out[3]["stencil"] and fits and "B7" in b7 and k3 >= 1
    ok = ok and (out[5]["contrast100_mg_rel_diff"]
                 <= 2.0 * out[5]["contrast100_k0inv_rel_diff"] + 1e-6)
    if not ok:
        raise AssertionError(f"micro routes failed their checks: {out} {b7}")
    return {"chol_solve": k3}


def _chunk_iters(eng, coeff, centers, G_fn=None, chunk: int = 0) -> dict:
    """Lockstep PCG iterations per chunk and the cells whose energy clamp
    took the zero corrector (a column of X exactly 0), from one untimed
    pass through the chunk route over ``centers``."""
    import torch

    n = centers.shape[0]
    chunk = chunk or eng._auto_chunk(n)
    its, fallback = [], 0
    with torch.no_grad():
        for i in range(0, n, chunk):
            _, X, it = eng.tensors_chunk_pcg(coeff, centers[i:i + chunk], G_fn=G_fn,
                                             with_correctors=True, with_iters=True,
                                             implicit_diff=False)
            its.append(int(it))
            fallback += int((X.abs().amax(dim=1) == 0).any(dim=1).sum())
    return {"chunk": chunk, "iterations_per_chunk": its, "zero_corrector_cells": fallback}


def _f64_astar(mesh, coeff, centers, G_fn=None, **kw):
    """A* of ``centers`` by the float64 Cholesky route on the card (the
    per-cell route of a scalar problem, the plain chunk Cholesky of a
    vector one)."""
    import torch

    from hommx_tpu_torch import MicroEngine
    from hommx_tpu_torch.micro.chunk import tensors_chunk_chol_plain
    from hommx_tpu_torch.micro.krylov import _map_chunked

    eng = MicroEngine(mesh, dtype=torch.float64, device=centers.device, **kw)
    c64 = centers.double()
    with torch.no_grad():
        if eng._chol_route():
            return _map_chunked(lambda c: tensors_chunk_chol_plain(eng, coeff, c, G_fn), c64,
                                1080)
        return eng.tensors_for_centers(coeff, c64, G_fn=G_fn)


def _hmm_record(phase, hmm, t_setup) -> tuple:
    """``_solve_record`` with the engine's route (n, effective elements,
    cell preconditioner, element degree) and K1's and K3's launches in the
    solve."""
    from hommx_tpu_torch.micro import stencil_pcg
    from hommx_tpu_torch.ops import chol_kernel

    kernels = {"k1_launches": stencil_pcg.KERNEL, "chol_solve_launches": chol_kernel.KERNEL}
    before = {key: k.launches for key, k in kernels.items()}
    rec, u = _solve_record(phase, hmm, t_setup)
    eng = hmm._engine
    rec.update({key: k.launches - before[key] for key, k in kernels.items()})
    rec.update({"n_reduced": eng.n_reduced, "effective_elements": eng.nE,
                "cell_prec": eng.cell_prec, "micro_degree": eng.micro_degree})
    return rec, u


def phase_micro_fft(device, checked: int = 4096, suite_n: int = 48, flagship_n: int = 512,
                    stiff_n: int = 8):
    """The FFT-symbol cell preconditioner (cell_prec='fft'; cuFFT through
    torch.fft, no kernel of this repository, K1 kept off), float32:
    (a) benchmarks/suite.py's configuration — PoissonStratifiedHMM, 48²
    macro, 24² micro, the wavy laminate (contrast 100) and its map, dedup
    off — lockstep iterations per chunk, fallback cells, K1 launches (0),
    micro and macro seconds, beside the same solve on K1's route; A* of
    every cell against the float64 Cholesky route, u against the float64
    solve of its system; (b) the 512² flagship (16² micro, chunk 2048,
    multigrid CG through K2): A* of ``checked`` cells and u against
    float64, its micro stage beside K1's; (c) the block symbol on the
    20x6x6 beam's 4320 centres and map (4³ cube, μ = 1 + ½ sin 2πy₀, λ = 1)
    with the dense-K and the block-stencil matvec, against each other and
    the K3 route's float64 A*; (d) the contrast-1e5 stiff-fibre cells at
    8³ in float64, tol 1e-9 (benchmarks/mg_iteration_sweep.py): iterations,
    fallback cells, A* of the converged cells against Cholesky."""
    import numpy as np
    import torch

    from hommx_tpu_torch import (MicroEngine, PoissonHMM, PoissonStratifiedHMM, SolverOptions,
                                 create_box, create_unit_cube, create_unit_square)
    from hommx_tpu_torch.examples.diffusion import laminate
    from hommx_tpu_torch.micro import stencil_pcg
    from hommx_tpu_torch.micro.chunk import tensors_chunk_chol_plain
    from hommx_tpu_torch.ops import dia
    from hommx_tpu_torch.utils.validation import hooke_tensor

    out = {}
    # (a) the reference's own FFT configuration, then K1's route
    micro24 = create_unit_square(24, 24)
    runs = {}
    for route, kw in (("fft", {"engine_kwargs": {"cell_prec": "fft"}}), ("k1", {})):
        t0 = time.perf_counter()
        hmm = PoissonStratifiedHMM(create_unit_square(suite_n, suite_n), laminate.A,
                                   lambda x: 1.0,
                                   micro24, 2**-4, laminate.Dtheta, dtype=torch.float32,
                                   device=device, dedup_cells=False, **kw)
        rec, u = _hmm_record(f"micro_fft_suite_{route}", hmm, time.perf_counter() - t0)
        runs[route] = (hmm, u, rec)
    hmm, u, rec = runs["fft"]
    centers = hmm._sys.centers
    rec.update(_chunk_iters(hmm._engine, laminate.A, centers, laminate.Dtheta,
                            hmm._chunk or 0))
    rec["k1_route_block_iters"] = _k1_block_iters(runs["k1"][0])
    A64 = _f64_astar(micro24, laminate.A, centers, laminate.Dtheta)
    rec["astar_rel_diff_f64"] = rel_diff(hmm.homogenized_tensors(), A64)
    rec["k1_route_astar_rel_diff_f64"] = rel_diff(runs["k1"][0].homogenized_tensors(), A64)
    rec["u_rel_diff_f64"] = rel_diff(u, _own_system_f64(hmm))
    rec["u_rel_diff_f64_assembly"] = rel_diff(u, _f64_solution(hmm))
    rec["k1_route_micro_seconds"] = runs["k1"][2]["micro_seconds"]
    emit(rec)
    out["a"] = rec
    # (b) the flagship on the FFT route, and on K1's beside it
    micro16 = create_unit_square(16, 16)
    opts = SolverOptions(rtol=1e-5, maxiter=20000)
    flag = {}
    for route, kw in (("fft", {"engine_kwargs": {"cell_prec": "fft"}}), ("k1", {})):
        t0 = time.perf_counter()
        hmm = PoissonHMM(create_unit_square(flagship_n, flagship_n), flagship, 1.0, micro16,
                         2**-5, opts, dtype=torch.float32, device=device, chunk=2048,
                         dedup_cells=False, **kw)
        flag[route] = _hmm_record(f"micro_fft_flagship_{route}", hmm,
                                  time.perf_counter() - t0) + (hmm,)
    rec, u, hmm = flag["fft"]
    idx = torch.linspace(0, rec["num_cells"] - 1, checked, device=device).round().long()
    A64 = _f64_astar(micro16, flagship, hmm._sys.centers[idx])
    rec.update({"checked_cells": checked,
                "astar_rel_diff_f64": rel_diff(hmm.homogenized_tensors()[idx], A64),
                "u_rel_diff_f64": rel_diff(u, _own_system_f64(hmm)),
                "u_rel_diff_f64_assembly": rel_diff(u, _f64_solution(hmm)),
                "k1_route_micro_seconds": flag["k1"][0]["micro_seconds"],
                "k1_route_macro_seconds": flag["k1"][0]["macro_seconds"]})
    emit(rec)
    out["b"] = rec
    k2_main = out["b"]["dia_spmv_launches"]
    # (c) the block symbol on the beam's cells, two matvecs
    macro = create_box([[0, 0, 0], [BEAM_L, BEAM_W, BEAM_H]], [20, 6, 6])
    bc = torch.as_tensor(macro.vertices[macro.cells].mean(axis=1), device=device)
    lame = hooke_tensor(3, lambda x, y: 1.0 + 0.5 * torch.sin(2 * torch.pi * y[0]),
                        lambda x, y: 1.0)
    cube4 = create_unit_cube(4)
    A_st, rec = {}, {"phase": "micro_fft_block", "cells": bc.shape[0]}
    for strategy in ("densek", "matfree"):
        eng = MicroEngine(cube4, bs=3, coeff_kind="tensor4", dtype=torch.float32, device=device,
                          solver="pcg", pcg_strategy=strategy, cell_prec="fft")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            A_st[strategy] = eng.tensors_for_centers(lame, bc.float(), G_fn=beam_rotation)
        torch.cuda.synchronize()
        rec[f"{strategy}_seconds"] = time.perf_counter() - t0
        rec[f"{strategy}_iterations"] = _chunk_iters(eng, lame, bc.float(),
                                                     beam_rotation)["iterations_per_chunk"]
    A64 = _f64_astar(cube4, lame, bc, beam_rotation, bs=3, coeff_kind="tensor4")
    rec.update({"densek_rel_diff_k3_route_f64": rel_diff(A_st["densek"], A64),
                "matfree_rel_diff_k3_route_f64": rel_diff(A_st["matfree"], A64),
                "densek_vs_matfree": rel_diff(A_st["matfree"], A_st["densek"]),
                "finite": bool(torch.isfinite(A_st["densek"]).all()
                               and torch.isfinite(A_st["matfree"]).all())})
    emit(rec)
    out["c"] = rec
    # (d) the contrast-1e5 stiff-fibre cells, float64
    rng = np.random.default_rng(0)
    rng.uniform(0, 1, (4, 2))  # the sweep draws its scalar centres first
    c3 = torch.as_tensor(rng.uniform(0, 1, (2, 3)), device=device)
    stiff = beam_coeff(False)
    cube8 = create_unit_cube(stiff_n)
    eng = MicroEngine(cube8, bs=3, coeff_kind="tensor4", dtype=torch.float64, device=device,
                      solver="pcg", pcg_strategy="matfree", cell_prec="fft", pcg_tol=1e-9,
                      pcg_maxiter=6000)
    t0 = time.perf_counter()
    with torch.no_grad():
        A, X, it = eng.tensors_chunk_pcg(stiff, c3, with_correctors=True, with_iters=True,
                                         implicit_diff=False)
    secs = time.perf_counter() - t0
    good = ~(X.abs().amax(dim=1) == 0).any(dim=1)
    A_ch = _f64_astar(cube8, stiff, c3, bs=3, coeff_kind="tensor4")
    rec = {"phase": "micro_fft_stiff", "n_reduced": eng.n_reduced, "iterations": int(it),
           "seconds": secs, "fallback_cells": int((~good).sum()),
           "converged_rel_diff_cholesky": rel_diff(A[good], A_ch[good]) if good.any() else None}
    emit(rec)
    out["d"] = rec
    a, b, c, d = out["a"], out["b"], out["c"], out["d"]
    astar_ok = a["astar_rel_diff_f64"] <= FFT_ASTAR_RTOL or (
        a["k1_route_astar_rel_diff_f64"] > FFT_ASTAR_RTOL
        and a["astar_rel_diff_f64"] <= 2.0 * a["k1_route_astar_rel_diff_f64"])
    ok = (astar_ok and all(r["finite"] and r["k1_launches"] == 0 and r["fallback_cells"] == 0
                           and r["diverged_cells"] == 0 and r["nan_cells"] == 0
                           for r in (a, b))
          and a["zero_corrector_cells"] == 0 and a["u_rel_diff_f64"] <= FFT_U_RTOL
          and b["astar_rel_diff_f64"] <= FFT_ASTAR_RTOL and b["u_rel_diff_f64"] <= FFT_U_RTOL
          and b["macro_method"] == "cg" and k2_main >= 1 and c["finite"]
          and c["densek_rel_diff_k3_route_f64"] <= FFT_ASTAR_RTOL
          and c["matfree_rel_diff_k3_route_f64"] <= FFT_ASTAR_RTOL
          and c["densek_vs_matfree"] <= FFT_STRATEGY_RTOL
          and (d["converged_rel_diff_cholesky"] is None
               or d["converged_rel_diff_cholesky"] <= FFT_STIFF_RTOL))
    if not ok:
        raise AssertionError(f"FFT cell preconditioner failed its checks: {out}")
    return {"dia_spmv": k2_main}


def phase_p2(device, checked: int = 4096, cells: int = 8640, chunk: int = 1080,
             flagship_n: int = 512, fem_ns=(8, 16, 31), cg_n: int = 256):
    """P2 elements, float32: (a) the 512² flagship with P2 cell problems on
    an 8² micro square (n = 256, the chunk PCG's matrix-free gather with
    K0⁻¹, no K1; multigrid CG through K2): A* of ``checked`` cells and u
    against float64, A* beside the P1 16² cells'; (b) the 20x6x6 beam with
    P2 cells on the 2³ cube (n = 192, s = 6) through K3: A* and u against
    float64; then the 8640-cell bench-size stage on the P2 2³ and the P1 4³
    cube in turns; (c) PoissonFEM(degree=2) on −Δu = 2π² sin πx sin πy
    (Dirichlet data from Function.interpolate on the card): L2 errors and
    rates at 8², 16², 31² (direct), and the 256² system (263,169 dofs) by
    the Jacobi CG against its float64 solve (with pc='auto' it takes
    aggregation AMG: phase amg, case (c))."""
    import numpy as np
    import torch

    from hommx_tpu_torch import (Function, FunctionSpace, MicroEngine, PoissonFEM, PoissonHMM,
                                 SolverOptions, create_unit_cube, create_unit_square,
                                 dirichletbc)
    from hommx_tpu_torch.micro import stencil_pcg
    from hommx_tpu_torch.models.common import assemble_macro_system, merge_bcs
    from hommx_tpu_torch.models.fem import fem_system
    from hommx_tpu_torch.ops import chol_kernel, dia, solvers
    from hommx_tpu_torch.ops.function_space import boundary_dofs
    from hommx_tpu_torch.utils.validation import l2_norm_space

    out = {}
    # (a) the flagship with P2 cells
    micro8 = create_unit_square(8, 8)
    t0 = time.perf_counter()
    hmm = PoissonHMM(create_unit_square(flagship_n, flagship_n), flagship, 1.0, micro8, 2**-5,
                     SolverOptions(rtol=1e-5, maxiter=20000), dtype=torch.float32,
                     device=device, chunk=2048, dedup_cells=False,
                     engine_kwargs={"micro_degree": 2})
    rec, u = _hmm_record("p2_flagship", hmm, time.perf_counter() - t0)
    k2_main = rec["dia_spmv_launches"]
    idx = torch.linspace(0, rec["num_cells"] - 1, checked, device=device).round().long()
    c = hmm._sys.centers[idx]
    A64 = _f64_astar(micro8, flagship, c, micro_degree=2)
    A_p1 = _f64_astar(create_unit_square(16, 16), flagship, c)
    rec.update({"checked_cells": checked, "k1_route": hmm._engine._k1_route(),
                "stencil": hmm._engine._get_stencil() is not None,
                "astar_rel_diff_f64": rel_diff(hmm.homogenized_tensors()[idx], A64),
                "u_rel_diff_f64": rel_diff(u, _own_system_f64(hmm)),
                "u_rel_diff_f64_assembly": rel_diff(u, _f64_solution(hmm)),
                "p1_16_rel_diff_f64": rel_diff(A_p1, A64),
                "astar_mean_p2_8": A64.mean(dim=0).tolist(),
                "astar_mean_p1_16": A_p1.mean(dim=0).tolist()})
    emit(rec)
    out["a"] = rec
    # (b) the beam with P2 cells through K3
    t0 = time.perf_counter()
    beam = make_beam(device, micro_n=2, engine_kwargs={"micro_degree": 2})
    rec, u = _hmm_record("p2_beam", beam, time.perf_counter() - t0)
    k3_main = rec["chol_solve_launches"]
    cube2 = create_unit_cube(2)
    A64 = _f64_astar(cube2, beam_coeff(False), beam._sys.centers, beam_rotation, bs=3,
                     coeff_kind="tensor4", micro_degree=2)
    mask, bvals = merge_bcs(beam._bcs, beam.function_space.num_dofs, torch.float64, device)
    u64 = _f64_solution_of(beam, *assemble_macro_system(beam._sys, A64, beam._b_load, mask,
                                                        bvals, macro_f64=True))
    rec.update({"astar_rel_diff_f64": rel_diff(beam.homogenized_tensors(), A64),
                "u_rel_diff_f64": rel_diff(u, u64)})
    # the bench-size micro stage, P2 2³ and P1 4³ in turns
    centers = torch.as_tensor(np.random.default_rng(1).uniform(0, 1, (cells, 3)),
                              dtype=torch.float32, device=device)
    engs = {"p2_2": MicroEngine(cube2, bs=3, coeff_kind="tensor4", dtype=torch.float32,
                                device=device, micro_degree=2),
            "p1_4": MicroEngine(create_unit_cube(4), bs=3, coeff_kind="tensor4",
                                dtype=torch.float32, device=device)}
    stage = {key: [] for key in engs}
    coeff_x = beam_coeff(True)
    for key in ("p2_2", "p1_4", "p1_4", "p2_2"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            A = engs[key].tensors_for_centers(coeff_x, centers, G_fn=beam_rotation, chunk=chunk)
        torch.cuda.synchronize()
        stage[key].append(time.perf_counter() - t0)
        rec.setdefault("stage_finite", True)
        rec["stage_finite"] &= bool(torch.isfinite(A).all())
    rec.update({"stage_cells": cells, "stage_chunk": chunk, "stage_seconds": stage,
                "stage_n_reduced": {k: e.n_reduced for k, e in engs.items()}})
    emit(rec)
    out["b"] = rec
    # (c) P2 FEM
    f = lambda x: 2 * torch.pi**2 * torch.sin(torch.pi * x[0]) * torch.sin(torch.pi * x[1])  # noqa
    exact = lambda x: torch.sin(torch.pi * x[0]) * torch.sin(torch.pi * x[1])  # noqa: E731

    def fem(n, opts=None):
        V = FunctionSpace(create_unit_square(n, n), 1, degree=2)
        g = Function(V, device=device).interpolate(exact)
        model = PoissonFEM(V.mesh, lambda x: 1.0, f, opts, degree=2, dtype=torch.float32,
                           device=device)
        model.set_boundary_conditions([dirichletbc(g, boundary_dofs(V))])
        return model, g

    errs, rows = [], []
    for n in fem_ns:
        model, g = fem(n)
        u = model.solve()
        errs.append(l2_norm_space(u, exact=exact))
        rows.append({"n": n, "dofs": model.function_space.num_dofs, "l2_error": errs[-1],
                     "method": u.macro_method, "interpolated_on": str(g.array.device)})
    rates = [math.log(errs[i] / errs[i + 1]) / math.log(rows[i + 1]["n"] / rows[i]["n"])
             for i in range(2)]
    jac = SolverOptions(method="cg", pc="jacobi", rtol=1e-5, maxiter=20000)
    model, _ = fem(cg_n, jac)
    k2 = dia.KERNEL.launches
    u = model.solve()
    torch.cuda.synchronize()
    sys = u.system
    mask, bvals = merge_bcs(model._bcs, sys.V.num_dofs, torch.float64, device)
    vals, b = fem_system(sys, lambda x: 1.0, "scalar", f, mask, bvals)
    vals, b = vals.float().double(), b.float().double()
    x64, k64, _ = solvers.solve_ell(vals, sys.cols, b,
                                    SolverOptions(method="cg", pc="jacobi", rtol=1e-12,
                                                  atol=0.0, maxiter=100000), dia=sys.dia)
    rec = {"phase": "p2_fem", "rows": rows, "rates": rates, "cg_dofs": sys.V.num_dofs,
           "cg_iterations": u.solver_iterations, "cg_residual": u.solver_residual,
           "cg_seconds": u.diagnostics, "dia_view": None if sys.dia is None
           else len(sys.dia.offsets), "k2_launches": dia.KERNEL.launches - k2,
           "f64_iterations": k64, "u_rel_diff_f64": rel_diff(u.array, x64),
           "cg_l2_error": l2_norm_space(u, exact=exact)}
    emit(rec)
    out["c"] = rec
    a, b, c = out["a"], out["b"], out["c"]
    ok = (all(r["finite"] and r["k1_launches"] == 0 and r["diverged_cells"] == 0
              and r["nan_cells"] == 0 for r in (a, b))
          and not a["k1_route"] and not a["stencil"] and k2_main >= 1 and k3_main >= 1
          and a["astar_rel_diff_f64"] <= SLICE_ASTAR_RTOL and a["u_rel_diff_f64"] <= SLICE_MG_RTOL
          and b["astar_rel_diff_f64"] <= GOLDEN_ELASTICITY_RTOL
          and b["u_rel_diff_f64"] <= GOLDEN_ELASTICITY_RTOL and b["stage_finite"]
          and min(c["rates"]) >= P2_FEM_RATE and c["u_rel_diff_f64"] <= P2_FEM_CG_RTOL
          and c["cg_iterations"] < jac.maxiter)
    if not ok:
        raise AssertionError(f"P2 elements failed their checks: {out}")
    return {"dia_spmv": k2_main, "chol_solve": k3_main}


def jittered_delaunay(n: int, jitter: float = 0.25, seed: int = 3):
    """examples/diffusion/unstructured.py's mesh: the (n+1)² grid with its
    interior points moved by up to ``jitter``/n, triangulated by Delaunay;
    (mesh, Delaunay seconds)."""
    import numpy as np
    from scipy.spatial import Delaunay

    from hommx_tpu_torch import mesh_from_delaunay

    g = np.linspace(0.0, 1.0, n + 1)
    X, Y = np.meshgrid(g, g, indexing="ij")
    pts = np.stack([X.reshape(-1), Y.reshape(-1)], axis=1)
    rng = np.random.default_rng(seed)
    interior = (pts[:, 0] > 0) & (pts[:, 0] < 1) & (pts[:, 1] > 0) & (pts[:, 1] < 1)
    pts[interior] += rng.uniform(-jitter, jitter, (int(interior.sum()), 2)) / n
    t0 = time.perf_counter()
    tri = Delaunay(pts).simplices
    return mesh_from_delaunay(pts, tri), time.perf_counter() - t0


def random_delaunay(n: int, seed: int = 5):
    """The (n+1)² grid's boundary nodes and (n+1)² − 4n uniform interior
    points, triangulated by Delaunay: (mesh, Delaunay seconds)."""
    import numpy as np
    from scipy.spatial import Delaunay

    from hommx_tpu_torch import mesh_from_delaunay

    g = np.linspace(0.0, 1.0, n + 1)
    z, o = np.zeros(n), np.ones(n)
    edge = g[:-1]
    boundary = np.concatenate([np.stack([edge, z], 1), np.stack([o, edge], 1),
                               np.stack([1 - edge, o], 1), np.stack([z, 1 - edge], 1)])
    inner = np.random.default_rng(seed).uniform(0, 1, ((n + 1) ** 2 - 4 * n, 2))
    pts = np.concatenate([boundary, inner])
    t0 = time.perf_counter()
    tri = Delaunay(pts).simplices
    return mesh_from_delaunay(pts, tri), time.perf_counter() - t0


def _amg_probe(amg, vals, b, reps: int = 10) -> dict:
    """amg_setup's seconds (its device tables already made), whether its
    bottom Cholesky failed (then the pseudo-inverse), and the host
    milliseconds of one V-cycle (back to back, synchronized)."""
    import torch

    from hommx_tpu_torch.ops.amg import amg_setup, amg_vcycle

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = amg_setup(amg, vals)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    for _ in range(2):
        amg_vcycle(amg, state, b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        z = amg_vcycle(amg, state, b)
    torch.cuda.synchronize()
    return {"levels": amg.level_sizes, "host_build_seconds": dict(amg.timings),
            "amg_setup_seconds": t_setup, "bottom_pinv": state[-1]["bottom_pinv"],
            "vcycle_ms": (time.perf_counter() - t0) / reps * 1e3,
            "vcycle_finite": bool(torch.isfinite(z).all())}


def _fem_f64(u, coeff, f, bcs, solve: bool = True):
    """The system that ``fem_solve`` solved, stored as it was (a float32
    scalar system rounded once), in float64, and with ``solve`` its float64
    CG to 1e-12 on the same hierarchy: (x64, iterations, vals, b)."""
    import torch

    from hommx_tpu_torch import SolverOptions
    from hommx_tpu_torch.models.common import merge_bcs
    from hommx_tpu_torch.models.fem import fem_system
    from hommx_tpu_torch.ops import solvers

    sys = u.system
    mask, bvals = merge_bcs(bcs, sys.V.num_dofs, torch.float64, u.array.device)
    kind = "scalar" if sys.V.bs == 1 else "tensor4"
    vals, b = fem_system(sys, coeff, kind, f, mask, bvals)
    if u.array.dtype == torch.float32 and sys.V.bs == 1:
        vals, b = vals.float().double(), b.float().double()
    if not solve:
        return None, 0, vals, b
    x64, k64, _ = solvers.solve_ell(vals, sys.cols, b,
                                    SolverOptions(method="cg", rtol=1e-12, atol=0.0,
                                                  maxiter=20000),
                                    dia=sys.dia, mg=sys.mg, amg=sys.amg)
    return x64, k64, vals, b


def phase_amg(device, n: int = 512, micro_n: int = 16, rand_n: int = 512, p2_n: int = 256,
              beam_n=(20, 6, 6), grad_n: int = 64, grad_micro_n: int = 8):
    """The unstructured macro path: smoothed-aggregation AMG (plain torch,
    fixed-order gathers on the card) preconditioning the macro CG, float32
    unless stated.  (a) examples/diffusion/unstructured.py at n² (jitter
    0.25, seed 3; PoissonHMM, A = 1.1 + x₀ + sin 2πy₀, f = 1, 16² micro,
    ε = 1/32, dedup on, CG rtol 1e-5): cold then warm, setup seconds
    (Delaunay, MacroSystem, the AMG host build's sweep, QR and maps), the
    levels' sizes, amg_setup's seconds, iterations, ms per V-cycle, micro
    seconds and unique cells, K1's and K2's launches; u against the float64
    solve of its own system (the ELL gather: independent of K2, which
    phase dia holds on this mesh's pattern) and against the structured n²
    solution at the jittered nodes; Jacobi CG's iterations on the same
    system; two identical macro solves bitwise equal.  Only the runs
    through the entry points (a's two solves, b's to d's ``solve()``, e's
    card gradient) count their launches.  (b) a random-point Delaunay mesh
    of (rand_n+1)² vertices (no DIA view: the ELL gather) through
    PoissonFEM: iterations beside Jacobi's, u against float64.  (c)
    PoissonFEM(degree=2) at p2_n² with pc='auto': AMG-CG iterations, u
    against float64.  (d) LinearElasticityFEM(degree=2) on the 20x6x6 beam
    box (float64, six rigid modes) beside the translations alone, u against
    the float64 direct solve.  (e) build_pipeline on a grad_n² jittered
    mesh: dJ/dθ through K1 and the AMG-CG, forward and adjoint, against
    the CPU's float64 gradient."""
    import numpy as np
    import torch

    from hommx_tpu_torch import (Function, FunctionSpace, LinearElasticityFEM, PoissonFEM,
                                 PoissonHMM, SolverOptions, create_box, create_unit_square)
    from hommx_tpu_torch.micro import stencil_pcg
    from hommx_tpu_torch.models.common import MacroSystem
    from hommx_tpu_torch.ops import dia, solvers
    from hommx_tpu_torch.ops.amg import build_amg_structure
    from hommx_tpu_torch.ops.function_space import boundary_dofs
    from hommx_tpu_torch.ops.interpolation import eval_p1
    from hommx_tpu_torch.utils.validation import hooke_tensor

    main = {"stencil_pcg": 0, "dia_spmv": 0, "dia_spmv_f64": 0}

    def on_main_path(fn, *args):
        # the counts of one main-path run, set to 0 just before it and
        # read just after: the comparison runs between them count nowhere
        stencil_pcg.KERNEL.reset_counts()
        dia.KERNEL.reset_counts()
        result = fn(*args)
        torch.cuda.synchronize()
        n = {"stencil_pcg": stencil_pcg.KERNEL.launches,
             "dia_spmv": dia.KERNEL.counts["hommx_dia_spmv_f32"],
             "dia_spmv_f64": dia.KERNEL.counts["hommx_dia_spmv_f64"]}
        for key in main:
            main[key] += n[key]
        return result, n

    opts = SolverOptions(**AMG_OPTIONS)
    out = {}
    # (a) the unstructured example at full width
    micro = create_unit_square(micro_n, micro_n)
    mesh, t_del = jittered_delaunay(n)
    t0 = time.perf_counter()
    hmm = PoissonHMM(mesh, flagship, 1.0, micro, 2**-5, opts, dtype=torch.float32,
                     device=device, chunk=2048)
    t_model = time.perf_counter() - t0
    t0 = time.perf_counter()
    MacroSystem(hmm.function_space, torch.float32, device)
    torch.cuda.synchronize()
    t_sys = time.perf_counter() - t0
    t0 = time.perf_counter()
    amg = hmm._sys.amg
    t_amg = time.perf_counter() - t0
    runs = [on_main_path(_hmm_record, "amg_unstructured", hmm, 0.0)[0] for _ in ("cold", "warm")]
    rec, u = runs[0]
    rec.update({"delaunay_seconds": t_del, "model_setup_seconds": t_model,
                "macro_system_seconds": t_sys, "amg_host_build_seconds": t_amg,
                "cells": mesh.num_cells, "dia_view": None if hmm._sys.dia is None
                else len(hmm._sys.dia.offsets), "amg_levels": hmm.diagnostics["macro_amg_levels"],
                "warm": {k: runs[1][0][k] for k in ("solve_seconds", "micro_seconds",
                                                    "macro_seconds", "macro_iterations",
                                                    "k1_launches", "dia_spmv_launches")},
                "warm_u_bitwise_equal_cold": bool(torch.equal(runs[1][1], u))})
    vals, b = _rebuild_system(hmm, macro_f64=hmm._macro_f64)
    rec.update(_amg_probe(amg, vals, b))
    x1, k1, _ = solvers.solve_ell(vals, hmm._sys.cols, b, opts, dia=hmm._sys.dia, amg=amg)
    x2, _, _ = solvers.solve_ell(vals, hmm._sys.cols, b, opts, dia=hmm._sys.dia, amg=amg)
    jac = SolverOptions(method="cg", pc="jacobi", **AMG_OPTIONS)
    _, kj, _ = solvers.solve_ell(vals, hmm._sys.cols, b, jac, dia=hmm._sys.dia)
    # the float64 solve of the system solved, through the ELL gather: no K2
    u64, _, _ = solvers.solve_ell(vals.double(), hmm._sys.cols, b.double(),
                                  SolverOptions(rtol=1e-12, atol=0.0, maxiter=20000), amg=amg)
    t0 = time.perf_counter()
    hs = PoissonHMM(create_unit_square(n, n), flagship, 1.0, micro, 2**-5, opts,
                    dtype=torch.float32, device=device, chunk=2048)
    u_s = hs.solve()
    at_nodes = eval_p1(u_s, mesh.vertices).double()
    rec.update({"rebuilt_solve_iterations": k1, "macro_solves_bitwise_equal": bool(torch.equal(x1, x2)),
                "rebuilt_equals_solve": bool(torch.equal(x1, u)),
                "jacobi_iterations": kj, "u_rel_diff_f64": rel_diff(u, u64),
                "structured_seconds": time.perf_counter() - t0,
                "structured_macro_iterations": hs.diagnostics["macro_iterations"],
                "rel_l2_vs_structured": float(torch.linalg.vector_norm(u.double().cpu() - at_nodes.cpu())
                                              / torch.linalg.vector_norm(at_nodes))})
    emit(rec)
    out["a"] = rec
    del hmm, hs, runs, u, u_s, vals, b, x1, x2, u64
    torch.cuda.empty_cache()

    # (b) a random-point Delaunay mesh: no DIA view
    A_x = lambda x: 1.1 + x[0] + torch.sin(2 * torch.pi * x[1])  # noqa: E731
    rmesh, t_del = random_delaunay(rand_n)
    t0 = time.perf_counter()
    model = PoissonFEM(rmesh, A_x, 1.0, opts, dtype=torch.float32, device=device)
    uf, n_b = on_main_path(model.solve)
    rec = {"phase": "amg_random_delaunay", "delaunay_seconds": t_del,
           "total_seconds": time.perf_counter() - t0, "dofs": uf.function_space.num_dofs,
           "cells": rmesh.num_cells, "dia_view": uf.system.dia is not None, **uf.diagnostics,
           "amg_host_build_seconds": dict(uf.system.amg.timings),
           "iterations": uf.solver_iterations, "launches": n_b,
           "finite": bool(torch.isfinite(uf.array).all())}
    x64, k64, vals, b = _fem_f64(uf, A_x, 1.0, model._bcs)
    _, kj, _ = solvers.solve_ell(vals.float(), uf.system.cols, b.float(), jac, dia=uf.system.dia)
    rec.update({"f64_iterations": k64, "jacobi_iterations": kj,
                "u_rel_diff_f64": rel_diff(uf.array, x64),
                **_amg_probe(uf.system.amg, vals.float(), b.float())})
    emit(rec)
    out["b"] = rec
    del model, uf, x64, vals, b
    torch.cuda.empty_cache()

    # (c) P2 FEM at p2_n² with the default preconditioner
    f2 = lambda x: 2 * torch.pi**2 * torch.sin(torch.pi * x[0]) * torch.sin(torch.pi * x[1])  # noqa
    model = PoissonFEM(create_unit_square(p2_n, p2_n), lambda x: 1.0, f2, opts, degree=2,
                       dtype=torch.float32, device=device)
    t0 = time.perf_counter()
    u2, n_c = on_main_path(model.solve)
    rec = {"phase": "amg_p2", "dofs": u2.function_space.num_dofs,
           "total_seconds": time.perf_counter() - t0, **u2.diagnostics,
           "iterations": u2.solver_iterations, "launches": n_c,
           "dia_view": u2.system.dia is not None, "finite": bool(torch.isfinite(u2.array).all())}
    x64, k64, vals, b = _fem_f64(u2, lambda x: 1.0, f2, model._bcs)
    rec.update({"f64_iterations": k64, "u_rel_diff_f64": rel_diff(u2.array, x64),
                **_amg_probe(u2.system.amg, vals.float(), b.float())})
    emit(rec)
    out["c"] = rec
    del model, u2, x64, vals, b
    torch.cuda.empty_cache()

    # (d) P2 elasticity on the beam box: the rigid modes beside the translations
    box = create_box([[0, 0, 0], [BEAM_L, BEAM_W, BEAM_H]], list(beam_n))
    C = hooke_tensor(3, lambda x, y: 1.0 + 0.5 * torch.sin(2 * torch.pi * x[0]),
                     lambda x, y: 0.5)
    fb = torch.tensor([0.0, 0.0, -0.05 * (BEAM_W / BEAM_L) ** 2], dtype=torch.float64)
    model = LinearElasticityFEM(box, lambda x: C(x, x), lambda x: fb, degree=2,
                                dtype=torch.float32, device=device)
    clamp_x0(model)
    ue, n_d = on_main_path(model.solve)
    sys = ue.system
    rec = {"phase": "amg_p2_elasticity", "dofs": sys.V.num_dofs, **ue.diagnostics,
           "iterations": ue.solver_iterations, "residual": ue.solver_residual,
           "macro_method": ue.macro_method, "dia_view": sys.dia is not None,
           "near_kernel_columns": sys.amg.levels[0].p0_w.shape[1],
           "launches": n_d,
           "finite": bool(torch.isfinite(ue.array).all())}
    _, _, vals, b = _fem_f64(ue, lambda x: C(x, x), lambda x: fb, model._bcs, solve=False)
    trans = build_amg_structure(sys.pattern, 3)
    xt, kt, _ = solvers.solve_ell(vals, sys.cols, b, model._options, dia=sys.dia, amg=trans)
    x_dir = solvers.dense_solve_ell(vals, sys.cols, b)
    rec.update({"translations_iterations": kt, "translations_levels": trans.level_sizes,
                "u_rel_diff_direct_f64": rel_diff(ue.array, x_dir),
                "translations_rel_diff_direct_f64": rel_diff(xt, x_dir),
                **_amg_probe(sys.amg, vals, b)})
    emit(rec)
    out["d"] = rec
    del model, ue, vals, b, xt, x_dir
    torch.cuda.empty_cache()

    # (e) the gradient through K1 and the AMG-CG, forward and adjoint
    gmesh, _ = jittered_delaunay(grad_n)
    micro_g = create_unit_square(grad_micro_n, grad_micro_n)
    grad_opts = SolverOptions(rtol=1e-6, maxiter=20000)

    def grad(dev, dtype):
        holder = [1.0]
        hmm = PoissonHMM(gmesh, _theta_flagship(holder), lambda x: 1.0, micro_g, 2**-5,
                         grad_opts, dtype=dtype, device=dev, dedup_cells=False)
        step, centers = hmm.build_pipeline()

        def loss(th):
            holder[0] = th
            return (step(centers).double() ** 2).sum()

        r = _grad_pass(loss, torch.tensor(1.0, dtype=dtype, device=dev, requires_grad=True))
        r.update({"macro_iterations": list(step.macro_solve.iterations),
                  "amg_levels": None if hmm._sys.amg is None else hmm._sys.amg.level_sizes})
        return r

    card, n_e = on_main_path(grad, device, torch.float32)
    cpu = grad("cpu", torch.float64)
    rec = {"phase": "amg_pipeline_grad", "macro_n": grad_n, "micro_n": grad_micro_n,
           "dofs": (grad_n + 1) ** 2, "card": card, "cpu_f64": cpu, "launches": n_e,
           "rel_err": _rel(card["derivative"], cpu["derivative"])}
    emit(rec)
    out["e"] = rec
    a, b_, c, d, e = (out[k] for k in "abcde")
    ok = (a["finite"] and a["vcycle_finite"] and a["nan_cells"] == 0 and a["diverged_cells"] == 0
          and a["macro_method"] == "cg" and a["k1_launches"] > 0 and _cg_counts_ok(a)
          and a["dia_view"] is not None and a["amg_levels"] == a["levels"]
          and a["u_rel_diff_f64"] <= AMG_U_RTOL
          and a["rel_l2_vs_structured"] <= AMG_STRUCTURED_RTOL
          and AMG_JACOBI_FACTOR * a["macro_iterations"] <= a["jacobi_iterations"]
          and a["macro_solves_bitwise_equal"]
          and b_["finite"] and not b_["dia_view"] and b_["iterations"] < opts.maxiter
          and b_["u_rel_diff_f64"] <= AMG_FEM_RTOL
          and c["finite"] and c["iterations"] < opts.maxiter
          and c["macro_amg_levels"] is not None and c["u_rel_diff_f64"] <= AMG_FEM_RTOL
          and d["finite"] and d["macro_method"] == "cg" and d["near_kernel_columns"] == 6
          and d["iterations"] < SolverOptions().maxiter
          and d["u_rel_diff_direct_f64"] <= BEAM_CG_RTOL
          and math.isfinite(e["card"]["derivative"]) and e["rel_err"] <= GRAD_F64_RTOL
          and e["card"]["amg_levels"] is not None and len(e["card"]["macro_iterations"]) == 2
          and e["card"]["backward_launches"]["stencil_pcg"] >= 1
          and e["card"]["backward_launches"]["dia_spmv"] >= 1)
    if not ok:
        raise AssertionError(f"unstructured macro path failed its checks: {out}")
    emit({"phase": "amg_main_path_launches", **main})
    return main


def phase_sharded(device, macro_n: int = 512, micro_n: int = 16, grad_n: int = 64,
                  beam_n=(40, 12, 12), shards: int = 4):
    """Multi-device solves on ``ShardMesh([device] * shards)``: every shard
    on this card, so each shard's K1/K3 block, K2 launch, halo copy and dot
    runs here.  (a) The slice at macro_n² (16² micro, slice_mg's options,
    dedup off), sharded against unsharded, each solved twice (the second
    with A* cached: the macro stage alone): A*, u against the float64
    solve of its own system, the multigrid CG's iterations, K1's and K2's
    launches (one K2 launch a shard a product: each loop step and each
    solve's initial residual);
    the same solve on ``device_mesh()`` (one card: the replicated route)
    bitwise equal to the unsharded one.  (b) build_pipeline's dJ/dθ at
    grad_n² in 'auto' mode against the unsharded gradient; the macro_n²
    forward in 'shard_map' mode against 'auto'.  (c) The beam on a
    beam_n box (K3 per shard, the float64 multigrid CG through K2's
    float64 instance per shard) against the unsharded u.  (d)
    ``dryrun_multichip(shards)``.  Only the sharded runs of (a)-(c) count
    their launches; (d)'s count nowhere, since each of its checks also runs
    the unsharded pipeline it is held against."""
    import torch

    from hommx_tpu_torch import (PoissonHMM, ShardMesh, SolverOptions, create_unit_square,
                                 device_mesh, dryrun_multichip)
    from hommx_tpu_torch.micro import stencil_pcg
    from hommx_tpu_torch.ops import chol_kernel, dia

    t_phase = time.perf_counter()
    mesh = ShardMesh([device] * shards)
    main = {"stencil_pcg": 0, "dia_spmv": 0, "chol_solve": 0, "dia_spmv_f64": 0}

    def on_main_path(fn, *args):
        # the counts of one main-path run, set to 0 just before it and
        # read just after: the unsharded runs beside it count nowhere
        for k in (stencil_pcg.KERNEL, dia.KERNEL, chol_kernel.KERNEL):
            k.reset_counts()
        result = fn(*args)
        torch.cuda.synchronize()
        n = {"stencil_pcg": stencil_pcg.KERNEL.launches,
             "dia_spmv": dia.KERNEL.counts["hommx_dia_spmv_f32"],
             "chol_solve": chol_kernel.KERNEL.launches,
             "dia_spmv_f64": dia.KERNEL.counts["hommx_dia_spmv_f64"]}
        for key in main:
            main[key] += n[key]
        return result, n

    out = {}
    # (a) the slice, sharded against unsharded
    opts = SolverOptions(rtol=1e-5, maxiter=20000)
    macro, micro = create_unit_square(macro_n, macro_n), create_unit_square(micro_n, micro_n)

    def model(shard):
        return PoissonHMM(macro, flagship, 1.0, micro, 2**-5, opts, dtype=torch.float32,
                          device=device, chunk=2048, dedup_cells=False, shard_mesh=shard)

    def two_solves(hmm):
        runs = []
        for _ in range(2):
            u = hmm.solve().array
            dg = hmm.diagnostics
            runs.append({k: dg[k] for k in ("micro_seconds", "macro_seconds",
                                              "macro_iterations", "macro_steps")})
        return runs, u

    hmm_u = model(None)
    runs_u, u_u = two_solves(hmm_u)
    hmm_s = model(mesh)
    (runs_s, u_s), n_a = on_main_path(two_solves, hmm_s)
    steps = sum(r["macro_steps"] for r in runs_s)
    hmm_1 = model(device_mesh())
    (u_1, n_1) = on_main_path(lambda: hmm_1.solve().array)
    rec = {"phase": "sharded_slice", "shards": shards, "macro_n": macro_n, "micro_n": micro_n,
           "cells": int(hmm_s._sys.centers.shape[0]), "dofs": hmm_s.function_space.num_dofs,
           "sharded_macro": hmm_s._use_sharded_macro(), "unsharded": runs_u, "sharded": runs_s,
           "launches": n_a, "k2_launches_expected": shards * (steps + len(runs_s)),
           "astar_rel_diff": rel_diff(hmm_s.homogenized_tensors(), hmm_u.homogenized_tensors()),
           "u_rel_diff_to_unsharded": rel_diff(u_s, u_u),
           "u_rel_diff_own_system_f64": rel_diff(u_s, _own_system_f64(hmm_s)),
           "device_mesh_size": hmm_1._shard_mesh.size, "device_mesh_launches": n_1,
           "device_mesh_bitwise_equal": bool(torch.equal(u_1, u_u)),
           "finite": bool(torch.isfinite(u_s).all())}
    emit(rec)
    out["a"] = rec
    del hmm_u, hmm_1, u_u, u_1
    torch.cuda.empty_cache()

    # (b) the gradient in 'auto' mode, and the 'shard_map' forward
    grad_opts = SolverOptions(rtol=1e-5, maxiter=20000)

    def grad(shard):
        holder = [1.0]
        h = PoissonHMM(create_unit_square(grad_n, grad_n), _theta_flagship(holder),
                       lambda x: 1.0, micro, 2**-5, grad_opts, dtype=torch.float32,
                       device=device, dedup_cells=False)
        step, centers = h.build_pipeline(shard_mesh=shard, shard_mode="auto")

        def loss(th):
            holder[0] = th
            return (step(centers).double() ** 2).sum()

        r = _grad_pass(loss, torch.tensor(1.0, device=device, requires_grad=True))
        r["macro_iterations"] = list(step.macro_solve.iterations)
        r["sharded_macro"] = hasattr(step.macro_solve, "full")
        return r

    g_u = grad(None)
    g_s, n_b = on_main_path(grad, mesh)

    def forwards():
        with torch.no_grad():
            return {mode: hmm_s.build_pipeline(shard_mode=mode)[0](hmm_s._sys.centers)
                    for mode in ("auto", "shard_map")}

    u_modes, n_f = on_main_path(forwards)
    rec = {"phase": "sharded_pipeline", "grad_n": grad_n, "unsharded": g_u, "sharded": g_s,
           "grad_rel_err": _rel(g_s["derivative"], g_u["derivative"]), "launches": n_b,
           "forward_launches": n_f,
           "shard_map_rel_diff_to_auto": rel_diff(u_modes["shard_map"], u_modes["auto"]),
           "auto_rel_diff_to_solve": rel_diff(u_modes["auto"], u_s)}
    emit(rec)
    out["b"] = rec
    del hmm_s, u_s, u_modes
    torch.cuda.empty_cache()

    # (c) the beam's float64 multigrid CG, sharded
    keys = ("micro_seconds", "macro_seconds", "macro_iterations", "macro_steps")
    beam_u = make_beam(device, beam_n)
    u_b = beam_u.solve().array
    beam_s = make_beam(device, beam_n, shard_mesh=mesh)
    ub_s, n_c = on_main_path(lambda: beam_s.solve().array)
    dg = beam_s.diagnostics
    rec = {"phase": "sharded_beam", "macro_n": list(beam_n), "dofs": beam_s.function_space.num_dofs,
           "sharded_macro": beam_s._use_sharded_macro(), "macro_f64": beam_s._macro_f64,
           **{k: dg[k] for k in keys}, "unsharded": {k: beam_u.diagnostics[k] for k in keys},
           "launches": n_c, "u_rel_diff_to_unsharded": rel_diff(ub_s, u_b),
           "finite": bool(torch.isfinite(ub_s).all())}
    emit(rec)
    out["c"] = rec
    del beam_u, beam_s, u_b, ub_s
    torch.cuda.empty_cache()

    # (d) the six checks of dryrun_multichip (off the count: each runs the
    # unsharded pipeline beside the sharded one)
    t0 = time.perf_counter()
    errs = dryrun_multichip(shards, device)
    rec = {"phase": "sharded_dryrun", "shards": shards, "errors": errs,
           "seconds": time.perf_counter() - t0}
    emit(rec)
    out["d"] = rec
    a, b, c, d = (out[k] for k in "abcd")
    iters_u = [r["macro_iterations"] for r in a["unsharded"]]
    iters_s = [r["macro_iterations"] for r in a["sharded"]]
    ok = (a["finite"] and a["sharded_macro"] and a["astar_rel_diff"] <= SLICE_ASTAR_RTOL
          and a["u_rel_diff_own_system_f64"] <= SLICE_MG_RTOL
          and all(abs(i - j) <= 1 for i, j in zip(iters_s, iters_u))
          and a["launches"]["dia_spmv"] == a["k2_launches_expected"]
          and a["launches"]["stencil_pcg"] >= shards
          and a["device_mesh_size"] == torch.cuda.device_count()
          and (a["device_mesh_size"] > 1 or a["device_mesh_bitwise_equal"])
          and b["grad_rel_err"] <= SHARD_GRAD_RTOL and b["sharded"]["sharded_macro"]
          and len(b["sharded"]["macro_iterations"]) == 2
          and b["sharded"]["backward_launches"]["stencil_pcg"] >= shards
          and b["sharded"]["backward_launches"]["dia_spmv"] >= shards
          and b["shard_map_rel_diff_to_auto"] <= SHARD_MODES_RTOL
          and c["finite"] and c["sharded_macro"] and c["macro_f64"]
          and c["launches"]["dia_spmv_f64"] == shards * (c["macro_steps"] + 1)
          and c["launches"]["chol_solve"] >= shards and c["launches"]["dia_spmv"] == 0
          and c["u_rel_diff_to_unsharded"] <= BEAM_CG_RTOL and len(d["errors"]) == 10)
    if not ok:
        raise AssertionError(f"sharded solves failed their checks: {out}")
    emit({"phase": "sharded_main_path_launches", **main,
          "seconds": time.perf_counter() - t_phase})
    return main


def _card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def _no_native():
    """``HOMMX_TPU_NO_NATIVE=1`` inside the block: the setup's numpy routes."""
    from unittest import mock

    return mock.patch.dict(os.environ, {"HOMMX_TPU_NO_NATIVE": "1"})


def _in_turns(native_fn, numpy_fn, same, reps: int = 3) -> dict:
    """Both routes of a setup hot path, native then numpy, ``reps`` times in
    turns: their host seconds, each route's calls (from ``native.calls``),
    and whether every pair of outputs is equal (``same``)."""
    from hommx_tpu_torch import native

    secs = {"native": [], "numpy": []}
    equal = True
    native.reset_calls()
    for _ in range(reps):
        outs = {}
        for route, fn in (("native", native_fn), ("numpy", numpy_fn)):
            t0 = time.perf_counter()
            outs[route] = fn()
            secs[route].append(time.perf_counter() - t0)
        equal = equal and bool(same(outs["native"], outs["numpy"]))
    calls = {route: sum(c[route] for c in native.calls.values()) for route in secs}
    return {"native_seconds": secs["native"], "numpy_seconds": secs["numpy"],
            "speedup_median": statistics.median(secs["numpy"]) / statistics.median(secs["native"]),
            "calls": calls, "equal": equal}


def phase_host_native(device, macro_n: int = 512, fem_n: int = 1024, micro_n: int = 30,
                      p2_micro_n: int = 8, amg_n: int = 512, points: int = 10_000):
    """The native C++ host runtime (``hommx_tpu_torch/native``) on the card
    machine's CPU, against the numpy routes, in turns (three times each),
    with outputs compared: the ELL pattern of the macro_n² slice's dofmap
    and of the fem_n² FEM rectangle's; the periodic map of the micro_n²
    micro mesh (slice_stratified's) and of a p2_micro_n² P2 point set; the
    greedy aggregation of the jittered amg_n² Delaunay mesh (phase amg's)
    with its singleton merge; the binned location of ``points`` seeded
    interior points on that mesh (indices equal, or both cells containing
    the point).  Then the slice's and the FEM's MacroSystem built with the
    native routes and with HOMMX_TPU_NO_NATIVE=1, in turns: A15's first
    split of the setup.  Every native route must run (``native.calls``).
    Host-clock seconds on the card machine's CPU; no kernel runs."""
    import numpy as np
    import torch

    from hommx_tpu_torch import FunctionSpace, create_rectangle, create_unit_square, native
    from hommx_tpu_torch.micro import periodic
    from hommx_tpu_torch.models.common import MacroSystem
    from hommx_tpu_torch.ops import amg, interpolation, sparse

    t_phase = time.perf_counter()
    if not native.available:
        raise AssertionError(f"the native host runtime did not build: {native.build_error}")
    rec = {"phase": "host_native", "card": _card_line(), "clock": "host CPU of the card machine",
           "cpu_count": os.cpu_count(), "build_seconds": native.build_seconds,
           "library": native.library_path().name}

    def ell_same(a, b):
        return (a.row_width == b.row_width and np.array_equal(a.cols, b.cols)
                and np.array_equal(a.slots, b.slots)
                and np.array_equal(a.diag_slots, b.diag_slots))

    meshes = {"slice": create_unit_square(macro_n, macro_n),
              "fem": create_rectangle([[0, 0], [5, 5]], [fem_n, fem_n])}
    for key, m in meshes.items():
        rec[f"ell_{key}"] = {"cells": int(m.num_cells), "dofs": int(m.num_vertices), **_in_turns(
            lambda m=m: sparse.build_ell_pattern(m.cells, m.num_vertices),
            lambda m=m: sparse.build_ell_pattern_numpy(m.cells, m.num_vertices), ell_same)}

    def map_same(a, b):
        return (a.n_reduced == b.n_reduced and np.array_equal(a.masters, b.masters)
                and np.array_equal(a.is_slave, b.is_slave)
                and np.array_equal(a.reduced_index, b.reduced_index))

    point_sets = {
        "micro": create_unit_square(micro_n, micro_n).vertices,
        "p2_micro": FunctionSpace(create_unit_square(p2_micro_n, p2_micro_n), 1,
                                  degree=2).tabulate_dof_coordinates(),
    }
    for key, pts in point_sets.items():
        rec[f"periodic_{key}"] = {"points": int(pts.shape[0]), **_in_turns(
            lambda pts=pts: periodic.build_periodic_map_points(pts),
            lambda pts=pts: periodic.build_periodic_map_points_numpy(pts), map_same)}

    dmesh, t_delaunay = jittered_delaunay(amg_n)
    pat = sparse.build_ell_pattern(dmesh.cells, dmesh.num_vertices)
    N, K = pat.num_dofs, pat.row_width
    real = np.zeros(N * K, dtype=bool)
    real[pat.slots.reshape(-1)] = True
    slot = np.nonzero(real)[0]
    rows_n, cols_n = slot // K, pat.cols.reshape(-1)[slot].astype(np.int64)

    def aggregate():
        return amg._greedy_aggregate(rows_n, cols_n, N)

    def aggregate_numpy():
        with _no_native():
            return amg._greedy_aggregate(rows_n, cols_n, N)

    rec["aggregate"] = {"nodes": int(N), "edges": int(rows_n.size),
                        "delaunay_seconds": t_delaunay, **_in_turns(
                            aggregate, aggregate_numpy,
                            lambda a, b: a[1] == b[1] and np.array_equal(a[0], b[0]))}
    rec["aggregate"]["aggregates"] = int(aggregate()[1])

    q = np.random.default_rng(17).uniform(0.01, 0.99, (points, 2))

    def located_same(a, b):
        diff = np.nonzero(a != b)[0]
        rec["locate_differing"] = int(diff.size)
        inside = [min(interpolation._barycentric(dmesh.vertices[dmesh.cells[c]], q[i]).min()
                      for c in (a[i], b[i])) >= -1e-8 for i in diff]
        return all(inside)

    rec["locate"] = {"points": points, "cells": int(dmesh.num_cells), **_in_turns(
        lambda: interpolation._locate_binned(dmesh, q),
        lambda: interpolation._locate_binned_numpy(dmesh, q), located_same)}
    rec["locate"]["differing"] = rec.pop("locate_differing")

    # the MacroSystem setup of the slice and of the FEM flagship, in turns
    for key, m in meshes.items():
        V = FunctionSpace(m, 1)
        secs = {"native": [], "numpy": []}
        routes = {"native": {}, "numpy": {}}
        for _ in range(3):
            for route in ("native", "numpy"):
                native.reset_calls()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if route == "numpy":
                    with _no_native():
                        MacroSystem(V, torch.float32, device)
                else:
                    MacroSystem(V, torch.float32, device)
                torch.cuda.synchronize()
                secs[route].append(time.perf_counter() - t0)
                routes[route] = dict(native.calls["ell_pattern"])
            torch.cuda.empty_cache()
        rec[f"macro_system_{key}"] = {
            "native_seconds": secs["native"], "numpy_seconds": secs["numpy"],
            "saved_seconds_median": statistics.median(secs["numpy"])
            - statistics.median(secs["native"]),
            "ell_calls": routes}
    rec["seconds"] = time.perf_counter() - t_phase
    emit(rec)
    cases = [rec[k] for k in ("ell_slice", "ell_fem", "periodic_micro", "periodic_p2_micro",
                              "aggregate", "locate")]
    ok = (all(c["equal"] and c["calls"]["native"] >= 3 and c["calls"]["numpy"] >= 3
              for c in cases)
          and all(rec[f"macro_system_{k}"]["ell_calls"]["native"] == {"native": 1, "numpy": 0}
                  and rec[f"macro_system_{k}"]["ell_calls"]["numpy"] == {"native": 0, "numpy": 1}
                  for k in meshes))
    if not ok:
        raise AssertionError(f"native host runtime failed its checks: {rec}")
    return {}


def _plot_record(model, png, **kw) -> dict:
    """``model.plot_solution`` into ``png``: its seconds, the file's size,
    whether it is a PNG, and the backend (matplotlib where it is installed,
    else the numpy raster)."""
    t0 = time.perf_counter()
    out = model.plot_solution(filename=png, **kw)
    secs = time.perf_counter() - t0
    backend = "matplotlib" if hasattr(out, "savefig") else "raster"
    if backend == "matplotlib":
        import matplotlib.pyplot as plt

        plt.close(out)
    with open(png, "rb") as fh:
        magic = fh.read(8)
    return {"seconds": secs, "bytes": os.path.getsize(png), "backend": backend,
            "png": magic == b"\x89PNG\r\n\x1a\n"}


def phase_utils(device, macro_n: int = 512, micro_n: int = 16, small_n: int = 256,
                beam_n=(20, 6, 6)):
    """The utilities on the macro_n² flagship (slice_mg's solver: multigrid
    CG through K2, dedup off): a warm solve (after a cold one) inside
    ``PhaseTimer`` and ``trace``, whose trace file must name K1's and K2's
    launches, as many as their counts; ``save_hmm_state``, then
    ``load_hmm_state`` into a fresh PoissonHMM on the same mesh, whose solve
    launches K1 0 times and gives a u bitwise equal to the original's (the
    load's seconds beside the micro stage's); a small_n² solver must refuse
    the checkpoint (ValueError); ``plot_solution`` writes a PNG of the
    macro_n² u and a warped PNG of the beam_n beam (K3).  Every setup of
    the phase must take the native host runtime (``native.calls``)."""
    import tempfile

    import torch

    from hommx_tpu_torch import PoissonHMM, SolverOptions, create_unit_square, native
    from hommx_tpu_torch.micro import stencil_pcg
    from hommx_tpu_torch.ops import chol_kernel, dia
    from hommx_tpu_torch.utils.io import load_hmm_state, save_hmm_state
    from hommx_tpu_torch.utils.profiling import PhaseTimer, trace

    t_phase = time.perf_counter()
    native.reset_calls()
    main = {"stencil_pcg": 0, "dia_spmv": 0, "chol_solve": 0, "dia_spmv_f64": 0}

    def on_main_path(fn, *args):
        for k in (stencil_pcg.KERNEL, dia.KERNEL, chol_kernel.KERNEL):
            k.reset_counts()
        result = fn(*args)
        torch.cuda.synchronize()
        n = {"stencil_pcg": stencil_pcg.KERNEL.launches,
             "dia_spmv": dia.KERNEL.counts["hommx_dia_spmv_f32"],
             "chol_solve": chol_kernel.KERNEL.launches,
             "dia_spmv_f64": dia.KERNEL.counts["hommx_dia_spmv_f64"]}
        for key in main:
            main[key] += n[key]
        return result, n

    opts = SolverOptions(rtol=1e-5, maxiter=20000)
    micro = create_unit_square(micro_n, micro_n)

    def model(n):
        return PoissonHMM(create_unit_square(n, n), flagship, 1.0, micro, 2**-5, opts,
                          dtype=torch.float32, device=device, chunk=2048, dedup_cells=False)

    rec = {"phase": "utils", "card": _card_line(), "macro_n": macro_n, "micro_n": micro_n}
    with tempfile.TemporaryDirectory() as tmp:
        _, rec["cold_launches"] = on_main_path(lambda: model(macro_n).solve())
        timer = PhaseTimer()
        with timer.phase("setup"):
            hmm = model(macro_n)
        trace_dir = os.path.join(tmp, "trace")

        def traced():
            with trace(trace_dir), timer.phase("solve"):
                return hmm.solve().array

        u, n_traced = on_main_path(traced)
        files = os.listdir(trace_dir)
        path = os.path.join(trace_dir, files[0])
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
        kernel_events = {"stencil_pcg": 0, "dia_spmv": 0}
        for e in events:
            if e.get("cat") == "kernel":
                for key in kernel_events:
                    if f"{key}_kernel" in e.get("name", ""):
                        kernel_events[key] += 1
        rec.update({"timer": dict(timer.totals), "timer_summary": timer.summary(),
                    "trace_files": len(files), "trace_bytes": os.path.getsize(path),
                    "trace_events": len(events), "trace_kernel_events": kernel_events,
                    "traced_launches": n_traced,
                    "micro_seconds": hmm.diagnostics["micro_seconds"],
                    "macro_seconds": hmm.diagnostics["macro_seconds"]})
        del events

        ckpt = os.path.join(tmp, "state.npz")
        t0 = time.perf_counter()
        save_hmm_state(ckpt, hmm)
        rec["save_seconds"] = time.perf_counter() - t0
        rec["checkpoint_bytes"] = os.path.getsize(ckpt)
        t0 = time.perf_counter()
        loaded = model(macro_n)
        rec["reload_setup_seconds"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        load_hmm_state(ckpt, loaded)
        torch.cuda.synchronize()
        rec["load_seconds"] = time.perf_counter() - t0
        u_loaded, rec["reload_launches"] = on_main_path(lambda: loaded.solve().array)
        rec.update({"reload_micro_seconds": loaded.diagnostics["micro_seconds"],
                    "reload_macro_seconds": loaded.diagnostics["macro_seconds"],
                    "reload_bitwise_equal": bool(torch.equal(u_loaded, u)),
                    "reload_max_abs_diff": float((u_loaded - u).abs().max()),
                    "finite": bool(torch.isfinite(u).all())})
        try:
            load_hmm_state(ckpt, model(small_n))
            rec["small_mesh_refused"] = False
        except ValueError as e:
            rec["small_mesh_refused"] = "mesh" in str(e)

        png = os.path.join(tmp, "u512.png")
        rec["plot_u"] = _plot_record(hmm, png, title=f"u, {macro_n}² flagship")
        beam = make_beam(device, beam_n)
        u_beam, rec["beam_launches"] = on_main_path(lambda: beam.solve().array)
        warp = 0.1 * BEAM_L / float(u_beam.abs().max())
        png = os.path.join(tmp, "beam.png")
        rec["plot_beam"] = {**_plot_record(beam, png, warp=warp, title="rotated-fibre beam"),
                            "warp": warp, "max_abs_u": float(u_beam.abs().max())}
    del hmm, loaded, beam, u, u_loaded
    torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t_phase
    # every setup of this phase (five solvers, their micro meshes) took the
    # native host runtime
    rec["native_calls"] = {site: dict(c) for site, c in native.calls.items()}
    emit(rec)
    t, r, nc = rec["traced_launches"], rec["reload_launches"], rec["native_calls"]
    ok = (all(c["numpy"] == 0 for c in nc.values()) and nc["ell_pattern"]["native"] >= 5
          and nc["periodic_match"]["native"] >= 1
          and rec["finite"] and rec["trace_files"] == 1
          and set(rec["timer"]) == {"setup", "solve"}
          and t["stencil_pcg"] >= 1 and t["dia_spmv"] >= 1
          and rec["trace_kernel_events"]["stencil_pcg"] == t["stencil_pcg"]
          and rec["trace_kernel_events"]["dia_spmv"] == t["dia_spmv"]
          and r["stencil_pcg"] == 0 and r["dia_spmv"] >= 1 and rec["reload_bitwise_equal"]
          and rec["small_mesh_refused"] and rec["plot_u"]["png"] and rec["plot_beam"]["png"]
          and rec["plot_u"]["bytes"] > 10_000 and rec["plot_beam"]["bytes"] > 10_000
          and rec["beam_launches"]["chol_solve"] >= 1)
    if not ok:
        raise AssertionError(f"utilities failed their checks: {rec}")
    emit({"phase": "utils_main_path_launches", **main})
    return main


#: the record of K1's large instance at the 64² chunk (phase k1_large), for
#: the kernels line
K1_LARGE = {}


def contrast_coeff(x, y):
    """Contrast 100 in the cells whose centre has x₀ < 1/2 (100 in a disc
    of radius 1/4 at the middle of the cell, 1 outside), the flagship
    coefficient in the others: the contrast cells need several times the
    flagship's PCG iterations."""
    import torch

    inc = (y[0] - 0.5) ** 2 + (y[1] - 0.5) ** 2 < 0.0625
    return torch.where(x[0] < 0.5, torch.where(inc, 100.0, 1.0), flagship(x, y))


def _mixed_centers(C, cb, rng):
    """C centres in 2D whose blocks of ``cb`` cells alternate between the
    contrast-100 half (x₀ < 1/2, even blocks) and the flagship half: half
    the blocks stop many iterations after the others."""
    import numpy as np

    x0 = np.where((np.arange(C) // cb) % 2 == 0, rng.uniform(0, 0.5, C), rng.uniform(0.5, 1, C))
    return np.stack([x0, rng.uniform(0, 1, C)], axis=1)


def phase_k1_large(device, sizes2=(33, 48, 64), sizes3=(10, 12, 16),
                   timed=("2d33", "2d64", "3d16"), macro_n: int = 128, micro_n: int = 64,
                   cube_n: int = 6, micro3_n: int = 16, sampled: int = 256, mg_cells=None):
    """K1's large instance (n above the small instance's reach, up to 4096):
    (a) K1 against its plain version at the kernel's block size on one
    auto-sized chunk of the 33², 48², 64², 10³, 12³ and 16³ micro meshes,
    on a ragged 37-cell chunk of 64² (flagship coefficient) and on a
    mixed-stop 64² chunk (``contrast_coeff``: alternate blocks of
    contrast-100 cells, held on A* alone, its counts beside the float64
    plain version's), the iterations of each block side by side; two
    identical launches on the 64² chunk bitwise equal; 33², 64² and 16³
    timed, with the bound and the float32 Minv product as yardstick.  (b)
    PoissonHMM with the flagship coefficient on a 128² macro mesh and a 64²
    micro mesh (n = 4096, s = 2), float32, dedup off: K1's large launches
    equal to the micro stage's chunks, A* of ``sampled`` cells against a
    float64 engine on the card, u against the float64 solve of its own
    system, and the micro stage beside the same cells on cell_prec='mg'
    (``mg_cells`` of them where given), the route such cells took before.
    (c) The same on create_unit_cube(6) with a 16³ micro cube (n = 4096,
    s = 3)."""
    import numpy as np
    import torch

    from hommx_tpu_torch import (MicroEngine, PoissonHMM, SolverOptions, create_unit_cube,
                                 create_unit_square)
    from hommx_tpu_torch.micro import stencil_pcg
    from hommx_tpu_torch.ops import dia

    t_phase = time.perf_counter()
    rng = np.random.default_rng(17)
    large = "hommx_stencil_pcg_large_f32"
    failed = []
    # (a) the kernel against its plain version
    meshes = ([(f"2d{m}", lambda m=m: create_unit_square(m, m)) for m in sizes2]
              + [(f"3d{m}", lambda m=m: create_unit_cube(m)) for m in sizes3])
    for name, make in meshes:
        eng = MicroEngine(make(), device=device, dtype=torch.float32)
        C = eng._auto_chunk(1 << 20)
        cases = [(name, rng.uniform(0, 1, (C, eng.d)), None)]
        if name == f"2d{max(sizes2)}":
            cb = stencil_pcg.launch_config(eng.n_reduced, eng.s, C).cells_per_block
            cases += [(f"{name}_C37", rng.uniform(0, 1, (37, eng.d)), None),
                      (f"{name}_mixed", _mixed_centers(C, cb, rng), contrast_coeff)]
        for tag, cen, coeff in cases:
            centers = torch.as_tensor(cen, dtype=torch.float32, device=device)
            before = stencil_pcg.KERNEL.counts[large]
            rec, ok = _k1_case(eng, centers, timed=tag in timed, coeff=coeff,
                               repeat=tag == f"2d{max(sizes2)}",
                               iter_slack=None if coeff else K1_ITER_SLACK)
            rec = {"phase": "k1_large", "case": tag, "card": _card_line(),
                   "large_launches": stencil_pcg.KERNEL.counts[large] - before, **rec}
            if "ms" in rec:
                rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
            emit(rec)
            if tag == "2d64":
                K1_LARGE.update(rec)
            if not (ok and rec["large"] and rec["large_launches"] >= 1):
                failed.append(tag)
        del eng
        torch.cuda.empty_cache()

    # (b), (c) through the entry points
    main = {"stencil_pcg": 0, "stencil_pcg_large": 0, "dia_spmv": 0, "dia_spmv_f64": 0}
    opts = SolverOptions(rtol=1e-5, maxiter=20000)
    runs = (("hmm_2d64", lambda: create_unit_square(macro_n, macro_n),
             create_unit_square(micro_n, micro_n)),
            ("hmm_3d16", lambda: create_unit_cube(cube_n), create_unit_cube(micro3_n)))
    for tag, make_macro, micro in runs:
        t0 = time.perf_counter()
        hmm = PoissonHMM(make_macro(), flagship, 1.0, micro, 2**-5, opts, dtype=torch.float32,
                         device=device, dedup_cells=False)
        t_setup = time.perf_counter() - t0
        for kern in (stencil_pcg.KERNEL, dia.KERNEL):
            kern.reset_counts()
        rec, u = _solve_record(tag, hmm, t_setup)
        counts = {"stencil_pcg": stencil_pcg.KERNEL.counts["hommx_stencil_pcg_f32"],
                  "stencil_pcg_large": stencil_pcg.KERNEL.counts[large],
                  "dia_spmv": dia.KERNEL.counts["hommx_dia_spmv_f32"],
                  "dia_spmv_f64": dia.KERNEL.counts["hommx_dia_spmv_f64"]}
        for key in main:
            main[key] += counts[key]
        eng = hmm._engine
        nc = rec["num_cells"]
        chunk = min(hmm._chunk or eng._auto_chunk(nc), nc)
        cfg = stencil_pcg.launch_config(eng.n_reduced, eng.s, chunk)
        rec.update({"card": _card_line(), "n": eng.n_reduced, "s": eng.s, "chunk": chunk,
                    "chunks": -(-nc // chunk), "launches": counts,
                    "cells_per_block": cfg.cells_per_block, "tile_cols": cfg.tile_cols,
                    "grid": cfg.grid,
                    "cell_solves_per_s": nc * eng.s / rec["micro_seconds"]})
        # A* of sampled cells against a float64 engine on the card
        A32 = hmm.homogenized_tensors()
        idx = torch.as_tensor(np.sort(rng.choice(nc, min(sampled, nc), replace=False)),
                              device=device)
        A64 = _f64_astar(micro, flagship, hmm._sys.centers[idx])
        rec["astar_cells"] = int(idx.numel())
        rec["astar_rel_err"] = float((A32[idx].double() - A64).abs().max() / A64.abs().max())
        rec["u_rel_err_own_f64"] = rel_diff(u, _own_system_f64(hmm))
        # the same cells' micro stage on K1's route and on cell_prec='mg'
        centers = hmm._sys.centers if mg_cells is None else hmm._sys.centers[:mg_cells]
        eng_mg = MicroEngine(**{**eng._ctor, "cell_prec": "mg", "dtype": eng.dtype})
        for route, e in (("k1", eng), ("mg", eng_mg)):
            before = stencil_pcg.KERNEL.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                e.tensors_for_centers(hmm._coeff, centers, G_fn=hmm._G_fn(), chunk=hmm._chunk)
            torch.cuda.synchronize()
            rec[f"{route}_route_seconds"] = time.perf_counter() - t0
            rec[f"{route}_route_k1_launches"] = stencil_pcg.KERNEL.launches - before
        rec["route_cells"] = int(centers.shape[0])
        rec["mg_over_k1"] = rec["mg_route_seconds"] / rec["k1_route_seconds"]
        emit(rec)
        if not (_run_ok(rec) and counts["stencil_pcg_large"] == rec["chunks"]
                and counts["stencil_pcg"] == 0 and rec["astar_rel_err"] < K1_LARGE_ASTAR_RTOL
                and rec["u_rel_err_own_f64"] < K1_LARGE_U_RTOL
                and rec["k1_route_k1_launches"] >= 1 and rec["mg_route_k1_launches"] == 0):
            failed.append(tag)
        del hmm, eng, eng_mg, A32, A64, u
        torch.cuda.empty_cache()
    emit({"phase": "k1_large_summary", "seconds": time.perf_counter() - t_phase,
          "failed": failed, **main})
    if failed:
        raise AssertionError(f"K1's large instance failed its checks: {failed}")
    return main


def _k3_large_run(tag, hmm, t_setup, sampled, rng) -> tuple:
    """One elasticity solve through the entry point with K3's counts reset
    before it: the run's record with its K3 launches per instance and
    chunks, A* of ``sampled`` cells against a float64 engine on the card
    beside the plain float32 route's distance, and u against the float64
    solve of its own system.  Returns (record, launches, ok)."""
    import numpy as np
    import torch

    from hommx_tpu_torch.micro.chunk import tensors_chunk_chol_plain
    from hommx_tpu_torch.micro.krylov import _map_chunked
    from hommx_tpu_torch.ops import chol_kernel

    small, large = "hommx_chol_solve_f32", "hommx_chol_solve_large_f32"
    chol_kernel.KERNEL.reset_counts()
    rec, u = _solve_record(tag, hmm, t_setup)
    counts = {"chol_solve": chol_kernel.KERNEL.counts[small],
              "chol_solve_large": chol_kernel.KERNEL.counts[large]}
    eng = hmm._engine
    nc = rec["num_cells"]
    chunk = min(hmm._chunk or eng._auto_chunk(nc), nc)
    cfg = chol_kernel.chol_launch_config(eng.n_reduced, eng.s, chunk)
    rec.update({"card": _card_line(), "n": eng.n_reduced, "s": eng.s, "dtype": str(eng.dtype),
                "solver": eng.solver, "chunk": chunk, "chunks": -(-nc // chunk),
                "launches": counts, "cluster": cfg.cluster,
                "workspace_bytes_per_cell": cfg.workspace_bytes,
                "cell_solves_per_s": nc * eng.s / rec["micro_seconds"]})
    A32 = hmm.homogenized_tensors()
    idx = torch.as_tensor(np.sort(rng.choice(nc, min(sampled, nc), replace=False)),
                          device=A32.device)
    centers, G_fn = hmm._sys.centers[idx], hmm._G_fn()
    A64 = _f64_astar(eng.mesh, hmm._coeff, centers, G_fn, bs=eng.bs, coeff_kind="tensor4")
    with torch.no_grad():
        Ap = _map_chunked(lambda c: tensors_chunk_chol_plain(eng, hmm._coeff, c, G_fn),
                          centers.to(eng.dtype), chunk)
    scale = float(A64.abs().max())
    rec["astar_cells"] = int(idx.numel())
    rec["astar_rel_err"] = float((A32[idx].double() - A64).abs().max()) / scale
    rec["plain_f32_astar_rel_err"] = float((Ap.double() - A64).abs().max()) / scale
    rec["u_rel_err_own_f64"] = rel_diff(u, _own_system_f64(hmm))
    rec["bars"] = {"astar": K3_LARGE_ASTAR_RTOL, "astar_vs_plain": "2x + 1e-6",
                   "u": K3_LARGE_U_RTOL}
    emit(rec)
    ok = (_run_ok(rec) and counts["chol_solve_large"] == rec["chunks"]
          and counts["chol_solve"] == 0
          and rec["astar_rel_err"] < K3_LARGE_ASTAR_RTOL
          and rec["astar_rel_err"] <= 2 * rec["plain_f32_astar_rel_err"] + K3_LARGE_ASTAR_SLACK
          and rec["u_rel_err_own_f64"] < K3_LARGE_U_RTOL)
    return rec, counts, ok


def phase_k3_large(device, beam_n=(20, 6, 6), cube_n: int = 6, square_macro: int = 32,
                   square_micro: int = 16, grad_n=(10, 3, 3), sampled: int = 256,
                   engine_cubes=(5, 6, 8), engine_squares=(13, 16), engine_cells: int = 8):
    """K3's large instance on the main path, float32, dedup off: (a) the
    rotated-fibre beam of examples/linear_elasticity/rotated_fibers.py at
    its full 20x6x6 macro with a 6³ micro cube in place of its 4³ (n = 648,
    s = 6, 4320 cells); (b) LinearElasticityHMM in 2D on a 32² macro with a
    16² micro square (n = 512, s = 3, 2048 cells; docs/usage.md's large
    micro cell), the inclusion coefficient, clamped at x₀ = 0.  Each: K3's
    large launches equal the micro stage's chunks and no chunk takes the
    small instance or the plain route; A* of ``sampled`` cells within 1e-4
    of a float64 engine on the card and within 2x the plain float32
    route's distance + 1e-6; u within 1e-6 of the float64 solve of its own
    system.  (c) MicroEngine with default arguments (the card, float32,
    the chunk Cholesky) on the 5³, 6³ and 8³ cubes and the 13² and 16²
    squares: ``engine_cells`` fresh cells each in one large launch, A*
    within 1e-4 of the float64 plain route.  (d) build_pipeline's dJ/dθ
    on the quick 10x3x3 beam with the 6³ cell (the adjoint through the
    large instance) within 1e-3 of the CPU's float64 gradient."""
    import numpy as np
    import torch

    from hommx_tpu_torch import (LinearElasticityHMM, MicroEngine, create_unit_cube,
                                 create_unit_square, dirichletbc)
    from hommx_tpu_torch.ops import chol_kernel
    from hommx_tpu_torch.ops.function_space import boundary_dofs
    from hommx_tpu_torch.utils.validation import hooke_tensor

    t_phase = time.perf_counter()
    rng = np.random.default_rng(18)
    main = {"chol_solve": 0, "chol_solve_large": 0}
    failed = []

    def add(counts):
        for key in main:
            main[key] += counts[key]

    # (a) the beam with 6³ cells
    t0 = time.perf_counter()
    hmm = make_beam(device, macro_n=beam_n, micro_n=cube_n)
    rec, counts, ok = _k3_large_run("k3_large_beam", hmm, time.perf_counter() - t0, sampled,
                                    rng)
    add(counts)
    if not ok:
        failed.append(rec["phase"])
    del hmm
    torch.cuda.empty_cache()

    # (b) 2D elasticity with 16² cells
    t0 = time.perf_counter()
    macro = create_unit_square(square_macro, square_macro)
    f = torch.tensor([0.0, -0.01], dtype=torch.float64)
    hmm = LinearElasticityHMM(macro, hooke_tensor(2, inclusion_mu, lambda x, y: 1.0),
                              lambda x: f, create_unit_square(square_micro, square_micro), 2**-4,
                              dtype=torch.float32, device=device, dedup_cells=False)
    V = hmm.function_space
    hmm.set_boundary_conditions(
        dirichletbc(np.zeros(2), boundary_dofs(V, lambda x: np.isclose(x[0], 0)), V))
    rec, counts, ok = _k3_large_run("k3_large_square", hmm, time.perf_counter() - t0, sampled,
                                    rng)
    add(counts)
    if not ok:
        failed.append(rec["phase"])
    del hmm
    torch.cuda.empty_cache()

    # (c) the engines with default arguments on every cell the small
    # instance cannot hold, a few fresh cells each
    small, large = "hommx_chol_solve_f32", "hommx_chol_solve_large_f32"
    rows = []
    for mesh, coeff, G_fn in [(create_unit_cube(k), beam_coeff(True), beam_rotation)
                              for k in engine_cubes] + \
            [(create_unit_square(k, k), hooke_tensor(2, inclusion_mu, lambda x, y: 1.0), None)
             for k in engine_squares]:
        e = MicroEngine(mesh, bs=mesh.dim, coeff_kind="tensor4")
        c = torch.as_tensor(rng.uniform(0, 1, (engine_cells, mesh.dim)), dtype=e.dtype,
                            device=e.device)
        before = dict(chol_kernel.KERNEL.counts)
        with torch.no_grad():
            A = e.tensors_for_centers(coeff, c, G_fn=G_fn)
        torch.cuda.synchronize()
        A64 = _f64_astar(mesh, coeff, c, G_fn, bs=mesh.dim, coeff_kind="tensor4")
        rows.append({"dim": mesh.dim, "n": e.n_reduced, "s": e.s, "dtype": str(e.dtype),
                     "device": str(e.device), "solver": e.solver,
                     "k3_launches": chol_kernel.KERNEL.counts[small] - before[small],
                     "k3_large_launches": chol_kernel.KERNEL.counts[large] - before[large],
                     "astar_rel_err": rel_diff(A, A64), "finite": bool(torch.isfinite(A).all())})
        main["chol_solve_large"] += rows[-1]["k3_large_launches"]
        main["chol_solve"] += rows[-1]["k3_launches"]
    emit({"phase": "k3_large_engines", "cells": engine_cells, "rows": rows,
          "bar": K3_LARGE_ASTAR_RTOL})
    if not all(r["finite"] and r["dtype"] == "torch.float32" and r["solver"] == "cholesky"
               and r["k3_large_launches"] == 1 and r["k3_launches"] == 0
               and r["astar_rel_err"] < K3_LARGE_ASTAR_RTOL for r in rows):
        failed.append("k3_large_engines")

    # (d) the gradient through the large instance
    card = _beam_grad(device, torch.float32, grad_n, micro_n=cube_n)
    cpu = _beam_grad("cpu", torch.float64, grad_n, micro_n=cube_n)
    rec = {"phase": "k3_large_grad", "macro_n": list(grad_n), "micro_n": cube_n, "card": card,
           "cpu_f64": cpu, "rel_err": _rel(card["derivative"], cpu["derivative"]),
           "bar": BEAM_GRAD_RTOL}
    emit(rec)
    fwd, bwd = card.get("forward_launches", {}), card.get("backward_launches", {})
    for key in main:
        main[key] += fwd.get(key, 0) + bwd.get(key, 0)
    if not (math.isfinite(card["derivative"]) and rec["rel_err"] <= BEAM_GRAD_RTOL
            and bwd.get("chol_solve_large", 0) >= 1 and fwd.get("chol_solve_large", 0) >= 1
            and fwd.get("chol_solve", 0) == 0):
        failed.append("k3_large_grad")
    emit({"phase": "k3_large_summary", "seconds": time.perf_counter() - t_phase,
          "failed": failed, **main})
    if failed:
        raise AssertionError(f"K3's large instance failed its checks: {failed}")
    return main


#: the example scripts (``hommx_tpu_torch/examples/``) in the order of phase
#: examples: the name, the module, the kernels that the run must launch
#: (none: it must launch no kernel), and the keyword arguments beyond the
#: default size (``plot`` where the example has ``--plot``)
EXAMPLES = (
    ("hmm", "hmm", ("stencil_pcg", "dia_spmv"), {"plot": True}),
    ("laminate", "diffusion.laminate", ("stencil_pcg", "dia_spmv", "dia_spmv_f64"),
     {"plot": True}),
    ("inclusion", "diffusion.inclusion", ("stencil_pcg", "dia_spmv"), {"plot": True}),
    ("hmm_3d", "hmm_3d", ("stencil_pcg", "dia_spmv"), {}),
    ("periodic_cell_load", "diffusion.periodic_cell_load", (), {}),
    ("rotated_fibers", "linear_elasticity.rotated_fibers", ("chol_solve",), {}),
    ("high_res_micro", "linear_elasticity.high_res_micro", ("chol_solve", "chol_solve_large"),
     {}),
    ("unstructured", "diffusion.unstructured", ("stencil_pcg", "dia_spmv"), {}),
    ("inverse_design", "inverse_design", ("stencil_pcg",), {}),
)

#: what the JAX examples print at their default sizes, float64 on the CPU
#: (``python examples/<name>.py``; the unrounded values read from each
#: ``main``'s locals, and high_res_micro's 16³ step computed the same way)
EXAMPLES_F64 = {
    "hmm": {"rel": 0.07575871075192699},
    "laminate": {"rel": 0.03405700849917928, "rel_het": 0.44296215995877375},
    "inclusion": {"rel": 0.009992276154911472},
    "hmm_3d": {"rel": 0.04370167699889176},
    "periodic_cell_load": {"errors": [0.07298611625496655, 0.0181917855810415,
                                      0.0045446284052803945, 0.0011359513045507855]},
    "rotated_fibers": {"max_u": 0.3765643453906081, "tip": -0.3765643453906081},
    "high_res_micro": {"A11": [40.584937499999974, 41.105765624999975, 40.454730468749965],
                       "A22": [1.5753302896796315, 1.3159820316543165, 1.2958968090319558]},
    "unstructured": {"rel": 0.00044714554372970344, "macro_iterations": 10},
    "inverse_design": {"m": 7.0},
}
EXAMPLE_ERR_ABS = 5e-4  # a printed relative L² error, float32 on the card vs float64
EXAMPLE_ASTAR_RTOL = 1e-4  # high_res_micro's A*₁₁ and A*₂₂, as micro_highres (d)


def _example_misses(name, res) -> list:
    """The numbers of one example's ``run`` that miss their bar against
    ``EXAMPLES_F64`` (unstructured and inverse_design: their own
    assertions, which ``run`` raises)."""
    ref, misses = EXAMPLES_F64[name], []

    def check(key, value, target, ok):
        if not (math.isfinite(value) and ok):
            misses.append({"key": key, "value": value, "f64": target})

    if name in ("hmm", "laminate", "inclusion", "hmm_3d"):
        for key, target in ref.items():
            value = res.get(key, math.nan)
            check(key, value, target, abs(value - target) <= EXAMPLE_ERR_ABS)
    elif name == "periodic_cell_load":
        for n, value, target in zip(res["sizes"], res["errors"], ref["errors"]):
            check(f"error_{n}", value, target, abs(value - target) <= EXAMPLE_ERR_ABS)
        check("delta", res["delta"], 0.0, res["delta"] < 1e-10)
    elif name == "rotated_fibers":
        for key in ("max_u", "tip"):
            check(key, res[key], ref[key], _rel(res[key], ref[key]) <= GOLDEN_ELASTICITY_RTOL)
    elif name == "high_res_micro":
        for row, a11, a22 in zip(res["rows"], ref["A11"], ref["A22"]):
            check(f"A11_{row['n']}", row["A11"], a11, _rel(row["A11"], a11) <= EXAMPLE_ASTAR_RTOL)
            check(f"A22_{row['n']}", row["A22"], a22, _rel(row["A22"], a22) <= EXAMPLE_ASTAR_RTOL)
    return misses


def phase_examples(device, overrides=None):
    """Every example script on the card at its default size (float32; the
    float64 steps where the example asks for float64: periodic_cell_load,
    high_res_micro's 16³, laminate's heterogeneous FEM), ``--plot`` where it has one, its PNGs into a
    temporary directory: one record each with the lines it printed, its
    numbers, seconds and each kernel's launches in the run, held to the
    JAX examples' float64 values (``EXAMPLES_F64``): a printed relative L²
    error within 5e-4, the beam's max |u| and tip within 2e-3 relative, A*
    within 1e-4 relative; unstructured and inverse_design by their own
    assertions.  Every PNG must exist and start with the PNG signature;
    each run must launch the kernels ``EXAMPLES`` names (and
    periodic_cell_load none).  ``overrides`` maps a name to keyword
    arguments of its ``run`` (a CPU rehearsal's small sizes)."""
    import contextlib
    import importlib
    import io
    import tempfile

    import torch

    from hommx_tpu_torch.micro import stencil_pcg
    from hommx_tpu_torch.ops import chol_kernel, dia

    counters = {"stencil_pcg": (stencil_pcg.KERNEL, "hommx_stencil_pcg_f32"),
                "stencil_pcg_large": (stencil_pcg.KERNEL, "hommx_stencil_pcg_large_f32"),
                "dia_spmv": (dia.KERNEL, "hommx_dia_spmv_f32"),
                "dia_spmv_f64": (dia.KERNEL, "hommx_dia_spmv_f64"),
                "chol_solve": (chol_kernel.KERNEL, "hommx_chol_solve_f32"),
                "chol_solve_large": (chol_kernel.KERNEL, "hommx_chol_solve_large_f32")}
    main = dict.fromkeys(counters, 0)
    failed, t_phase = [], time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        for name, module, expected, kw in EXAMPLES:
            ex = importlib.import_module(f"hommx_tpu_torch.examples.{module}")
            kw = {**kw, **(overrides or {}).get(name, {})}
            out = os.path.join(tmp, name)
            for k in (stencil_pcg.KERNEL, dia.KERNEL, chol_kernel.KERNEL):
                k.reset_counts()
            printed = io.StringIO()
            t0 = time.perf_counter()
            try:
                with contextlib.redirect_stdout(printed):
                    res = ex.run(device=device, out=out, **kw)
                torch.cuda.synchronize()
                error = None
            except AssertionError as e:  # unstructured's and inverse_design's bars
                res, error = {"pngs": []}, f"AssertionError: {e}"
            seconds = time.perf_counter() - t0
            launches = {key: k.counts[fn] for key, (k, fn) in counters.items()}
            for key in main:
                main[key] += launches[key]
            pngs = []
            for path in res["pngs"]:
                exists, magic = os.path.exists(path), b""
                if exists:
                    with open(path, "rb") as fh:
                        magic = fh.read(8)
                pngs.append({"file": os.path.basename(path), "exists": exists,
                             "bytes": os.path.getsize(path) if exists else 0,
                             "png": magic == b"\x89PNG\r\n\x1a\n"})
            misses = [] if error else _example_misses(name, res)
            kernels_ok = (all(launches[k] >= 1 for k in expected) if expected
                          else sum(launches.values()) == 0)
            ok = (error is None and not misses and kernels_ok and all(p["png"] for p in pngs)
                  and (name not in ("hmm_3d", "rotated_fibers") or len(pngs) == 1))
            numbers = {k: v for k, v in res.items() if k != "pngs"}
            if "rows" in numbers:  # high_res_micro: the diagonal entries, not A
                numbers["rows"] = [{k: v for k, v in r.items() if k != "A"}
                                   for r in numbers["rows"]]
            emit({"phase": "examples", "example": name, "seconds": seconds,
                  "lines": printed.getvalue().splitlines(), "numbers": numbers,
                  "f64": EXAMPLES_F64[name], "misses": misses, "error": error,
                  "launches": launches, "expected_kernels": list(expected), "pngs": pngs,
                  "ok": ok})
            if not ok:
                failed.append(name)
            torch.cuda.empty_cache()
    emit({"phase": "examples_summary", "card": _card_line(),
          "seconds": time.perf_counter() - t_phase, "failed": failed, **main})
    if failed:
        raise AssertionError(f"examples failed their checks: {failed}")
    return main


#: the phases of the periodic, FEM and per-cell slice, of differentiation,
#: of the micro engine's other routes, of the FFT and P2 routes, of the
#: unstructured macro path, of multi-device solves, of the native host
#: runtime and the utilities, of K1's and K3's large instances, and of the
#: example scripts, in their order
NEW_PHASES = (phase_fem_flagship, phase_golden_periodic_fem, phase_periodic_identity,
              phase_elasticity_periodic, phase_chol_batched, phase_kc_gather,
              phase_pipeline_grad, phase_pipeline_grad_elasticity, phase_fem_grad,
              phase_micro_highres, phase_micro_routes, phase_micro_fft, phase_p2, phase_amg,
              phase_sharded, phase_host_native, phase_utils, phase_k1_large, phase_k3_large,
              phase_examples)


def main(argv) -> int:
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
    if argv[:1] == ["--only"]:
        # development runs: the named phases of NEW_PHASES alone, and no
        # result line
        for phase in NEW_PHASES:
            if phase.__name__[len("phase_"):] in argv[1].split(","):
                phase(device)
        return 1
    k2, k2_f64 = phase_dia(device)
    k1 = phase_stencil(device)
    k3 = phase_chol(device)
    phase_golden(device)
    phase_golden_elasticity(device)
    _, u_jacobi, jacobi = phase_slice(device)
    # the main paths: each path's launches, summed per kernel
    launches, hmm_mg = phase_slice_mg(device, u_jacobi, jacobi)

    def add(counts):
        for key, n in counts.items():
            launches[key] = launches.get(key, 0) + n

    add(phase_slice_default(device, hmm_mg))
    add(phase_golden_stratified(device))
    add(phase_slice_stratified(device))
    add(phase_slice_stratified_full(device))
    counts, beam = phase_slice_elasticity(device)
    add(counts)
    counts, beam_cg = phase_slice_elasticity_cg(device)
    add(counts)
    add(phase_slice_elasticity_dedup(device, beam, beam_cg))
    for phase in NEW_PHASES:
        add(phase(device))
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
        {"name": "dia_spmv_f64", "route": "cuda",
         "source": "hommx_tpu_torch/ops/csrc/dia_spmv.cu",
         "replaces": "hommx_tpu/ops/dia.py:145",
         "launches": launches["dia_spmv_f64"], **{k: k2_f64[k] for k in keys},
         "library_ms": k2_f64["library_ms"]},
        {"name": "stencil_pcg_large", "route": "cuda",
         "source": "hommx_tpu_torch/micro/csrc/stencil_pcg.cu",
         "replaces": "hommx_tpu/micro/stencil_pcg.py:81",
         "launches": launches["stencil_pcg_large"], **{k: K1_LARGE[k] for k in keys},
         "library_ms": None},
        {"name": "chol_solve_large", "route": "cuda",
         "source": "hommx_tpu_torch/ops/csrc/chol_solve.cu",
         "replaces": "hommx_tpu/ops/chol_kernel.py:451",
         "launches": launches["chol_solve_large"], **{k: K3_LARGE[k] for k in keys},
         "library_ms": K3_LARGE["library_ms"]},
    ]
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
