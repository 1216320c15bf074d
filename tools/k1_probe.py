#!/usr/bin/env python3
"""K1 (the fused stencil PCG) under the microscope, on one NVIDIA GPU.

    python3 tools/k1_probe.py [--out FILE]

Run from the repository root on a machine with one CUDA card; it fails
without one.  On the main path's chunk (16² micro mesh, 2048 cells) and on
a 1000-cell chunk of the 8³ mesh it prints one JSON line per measurement:

- ``sweep``: K1 at each of several launch configurations (cells per
  block, threads), against the per-block plain
  version, with its single-call and back-to-back times and, as a
  yardstick for one preconditioner apply, a float32 ``torch.matmul`` of
  Minv by the chunk's (n, s·C) loads (TF32 off);
- ``phases``: an instrumented copy of the kernel (built into
  ``hommx_tpu_torch/_build/``) in which thread 0 of every block counts
  ``clock64`` cycles in the preconditioner products, in the stencil
  matvecs and in all; the median and the maximum over blocks.

With ``--large`` it probes the large instance instead (n above the small
one's reach): on one auto-sized chunk of the 33², 64², 10³ and 16³ micro
meshes, K1 with 2, 3, 4 and 6 ring stages against the per-block plain
version, with its single-call time, the bound and the float32
``torch.matmul`` of Minv by the chunk's loads;
then, from a copy built with ``K1L_PROBE`` (clock64 per CTA), the cycles of
a CTA in the products, its waits for tiles and at grid barriers, the
stencil and the other vector passes and the dots, and the product's
rate beside ``torch.matmul``'s at the same shape.

With ``--out FILE`` all records also go there.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def instrumented_source(src: str) -> str:
    """The kernel source with per-phase cycle counters of thread 0, kept in
    a device array that ``hommx_k1_phases`` copies out."""
    src = src.replace("namespace {\n", "__device__ long long g_phase[8192 * 4];\nnamespace {\n", 1)
    src = src.replace(
        "  float acc[TM][4], x[TM][4];\n",
        "  float acc[TM][4], x[TM][4];\n  long long tg = 0, tm = 0; const long long t0 = clock64();\n",
        1,
    )
    src = re.sub(r"(prec_tile<TM>\(Minv, Rs, Ms, n, NC, rg, RG, j0, \w+\);)",
                 r"{ const long long a = clock64(); \1 tg += clock64() - a; }", src)
    src = re.sub(r"(matvec_tile<TM>\(ws, nbr, Ps, K, n, NC, Cp, col0, rg, RG, j0, acc\);)",
                 r"{ const long long a = clock64(); \1 tm += clock64() - a; }", src)
    src = src.replace(
        "  if (t == 0) iters[blockIdx.x] = k_s;\n",
        "  if (t == 0) { iters[blockIdx.x] = k_s; long long* g = g_phase + blockIdx.x * 4;"
        " g[0] = tg; g[1] = tm; g[2] = clock64() - t0; g[3] = k_s; }\n",
    )
    if src.count("tg += ") != 3 or src.count("tm += ") != 2 or "g[3] = k_s" not in src:
        raise RuntimeError("k1_probe: the kernel source no longer has the phases it instruments")
    return src + (
        '\nextern "C" int hommx_k1_phases(void* dst, void* stream) {\n'
        "  return (int)cudaMemcpyFromSymbolAsync(dst, g_phase, sizeof(g_phase), 0,\n"
        "                                        cudaMemcpyDeviceToDevice, (cudaStream_t)stream);\n"
        "}\n"
    )


def chunk_args(eng, C, rng, device):
    import torch
    from chip_smoke import flagship

    from hommx_tpu_torch.micro.chunk import chunk_system

    centers = torch.as_tensor(rng.uniform(0, 1, (C, eng.d)), dtype=torch.float32, device=device)
    cs = chunk_system(eng, flagship, centers)
    ws_s, Fs = cs.scaled()
    return cs, (ws_s, Fs, cs.Minv, cs.st.shape, cs.st.offsets, eng.pcg_tol, eng.pcg_maxiter)


def sweep(k1, eng, C, args, Minv, variants, keep):
    import torch
    from chip_smoke import time_ms

    n, s = eng.n_reduced, eng.s
    R2 = args[1].reshape(n, s * C).contiguous()
    torch.backends.cuda.matmul.allow_tf32 = False
    lib_us = 1e3 * time_ms(lambda: torch.matmul(Minv, R2), reps=50)
    orig = k1.launch_config
    chosen = orig(n, s)
    try:
        _sweep(k1, n, s, C, args, variants, chosen, lib_us, keep)
    finally:
        k1.launch_config = orig


def _sweep(k1, n, s, C, args, variants, chosen, lib_us, keep):
    from chip_smoke import _loop_us, time_ms

    for cb, threads in variants:
        cg = s * cb // 4
        if threads % cg or (threads // cg) % (32 // k1._warp_cols(cg)):
            continue
        rows = -(-n // (threads // cg))
        tm = 1 << max(0, rows - 1).bit_length()
        if tm > 8 or (tm == 8 and threads > 384):
            continue
        cfg = k1.K1Config(cb, threads, tm, k1._smem_bytes(n, s, cb, threads))
        if cfg.smem_bytes > k1.SMEM_LIMIT:
            continue
        k1.launch_config = lambda n_, s_, c_=0, cfg=cfg: cfg
        Y, its = k1.stencil_pcg_cuda(*args, per_block=True)
        Yp, itp = k1.stencil_pcg_plain(*args, block=cb, per_block=True)
        keep({"tag": "sweep", "n": n, "s": s, "cells": C, **cfg.__dict__,
              "chosen": cfg == chosen,
              "ms": time_ms(lambda: k1.stencil_pcg_cuda(*args), reps=20),
              "loop_ms": _loop_us(lambda: k1.stencil_pcg_cuda(*args), reps=50) / 1e3,
              "iters_max": int(its.max()), "iters_plain_max": max(itp),
              "x_rel_err": float((Y - Yp).abs().max() / Yp.abs().max()),
              "prec_library_us": lib_us})


LARGE_CASES = (("2d33", "square", 33), ("2d64", "square", 64), ("3d10", "cube", 10),
               ("3d16", "cube", 16))


def _large_case(name, kind, m, device, rng):
    """(engine, chunk size, chunk system, args, torch.matmul µs) of one case."""
    import torch
    from chip_smoke import time_ms

    from hommx_tpu_torch import MicroEngine, create_unit_cube, create_unit_square

    mesh = create_unit_square(m, m) if kind == "square" else create_unit_cube(m)
    eng = MicroEngine(mesh, device=device, dtype=torch.float32)
    C = eng._auto_chunk(1 << 20)
    cs, args = chunk_args(eng, C, rng, device)
    R2 = args[1].reshape(eng.n_reduced, eng.s * C).contiguous()
    torch.backends.cuda.matmul.allow_tf32 = False
    lib_us = 1e3 * time_ms(lambda: torch.matmul(cs.Minv, R2), reps=20)
    return eng, C, cs, args, lib_us


def sweep_large(k1, device, keep):
    """The large instance on one auto-sized chunk of each case: its
    launch_config, then 2, 3, 4 and 6 ring stages (``large_candidate``)."""
    import numpy as np
    import torch
    from chip_smoke import K1_RTOL, bound, time_ms

    rng = np.random.default_rng(0)
    orig = k1.launch_config
    try:
        for name, kind, m in LARGE_CASES:
            eng, C, cs, args, lib_us = _large_case(name, kind, m, device, rng)
            n, s, K = eng.n_reduced, eng.s, len(cs.st.offsets)
            chosen = orig(n, s, C)
            variants = [chosen]
            for st in (2, 3, 4, 6):
                cfg = k1.large_candidate(n, s, C, st)
                if cfg not in (None, chosen):
                    variants.append(cfg)
            for cfg in variants:
                k1.launch_config = lambda n_, s_, c_=0, cfg=cfg: cfg
                Y, its = k1.stencil_pcg_cuda(*args, per_block=True)
                its = [int(v) for v in its.cpu()]
                Yp, itp = k1.stencil_pcg_plain(*args, block=cfg.cells_per_block, per_block=True)
                Ak, Ap = cs.astar(eng, Y, max(its)), cs.astar(eng, Yp, max(itp))
                rel = float((Ak - Ap).abs().max() / Ap.abs().max())
                ms = time_ms(lambda: k1.stencil_pcg_cuda(*args), reps=10, warmup=1)
                b = cfg.cells_per_block
                flops = sum(min(b, C - i * b) * ((it + 2) * 2.0 * n * n * s
                                                 + (it + 1) * 2.0 * K * n * s)
                            for i, it in enumerate(its))
                bound_ms, by = bound(flops, 4.0 * (K * n * C + 2 * n * s * C + n * n))
                keep({"tag": "large", "case": name, "n": n, "s": s, "cells": C, **cfg.__dict__,
                      "grid_on_card": k1.large_grid_on_card(cfg),
                      "chosen": cfg == chosen, "ms": ms, "bound_ms": bound_ms, "bound_by": by,
                      "share_of_bound": bound_ms / ms, "iters_max": max(its),
                      "iters_plain_max": max(itp),
                      "iters_max_block_diff": max(abs(a - c) for a, c in zip(its, itp)),
                      "astar_rel_err": rel, "ok": rel < K1_RTOL, "prec_library_us": lib_us})
            del eng, cs, args
            torch.cuda.empty_cache()
    finally:
        k1.launch_config = orig


LARGE_PHASES = ("product", "tile_wait", "grid_wait", "stencil", "update", "dots", "total",
                "stages")


def large_phases(k1, device, keep):
    """The large instance's cycle split per CTA, from a copy built with
    ``K1L_PROBE`` (thread 0's clock64; the median and the maximum over the
    CTAs), at its launch configuration on each case, and the product's
    rate: its FLOPs (ring stages x 2 x 128 x tile_cols x 16) over the
    busiest CTA's product cycles, at the clock that the longest CTA's
    cycles over the launch's time give, beside ``torch.matmul`` of Minv by
    the chunk's loads (TF32 off) at the same shape."""
    import numpy as np
    import torch
    from chip_smoke import time_ms

    from hommx_tpu_torch._cuda import CudaKernel

    rng = np.random.default_rng(0)
    build = ROOT / "hommx_tpu_torch" / "_build" / "k1_large_phases"
    build.mkdir(parents=True, exist_ok=True)
    sig = dict(k1.KERNEL.signatures)
    sig["hommx_k1l_phases"] = [ctypes.c_void_p]
    src = build / "stencil_pcg_probe.cu"
    src.write_text("#define K1L_PROBE\n" + k1.KERNEL.source.read_text())
    kern = CudaKernel(src, sig)
    orig = k1.KERNEL
    try:
        k1.KERNEL = kern
        for name, kind, m in LARGE_CASES:
            eng, C, cs, args, lib_us = _large_case(name, kind, m, device, rng)
            n, s = eng.n_reduced, eng.s
            cfg = k1.launch_config(n, s, C)
            _, its = k1.stencil_pcg_cuda(*args, per_block=True)
            ms = time_ms(lambda: k1.stencil_pcg_cuda(*args), reps=5, warmup=1)
            buf = torch.zeros(8192 * 8, dtype=torch.int64, device=device)
            kern.launch("hommx_k1l_phases", device.index, buf.data_ptr())
            torch.cuda.synchronize()
            grid = min(cfg.grid, k1.large_grid_on_card(cfg))
            ph = buf[: grid * 8].reshape(grid, 8).double()
            hz = float(ph[:, 6].max()) / (ms / 1e3)
            flops = float(ph[:, 7].sum()) * 2.0 * 128 * cfg.tile_cols * 16
            prod_s = float(ph[:, 0].max()) / hz
            applies = int(its.max()) + 2
            keep({"tag": "large_phases", "case": name, "n": n, "s": s, "cells": C,
                  **cfg.__dict__, "grid_launched": grid, "instrumented_ms": ms,
                  "iters_max": int(its.max()), "clock_ghz": hz / 1e9,
                  "ptxas": [ln.strip() for ln in kern.build_log.splitlines()
                            if "registers" in ln or "spill" in ln][-8:],
                  "cycles_median": dict(zip(LARGE_PHASES, ph.median(dim=0).values.tolist())),
                  "cycles_max": dict(zip(LARGE_PHASES, ph.max(dim=0).values.tolist())),
                  "cycles_min": dict(zip(LARGE_PHASES, ph.min(dim=0).values.tolist())),
                  "product_gflop": flops / 1e9, "product_ms": prod_s * 1e3,
                  "product_ms_per_apply": prod_s * 1e3 / applies,
                  "product_tflops": flops / prod_s / 1e12,
                  "matmul_us": lib_us,
                  "matmul_tflops": 2.0 * n * n * s * C / (lib_us / 1e6) / 1e12})
            del eng, cs, args
            torch.cuda.empty_cache()
    finally:
        k1.KERNEL = orig


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--large", action="store_true")
    args_ns = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("k1_probe: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import emit, phase_build, phase_device, time_ms

    from hommx_tpu_torch import MicroEngine, create_unit_cube, create_unit_square
    from hommx_tpu_torch._cuda import CudaKernel
    from hommx_tpu_torch.micro import stencil_pcg as k1

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    records = []

    def keep(rec):
        emit(rec)
        records.append(rec)

    phase_device()
    if args_ns.large:
        phase_build()
        sweep_large(k1, device, keep)
        large_phases(k1, device, keep)
        return _write(records, args_ns.out)
    rng = np.random.default_rng(0)
    cases = (
        (create_unit_square(16, 16), 2048,
         [(16, 512), (16, 256), (8, 512), (8, 256), (4, 256)]),
        (create_unit_cube(8), 1000, [(8, 384), (4, 384), (4, 192)]),
    )
    chunks = []
    for mesh, C, variants in cases:
        eng = MicroEngine(mesh, device=device, dtype=torch.float32)
        cs, args = chunk_args(eng, C, rng, device)
        chunks.append((eng, C, args))
        sweep(k1, eng, C, args, cs.Minv, variants, keep)

    # the phase split, from an instrumented copy of the kernel
    build = ROOT / "hommx_tpu_torch" / "_build" / "k1_phases"
    build.mkdir(parents=True, exist_ok=True)
    src = build / "stencil_pcg.cu"
    src.write_text(instrumented_source(k1.KERNEL.source.read_text()))
    sig = dict(k1.KERNEL.signatures)
    sig["hommx_k1_phases"] = [ctypes.c_void_p]
    k1.KERNEL = CudaKernel(src, sig)
    for eng, C, args in chunks:
        ms = time_ms(lambda: k1.stencil_pcg_cuda(*args), reps=10)
        buf = torch.zeros(8192 * 4, dtype=torch.int64, device=device)
        k1.KERNEL.launch("hommx_k1_phases", device.index, buf.data_ptr())
        torch.cuda.synchronize()
        cfg = k1.launch_config(eng.n_reduced, eng.s)
        nb = -(-C // cfg.cells_per_block)
        ph = buf[: nb * 4].reshape(nb, 4).double()
        med, mx = ph.median(dim=0).values.tolist(), ph.max(dim=0).values.tolist()
        keep({"tag": "phases", "n": eng.n_reduced, "s": eng.s, "cells": C, **cfg.__dict__,
              "instrumented_ms": ms, "iters_median": med[3],
              "cycles_median": {"prec": med[0], "matvec": med[1], "total": med[2]},
              "cycles_max": {"prec": mx[0], "matvec": mx[1], "total": mx[2]}})

    return _write(records, args_ns.out)


def _write(records, out) -> int:
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as fh:
            json.dump(records, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
