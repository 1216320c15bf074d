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
        k1.launch_config = lambda n_, s_, cfg=cfg: cfg
        Y, its = k1.stencil_pcg_cuda(*args, per_block=True)
        Yp, itp = k1.stencil_pcg_plain(*args, block=cb, per_block=True)
        keep({"tag": "sweep", "n": n, "s": s, "cells": C, **cfg.__dict__,
              "chosen": cfg == chosen,
              "ms": time_ms(lambda: k1.stencil_pcg_cuda(*args), reps=20),
              "loop_ms": _loop_us(lambda: k1.stencil_pcg_cuda(*args), reps=50) / 1e3,
              "iters_max": int(its.max()), "iters_plain_max": max(itp),
              "x_rel_err": float((Y - Yp).abs().max() / Yp.abs().max()),
              "prec_library_us": lib_us})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args_ns = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("k1_probe: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import emit, phase_device, time_ms

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

    if args_ns.out:
        os.makedirs(os.path.dirname(os.path.abspath(args_ns.out)), exist_ok=True)
        with open(args_ns.out, "w") as fh:
            json.dump(records, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
