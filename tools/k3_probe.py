#!/usr/bin/env python3
"""K3 (the blocked Cholesky factor+solve) under the microscope, on one NVIDIA GPU.

    python3 tools/k3_probe.py [--out FILE]

Run from the repository root on a machine with one CUDA card; it fails
without one.  On the beam's first 1080 cells (n = 192, s = 6, the chunk of
``chip_smoke.py`` phase 5 case (a)) and on a well-conditioned random batch
at the kernel's largest n it prints one JSON line per measurement:

- ``time``: the kernel's single-call and back-to-back times, its launch
  configuration and the occupancy query's resident blocks per SM;
- ``phases``: an instrumented copy of the kernel (``K3_PROBE`` defined,
  built into ``hommx_tpu_torch/_build/k3_phases/``) in which thread 0 of
  every block adds up ``clock64`` cycles per phase: loads, diagonal tiles,
  panels, trailing updates, substitutions (both solves), the refinement
  matvec and the output; the median and the maximum over blocks, and the
  instrumented build's time.

With ``--out FILE`` all records also go there.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PHASES = ("load", "diag", "panel", "update", "solve", "matvec", "store")
PROBE_CELLS = 2048


def beam_chunk(device, chunk: int = 1080):
    """(Ks, Fs) of the beam's first ``chunk`` cells, as phase 5 case (a)."""
    import torch
    from chip_smoke import BEAM_H, BEAM_L, BEAM_W, _cell_systems, beam_coeff, beam_rotation

    from hommx_tpu_torch import MicroEngine, create_box, create_unit_cube

    eng = MicroEngine(create_unit_cube(4), bs=3, coeff_kind="tensor4", dtype=torch.float32,
                      device=device)
    macro = create_box([[0, 0, 0], [BEAM_L, BEAM_W, BEAM_H]], [20, 6, 6])
    centers = torch.as_tensor(macro.vertices[macro.cells].mean(axis=1)[:chunk],
                              dtype=torch.float32, device=device)
    Ks, Fs, _ = _cell_systems(eng, beam_coeff(False), centers, beam_rotation)
    return Ks, Fs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args_ns = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("k3_probe: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import _loop_us, _spd_batch, emit, phase_device, time_ms

    from hommx_tpu_torch._cuda import CudaKernel
    from hommx_tpu_torch.ops import chol_kernel as k3

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    records = []

    def keep(rec):
        emit(rec)
        records.append(rec)

    phase_device()
    s = 6
    n_max = k3.max_kernel_n(s)
    cases = [("a_beam_C1080", *beam_chunk(device)),
             (f"spd_C1080_n{n_max}", *_spd_batch(device, 1080, n_max, s, 9))]
    for name, Ks, Fs in cases:
        cfg = k3.chol_launch_config(Ks.shape[1], s)
        keep({"tag": "time", "case": name, "n": Ks.shape[1], "s": s, "cells": Ks.shape[0],
              **cfg.__dict__, "blocks_per_sm_query": k3.blocks_per_sm(cfg),
              "ms": time_ms(lambda: k3.fused_chol_solve_cuda(Ks, Fs), reps=20),
              "loop_ms": _loop_us(lambda: k3.fused_chol_solve_cuda(Ks, Fs), reps=20) / 1e3})

    # the phase split, from an instrumented copy of the kernel
    build = ROOT / "hommx_tpu_torch" / "_build" / "k3_phases"
    build.mkdir(parents=True, exist_ok=True)
    src = build / "chol_solve.cu"
    src.write_text(f"#define K3_PROBE\n#define K3_PROBE_CELLS {PROBE_CELLS}\n"
                   + k3.KERNEL.source.read_text())
    sig = dict(k3.KERNEL.signatures)
    sig["hommx_k3_phases"] = [ctypes.c_void_p]
    k3.KERNEL = CudaKernel(src, sig)
    for name, Ks, Fs in cases:
        C = min(Ks.shape[0], PROBE_CELLS)
        ms = time_ms(lambda: k3.fused_chol_solve_cuda(Ks, Fs), reps=10)
        buf = torch.zeros(PROBE_CELLS * 8, dtype=torch.int64, device=device)
        k3.KERNEL.launch("hommx_k3_phases", device.index, buf.data_ptr())
        torch.cuda.synchronize()
        ph = buf[: C * 8].reshape(C, 8)[:, : len(PHASES)].double()
        med, mx = ph.median(dim=0).values.tolist(), ph.max(dim=0).values.tolist()
        total = ph.sum(dim=1)
        keep({"tag": "phases", "case": name, "cells": C, "instrumented_ms": ms,
              "cycles_median": dict(zip(PHASES, med)), "cycles_max": dict(zip(PHASES, mx)),
              "total_median": float(total.median()), "total_max": float(total.max())})

    if args_ns.out:
        os.makedirs(os.path.dirname(os.path.abspath(args_ns.out)), exist_ok=True)
        with open(args_ns.out, "w") as fh:
            json.dump(records, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
