#!/usr/bin/env python3
"""K3 (the blocked Cholesky factor+solve) under the microscope, on one NVIDIA GPU.

    python3 tools/k3_probe.py [--large] [--out FILE]

Run from the repository root on a machine with one CUDA card; it fails
without one.  On the beam's first 1080 cells (n = 192, s = 6, the chunk of
``chip_smoke.py`` phase 5 case (a)) and on a well-conditioned random batch
at the small instance's largest n it prints one JSON line per measurement:

- ``time``: the kernel's single-call and back-to-back times, its launch
  configuration and the occupancy query's resident blocks per SM;
- ``phases``: an instrumented copy of the kernel (``K3_PROBE`` defined,
  built into ``hommx_tpu_torch/_build/k3_phases/``) in which thread 0 of
  every block adds up ``clock64`` cycles per phase: loads, diagonal tiles,
  panels, trailing updates, substitutions (both solves), the refinement
  matvec and the output; the median and the maximum over blocks, and the
  instrumented build's time.

With ``--large``, the large instance instead, on the beam's cells on the
6³ cube (n = 648, the 309-cell chunk of a 4320-cell beam) and on the 8³
cube (n = 1536: its 76-cell chunk, and one cell as high_res_micro.py
solves it): ``time`` at every cluster size (1, 2, 4, 8 CTAs a cell) beside
the configured one, and ``phases`` per CTA at the configured cluster: the
first diagonal tile, loading Dinv_p, panel tiles (with their cluster
barrier), trailing products and read-modify-writes (with theirs), staging
the trailing windows, substitutions, the refinement residual and the
output; the median and maximum over rank 0 and over the other ranks.

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
LARGE_PHASES = ("first_diag", "dinv_load", "panel", "trailing", "solve", "residual", "store",
                "staging")
PROBE_CELLS = 2048


def beam_chunk(device, chunk: int = 1080, micro_n: int = 4):
    """(Ks, Fs) of the beam's first ``chunk`` cells on the ``micro_n``³
    cube, as phase 5 cases (a) and (h2)."""
    import torch
    from chip_smoke import BEAM_H, BEAM_L, BEAM_W, _cell_systems, beam_coeff, beam_rotation

    from hommx_tpu_torch import MicroEngine, create_box, create_unit_cube

    eng = MicroEngine(create_unit_cube(micro_n), bs=3, coeff_kind="tensor4",
                      dtype=torch.float32, device=device)
    macro = create_box([[0, 0, 0], [BEAM_L, BEAM_W, BEAM_H]], [20, 6, 6])
    centers = torch.as_tensor(macro.vertices[macro.cells].mean(axis=1)[:chunk],
                              dtype=torch.float32, device=device)
    Ks, Fs, _ = _cell_systems(eng, beam_coeff(False), centers, beam_rotation)
    return Ks, Fs


def _instrumented(k3):
    """Swap ``k3.KERNEL`` for a copy of the source built with ``K3_PROBE``
    defined (into ``_build/k3_phases/``), with the launcher that copies the
    cycle counts out."""
    from hommx_tpu_torch._cuda import CudaKernel

    build = ROOT / "hommx_tpu_torch" / "_build" / "k3_phases"
    build.mkdir(parents=True, exist_ok=True)
    src = build / "chol_solve.cu"
    src.write_text(f"#define K3_PROBE\n#define K3_PROBE_CELLS {PROBE_CELLS}\n"
                   + k3.KERNEL.source.read_text())
    sig = dict(k3.KERNEL.signatures)
    sig["hommx_k3_phases"] = [ctypes.c_void_p]
    k3.KERNEL = CudaKernel(src, sig)


def probe_small(device, keep) -> None:
    """The small instance's times and its phases per block (see the
    module's docstring), each record through ``keep``."""
    import torch
    from chip_smoke import _loop_us, _spd_batch, time_ms

    from hommx_tpu_torch.ops import chol_kernel as k3

    s = 6
    n_max = k3.max_small_n(s)
    cases = [("a_beam_C1080", *beam_chunk(device)),
             (f"spd_C1080_n{n_max}", *_spd_batch(device, 1080, n_max, s, 9))]
    for name, Ks, Fs in cases:
        cfg = k3.chol_launch_config(Ks.shape[1], s)
        keep({"tag": "time", "case": name, "n": Ks.shape[1], "s": s, "cells": Ks.shape[0],
              **cfg.__dict__, "blocks_per_sm_query": k3.blocks_per_sm(cfg),
              "ms": time_ms(lambda: k3.fused_chol_solve_cuda(Ks, Fs), reps=20),
              "loop_ms": _loop_us(lambda: k3.fused_chol_solve_cuda(Ks, Fs), reps=20) / 1e3})

    # the phase split, from an instrumented copy of the kernel
    _instrumented(k3)
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


def probe_large(device, keep) -> None:
    """The large instance's times at every cluster size and its phases per
    CTA (see the module's docstring), each record through ``keep``."""
    import dataclasses

    import torch
    from chip_smoke import time_ms

    from hommx_tpu_torch.ops import chol_kernel as k3

    s = 6
    cases = [("beam_cube6_C309", *beam_chunk(device, 309, 6)),
             ("beam_cube8_C76", *beam_chunk(device, 76, 8))]
    cases.append(("beam_cube8_C1", cases[1][1][:1].contiguous(),
                  cases[1][2][:, :, :1].contiguous()))
    configured = k3.chol_launch_config
    for name, Ks, Fs in cases:
        C, n = Ks.shape[0], Ks.shape[1]
        base = configured(n, s, C)
        for cs in (1, 2, 4, 8):
            k3.chol_launch_config = lambda n_, s_, c_=0, cs=cs: dataclasses.replace(
                configured(n_, s_, c_), cluster=cs)
            try:
                keep({"tag": "time", "case": name, "n": n, "s": s, "cells": C, "cluster": cs,
                      "configured": cs == base.cluster, "ms": time_ms(
                          lambda: k3.fused_chol_solve_cuda(Ks, Fs), reps=10),
                      "occupancy": list(k3.large_occupancy(dataclasses.replace(base,
                                                                                cluster=cs)))})
            finally:
                k3.chol_launch_config = configured
    _instrumented(k3)
    for name, Ks, Fs in cases:
        C, n = Ks.shape[0], Ks.shape[1]
        cfg = k3.chol_launch_config(n, s, C)
        ctas = min(C * cfg.cluster, PROBE_CELLS)
        ms = time_ms(lambda: k3.fused_chol_solve_cuda(Ks, Fs), reps=5)
        buf = torch.zeros(PROBE_CELLS * 8, dtype=torch.int64, device=device)
        k3.KERNEL.launch("hommx_k3_phases", device.index, buf.data_ptr())
        torch.cuda.synchronize()
        ph = buf[: ctas * 8].reshape(ctas, 8).double()
        rank0 = torch.arange(ctas, device=device) % cfg.cluster == 0
        rec = {"tag": "phases", "case": name, "n": n, "cells": C, "cluster": cfg.cluster,
               "ctas": ctas, "instrumented_ms": ms}
        for label, sel in (("rank0", rank0), ("others", ~rank0)):
            if bool(sel.any()):
                p = ph[sel]
                rec[f"{label}_cycles_median"] = dict(zip(LARGE_PHASES,
                                                         p.median(dim=0).values.tolist()))
                rec[f"{label}_cycles_max"] = dict(zip(LARGE_PHASES, p.max(dim=0).values.tolist()))
                rec[f"{label}_total_median"] = float(p.sum(dim=1).median())
        keep(rec)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--large", action="store_true", help="the large instance")
    ap.add_argument("--out", default=None)
    args_ns = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("k3_probe: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import emit, phase_device

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    records = []

    def keep(rec):
        emit(rec)
        records.append(rec)

    phase_device()
    (probe_large if args_ns.large else probe_small)(device, keep)
    if args_ns.out:
        os.makedirs(os.path.dirname(os.path.abspath(args_ns.out)), exist_ok=True)
        with open(args_ns.out, "w") as fh:
            json.dump(records, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
