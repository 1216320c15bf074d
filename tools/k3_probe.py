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

With ``--large``, the large instance instead, at the four shapes of
``chip_smoke.py`` phase 5 (h2): the beam's cells on the 5³, 6³ and 8³
cubes (n = 375, 648, 1536: the 720-, 309- and 76-cell chunks of a
4320-cell beam) and the 2D inclusion's on the 16² square (n = 512, s = 3,
683 cells), and one 8³ cell as high_res_micro.py solves it: ``time`` at
every cluster size (1, 2, 4, 8 CTAs a cell) and, where the configuration
has clusters whose CTAs solve a cell each (``apart``), at each cluster size
that fits such a last wave, and
``phases`` per CTA at the configured cluster and ``apart`` from an
instrumented copy
(``_build/k3_phases/``, ``hommx_k3_large_phases``): clock64 cycles in the
strip's diagonal block, the strip's rows (solve and store) and their
loads, the trailing products, the trailing read-modify-writes, the
staging waits, the cluster barriers, the substitutions, the refinement
residual and the output, the median and maximum over rank 0 and over the
other ranks; the trailing product's TFLOP/s (a CTA's share of the useful
trailing FLOP over its product cycles, and that rate on every resident
slot); and each CTA's start and end on ``%globaltimer``, from which the
span, the time after which fewer than half the resident slots still run
(``tail_share``: the last wave running alone) and the last start.

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
LARGE_PHASES = ("strip_diag", "strip_rows", "product", "rmw", "solve", "residual", "store",
                "staging_wait", "cluster_barrier", "strip_row_loads")
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
    sig["hommx_k3_large_phases"] = [ctypes.c_void_p]
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


def square_chunk(device, chunk: int = 683, micro_n: int = 16):
    """(Ks, Fs) of ``chunk`` cells of the 2D inclusion on the ``micro_n``²
    square, as phase 5 case (h2) builds them."""
    import numpy as np
    import torch
    from chip_smoke import _cell_systems, inclusion_mu

    from hommx_tpu_torch import MicroEngine, create_unit_square
    from hommx_tpu_torch.utils.validation import hooke_tensor

    eng = MicroEngine(create_unit_square(micro_n), bs=2, coeff_kind="tensor4",
                      dtype=torch.float32, device=device)
    rng = np.random.default_rng(21)
    centers = torch.as_tensor(rng.uniform(0, 1, (chunk, 2)), dtype=torch.float32, device=device)
    Ks, Fs, _ = _cell_systems(eng, hooke_tensor(2, inclusion_mu, lambda x, y: 1.0), centers)
    return Ks, Fs


def _trailing_flops(n: int) -> float:
    """FLOP of one cell's trailing products as the large instance runs them
    (useful tiles only): 2 · 32 · 32 · 128 a trailing tile an outer panel."""
    from hommx_tpu_torch.ops import chol_kernel as k3

    P, W = -(-n // k3.NB), k3.OUTER
    tiles = sum((P - p0 - W) * (P - p0 - W + 1) // 2 for p0 in range(0, P - W, W))
    return tiles * 2.0 * k3.NB * k3.NB * k3.NB * W


def _tail(start, end, slots: int) -> dict:
    """From the CTAs' start and end times (ns): the kernel's span, and the
    time after which fewer than half of ``slots`` CTAs still run, as a
    share of the span (the last wave running alone)."""
    import numpy as np

    t0 = float(start.min())
    events = sorted([(float(s) - t0, 1) for s in start] + [(float(e) - t0, -1) for e in end])
    span = events[-1][0]
    running, thin_from = 0, None
    for t, d in events:  # thin_from: the last drop below half the slots
        running += d
        if running >= slots / 2:
            thin_from = None
        elif thin_from is None:
            thin_from = t
    thin_from = span if thin_from is None else thin_from
    ends = np.sort(np.asarray(end, dtype=float) - t0)
    return {"span_us": span / 1e3, "tail_under_half_us": (span - thin_from) / 1e3,
            "tail_share": (span - thin_from) / span if span else 0.0,
            "last_start_us": (float(start.max()) - t0) / 1e3,
            "end_p50_us": float(np.median(ends)) / 1e3}


def probe_large(device, keep) -> None:
    """The large instance's times at every cluster size and its phases per
    CTA (see the module's docstring), each record through ``keep``."""
    import dataclasses

    import torch
    from chip_smoke import time_ms

    from hommx_tpu_torch.ops import chol_kernel as k3

    cases = [("beam_cube5_C720", *beam_chunk(device, 720, 5)),
             ("beam_cube6_C309", *beam_chunk(device, 309, 6)),
             ("beam_cube8_C76", *beam_chunk(device, 76, 8)),
             ("square16_C683", *square_chunk(device))]
    cases.append(("beam_cube8_C1", cases[2][1][:1].contiguous(),
                  cases[2][2][:, :, :1].contiguous()))
    configured = k3.chol_launch_config
    for name, Ks, Fs in cases:
        C, n, s = Ks.shape[0], Ks.shape[1], Fs.shape[1]
        base = configured(n, s, C)
        variants = [(cs, 0) for cs in (1, 2, 4, 8)]
        if base.apart:  # the same full waves, the last wave on 2, 4, 8 CTAs a cell
            last = C - base.apart * base.cluster
            variants += [(cs, (C - last) // cs) for cs in (2, 4, 8)
                         if (C - last) % cs == 0 and last * cs <= k3.SMS * base.blocks_per_sm]
        for cs, apart in variants:
            cfg = dataclasses.replace(base, cluster=cs, apart=apart)
            k3.chol_launch_config = lambda n_, s_, c_=0, cfg=cfg: cfg
            try:
                keep({"tag": "time", "case": name, "n": n, "s": s, "cells": C, "cluster": cs,
                      "apart": apart, "configured": (cs, apart) == (base.cluster, base.apart),
                      "ms": time_ms(lambda: k3.fused_chol_solve_cuda(Ks, Fs), reps=10),
                      "occupancy": list(k3.large_occupancy(cfg))})
            finally:
                k3.chol_launch_config = configured
    _instrumented(k3)
    for name, Ks, Fs in cases:
        C, n, s = Ks.shape[0], Ks.shape[1], Fs.shape[1]
        cfg = k3.chol_launch_config(n, s, C)
        ctas = C + (C - cfg.apart * cfg.cluster) * (cfg.cluster - 1)
        if ctas > PROBE_CELLS:
            raise RuntimeError(f"k3_probe: {ctas} CTAs, the probe records {PROBE_CELLS}")
        ms = time_ms(lambda: k3.fused_chol_solve_cuda(Ks, Fs), reps=5)
        buf = torch.zeros(PROBE_CELLS * 12, dtype=torch.int64, device=device)
        k3.KERNEL.launch("hommx_k3_large_phases", device.index, buf.data_ptr())
        torch.cuda.synchronize()
        rec_all = buf[: ctas * 12].reshape(ctas, 12).cpu()
        ph = rec_all[:, :10].double()
        start, end = rec_all[:, 10], rec_all[:, 11]
        slots = min(ctas, k3.large_occupancy(cfg)[0] * k3.SMS)
        # cycles a ns from each CTA's own count over its wall time
        ghz = float((ph.sum(dim=1) / (end - start).double()).median())
        # the CTAs of an ``apart`` cluster each solve a cell: all are rank 0
        rank0 = ((torch.arange(ctas) < cfg.apart * cfg.cluster)
                 | (torch.arange(ctas) % cfg.cluster == 0))
        rec = {"tag": "phases", "case": name, "n": n, "cells": C, "cluster": cfg.cluster,
               "apart": cfg.apart, "ctas": ctas, "resident_slots": slots, "instrumented_ms": ms,
               "clock_ghz": ghz, **_tail(start, end, slots)}
        for label, sel in (("rank0", rank0), ("others", ~rank0)):
            if bool(sel.any()):
                p = ph[sel]
                rec[f"{label}_cycles_median"] = dict(zip(LARGE_PHASES,
                                                         p.median(dim=0).values.tolist()))
                rec[f"{label}_cycles_max"] = dict(zip(LARGE_PHASES, p.max(dim=0).values.tolist()))
                rec[f"{label}_total_median"] = float(p.sum(dim=1).median())
        # the trailing product's rate: one CTA's share of a cell's trailing
        # FLOP over its product cycles, and that rate on every resident slot
        prod_s = float(ph[:, LARGE_PHASES.index("product")].median()) / (ghz * 1e9)
        share = 1 if 2 * cfg.apart * cfg.cluster >= C else cfg.cluster  # CTAs a cell, mostly
        per_cta = _trailing_flops(n) / share / prod_s if prod_s else 0.0
        rec.update({"product_tflops_per_cta": per_cta / 1e12,
                    "product_tflops_card": per_cta * min(slots, ctas) / 1e12})
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
