"""k1_large.roofline_pct: K1's large instance (``stencil_pcg_large_kernel``)
against its bound, in %: the least time the card could take for the window's
launches (``portbench/roofline/stencil_pcg_large.py``, launch by launch,
each block at the iterations it took) over the kernel's device time in the window.

The counts come from the program: while a profiler records,
``hommx_tpu_torch.micro.stencil_pcg`` appends each launch's per-block
iterations to its list ``BLOCK_ITERS``, which this reader drains from the
loaded module.  Nothing where the program keeps no such list, or where its
launches and the trace's disagree."""

import sys

LAUNCHER = "hommx_stencil_pcg_large_f32"


def read(trace):
    log = getattr(sys.modules.get("hommx_tpu_torch.micro.stencil_pcg"), "BLOCK_ITERS", None)
    if log is None:
        return None
    entries = [e for e in log if e["launcher"] == LAUNCHER]
    log.clear()
    launches, seconds = trace.kernel_seconds("stencil_pcg_large_kernel")
    if not entries or launches != len(entries) or seconds <= 0 or trace.peaks is None:
        return None
    import torch

    counts = torch.cat([e["iters"].reshape(-1) for e in entries]).cpu().tolist()
    roof = trace.roofline("stencil_pcg_large")
    bound, at = 0.0, 0
    for e in entries:
        iters = counts[at:at + e["iters"].numel()]
        at += len(iters)
        ops = roof.flops(e["n"], e["s"], e["K"], e["cells"], e["cells_per_block"], iters)
        bound += roof.bound_seconds(ops, roof.bytes_moved(e["n"], e["s"], e["K"], e["cells"]),
                                    trace.peaks)
    return 100.0 * bound / seconds
