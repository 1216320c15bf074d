"""Run one benchmark cell of hommx_tpu_torch on the CUDA card:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It makes the cell's inputs from the seed, builds
the model and warms up the cell's shapes (set-up), measures for ``--seconds``
(the solve in flight at the end is finished and counted), checks what the
timed path produced against the plain reference, and prints one JSON line
last on standard output.  ``--trace 1`` measures the per-layer metrics under
``torch.profiler`` instead of the end-to-end ones.  Without a CUDA card, or
with fewer than the cell asks for, it prints no result and exits 3.
"""

import time


def _process_start() -> float:
    """The process's start on the ``perf_counter`` clock (from its start time
    in /proc, so the interpreter's own start-up counts; the first line of
    this module where /proc is not there)."""
    now = time.perf_counter()
    try:
        import os

        with open(f"/proc/{os.getpid()}/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - ticks / os.sysconf("SC_CLK_TCK")
        return now - max(age, 0.0)
    except (OSError, ValueError, IndexError, AttributeError):
        return now


T_START = _process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # kernel caches at fixed paths inside the checkout (the program builds
    # its CUDA libraries into hommx_tpu_torch/_build/ there by itself)
    cache = ROOT / ".portbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    sys.path.insert(0, str(ROOT))

    import torch

    from portbench.harness import forbidden_modules, load_cell, run_cell

    cell = load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: the cell needs {cell.chips} CUDA card(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), device="cuda:0",
                      t_start=T_START)
    print(f"card {_card_line()}", file=sys.stderr)
    print("solve seconds " + " ".join(f"{t:.4f}" for t in result.pop("solve_seconds")),
          file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the process loaded JAX or the JAX package: {bad}", file=sys.stderr)
        return 4
    checks = result["checks"]
    for name, c in checks.items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
