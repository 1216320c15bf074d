"""The benchmark's run of one cell: inputs from the seed, set-up, the timed
window, the traced window's per-layer metrics, the check against the plain
reference, and the result line.

Everything that belongs to one configuration, traffic mix or metric is found
by its name in ``BENCHMARK.json``:

- the configuration ``portbench/configs/<config>.json``, whose ``family``
  names the program's builder ``portbench/families/<family>.py`` and the
  plain reference ``portbench/reference/<family>.py``;
- the traffic ``portbench/traffic/<traffic>.json``, whose ``kind`` names
  the module ``portbench/traffic/<kind>.py`` that makes its inputs from the
  seed, runs one solve of the window and gives the kind's own end-to-end
  values; a traffic file with a key its kind does not honour is refused;
- each per-layer metric's reader ``portbench/metrics/<metric>.py``.

The harness itself gives ``setup_s`` and ``peak_mem_gib``; a cell that asks
for an end-to-end metric that neither it nor the traffic kind gives is
refused.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np

__all__ = ["load_cell", "load_module", "run_cell", "forbidden_modules", "Cell"]

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
#: solves whose u and A* a run keeps for the check (the most recent)
RING = 16
#: the most solves one run can hold (the input sequence's length)
MAX_SOLVES = 1 << 16
#: warm-up solves at the cell's shapes in set-up (on an H100, the first
#: window solve after a single one ran up to 18% slower than the rest)
WARMUP = 2
FORBIDDEN = ("jax", "jaxlib", "flax", "hommx_tpu")


class Cell:
    """One entry of ``workloads`` with its configuration, traffic and the
    per-layer metrics that name it."""

    def __init__(self, spec: dict, name: str, root: Path = ROOT):
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.root = Path(root)
        self.entry = cells[name]
        configs = {c["name"]: c for c in spec["configs"]}
        self.config = json.loads((root / configs[self.entry["config"]]["file"]).read_text())
        traffic = self.root / "portbench" / "traffic" / f"{self.entry['traffic']}.json"
        self.traffic = json.loads(traffic.read_text())
        self.kind = load_module("traffic", self.traffic["kind"], self.root)
        extra = sorted(set(self.traffic) - set(self.kind.FIELDS))
        if extra:
            raise ValueError(f"traffic {self.entry['traffic']!r}: keys {extra} are not honoured "
                             f"by its kind {self.traffic['kind']!r}")
        self.chips = int(self.entry["chips"])
        self.end_to_end = [m for m in spec["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in spec["per_layer"] if name in m.get("workloads", [name])]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    return Cell(json.loads((root / "BENCHMARK.json").read_text()), name, root)


def load_module(folder: str, name: str, root: Path = ROOT):
    """The module ``portbench/<folder>/<name>.py``, loaded from its file."""
    path = Path(root) / "portbench" / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_{folder}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(metric: str, root: Path = ROOT):
    """The ``read(trace)`` of ``portbench/metrics/<metric>.py``."""
    return load_module("metrics", metric, root).read


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda", t_start=None,
             wrap_step=None) -> dict:
    """Run ``cell`` for ``seconds`` and return the result line's object
    (without printing it).  ``wrap_step(step) -> step`` replaces the
    model's step (the fault tests break it underneath)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    cfg, traffic, kind = cell.config, cell.traffic, cell.kind
    family = importlib.import_module(f"portbench.families.{cfg['family']}")
    from portbench.families.common import AstarProbe

    # set-up: inputs from the seed, the model, the warm-up solves at the
    # cell's shapes, the window's buffers
    theta = torch.zeros((), dtype=torch.float64, device=device)
    values = kind.params(traffic, seed, MAX_SOLVES, device, WARMUP)
    system = family.build(cfg, device, theta)
    if wrap_step is not None:
        system.step = wrap_step(system.step)
    probe = AstarProbe()
    checksums = torch.full((MAX_SOLVES,), float("nan"), dtype=torch.float64, device=device)
    with torch.no_grad():
        for j in range(WARMUP):
            u = kind.solve(system, theta, values, j)
            a = probe.last
            if j == 0:
                ring_u = torch.empty((RING, *u.shape), dtype=u.dtype, device=device)
                ring_a = torch.empty((RING, *a.shape), dtype=a.dtype, device=device)
            ring_u[j % RING].copy_(u)
            ring_a[j % RING].copy_(a)
            checksums[j] = torch.sum(u, dtype=torch.float64)
    _sync(device)
    del u, a
    launches0, iters0 = system.launches(), len(system.macro_iterations())
    if device.type == "cuda":
        peak_setup = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start

    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.__enter__()
        window_mark = record_function("portbench.window")
        window_mark.__enter__()
    # the window: a closed loop of fresh solves, each ending in a sync; the
    # solve in flight when the time is up is finished and counted
    k = 0  # window solves completed; solve j = WARMUP + k is next
    t0 = time.perf_counter()
    ends = []
    with torch.no_grad():
        while True:
            j = WARMUP + k
            u = kind.solve(system, theta, values, j)
            ring_u[j % RING].copy_(u)
            ring_a[j % RING].copy_(probe.last)
            checksums[j] = torch.sum(u, dtype=torch.float64)
            _sync(device)
            k += 1
            ends.append(time.perf_counter())
            if ends[-1] - t0 >= seconds or j + 2 >= MAX_SOLVES:
                break
    last = WARMUP + k  # solves run, the warm-up's included
    window_s = ends[-1] - t0
    del u
    probe.last = None
    if trace:
        window_mark.__exit__(None, None, None)
        prof.__exit__(None, None, None)
    launches = {key: (v - launches0[key]) / k for key, v in system.launches().items()}
    iters = system.macro_iterations()[iters0:]

    card = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    dev_info = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": card,
                "count": cell.chips}
    window_peak = 0
    if device.type == "cuda":
        window_peak = torch.cuda.max_memory_allocated(device)
        dev_info["memory_peak_bytes"] = int(max(window_peak, peak_setup))

    metrics = {}
    result = {}
    if trace:
        from portbench.trace import from_profiler

        tr = from_profiler(prof, k, window_s, {"macro_iterations": iters, "launches": launches},
                           cfg["work"], card)
        del prof
        dev_info["busy_s"] = tr.busy_s
        dev_info["window_s"] = window_s
        for m in cell.per_layer:
            value = load_reader(m["name"], cell.root)(tr)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["breakdown"] = tr.breakdown()
        del tr
    else:
        e2e = {"setup_s": setup_s, **kind.end_to_end(window_s, k)}
        if device.type == "cuda":
            e2e["peak_mem_gib"] = window_peak / 2**30
        for m in cell.end_to_end:
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
            elif m["name"] != "peak_mem_gib" or device.type == "cuda":
                raise KeyError(f"no value for the end-to-end metric {m['name']!r}: neither the "
                               f"harness nor the traffic kind {traffic['kind']!r} gives it")

    # the check: the program's state freed first, then the plain reference
    # on a sample drawn from the seed of the solves still held
    probe.remove()
    params_host = values[:last].cpu().numpy()
    mesh = system.macro_mesh()
    chunks = max(1, round(launches.get(system.chunk_launcher, 0.0)))
    sums = checksums[:last].cpu().numpy()
    del system, values, checksums, theta
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    from portbench.check import check

    held = list(range(max(WARMUP, last - RING), last))  # window solves in the ring
    checks = check(cfg, seed, held, params_host, lambda j: (ring_u[j % RING], ring_a[j % RING]),
                   device, program_mesh=mesh, chunks=chunks)
    failed = int(np.sum(~np.isfinite(sums[WARMUP:])))
    repeats = int(np.sum(sums[1:] == sums[:-1]))  # the warm-up's answer included
    checks["repeated_checksums"] = {"value": repeats, "limit": 0}
    correct = failed == 0 and all(c["value"] is not None and c["value"] <= c["limit"]
                                  for c in checks.values())
    result = {"correct": bool(correct), "attempted": k, "failed": failed, "metrics": metrics,
              "device": dev_info, **result,
              "routes": {"launches_per_solve": launches, "chunks_sampled": chunks,
                         "macro_iterations": iters[:8]},
              "solve_seconds": np.diff([t0] + ends).tolist()}
    result["checks"] = checks
    return result
