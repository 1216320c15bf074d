"""The benchmark's runs at a tiny size on the CPU: the result line's keys,
the failure without a card or without the program, and a configuration,
traffic and per-layer metric added as new files found by their names."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from portbench._tiny import tiny_cell
from portbench.harness import ROOT, run_cell

CELLS = ["poisson_cells64.sweep", "beam_cells8.sweep"]
SEED = 2**31 + 4321  # more than 32 signed bits hold


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_at_tiny_size(name, trace):
    cell = tiny_cell(name)
    r = run_cell(cell, SEED, 0.3, bool(trace), device="cpu")
    assert list(r)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(r)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert r["device"]["platform"] == "cpu" and r["device"]["count"] == 1
    assert all(c["value"] <= c["limit"] for c in r["checks"].values())
    if trace:
        assert "breakdown" in r and r["device"]["window_s"] > 0
    else:
        assert {"solve_s", "setup_s"} <= set(r["metrics"])
        assert r["metrics"]["setup_s"]["value"] > 0 and r["metrics"]["solve_s"]["value"] > 0


def test_same_seed_same_inputs():
    """The same seed gives the same θ; every cycle of the window takes each
    stratum of [low, high] once, near its centre; no θ comes twice."""
    cell = tiny_cell(CELLS[0])
    traffic, params = cell.traffic, cell.kind.params
    a, b = params(traffic, SEED, 64, "cpu", 2), params(traffic, SEED, 64, "cpu", 2)
    c = params(traffic, SEED + 1, 64, "cpu", 2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    lo, hi, m = traffic["low"], traffic["high"], traffic["cycle"]
    assert float(a.min()) >= lo and float(a.max()) <= hi
    assert len(set(a.tolist())) == 64
    width = (hi - lo) / m
    for w in (a, c):
        for cyc in w[2:2 + m * ((64 - 2) // m)].reshape(-1, m):
            pos = (cyc - lo) / width
            assert sorted(pos.floor().long().tolist()) == list(range(m))
            assert float((pos - pos.floor() - 0.5).abs().max()) <= traffic["jitter"] / 2 + 1e-12


def _run_cli(cwd, env=None):
    return subprocess.run([sys.executable, "-m", "portbench.run", "--workload", CELLS[0],
                           "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=300,
                          env={**os.environ, **(env or {})})


def test_no_card_fails_without_result():
    res = _run_cli(ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "CUDA card" in res.stderr


def test_fails_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and portbench/, the run
    (on the CPU, past the look for a card) fails: the program is missing."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; from portbench._tiny import tiny_cell; "
            "from portbench.harness import run_cell; "
            f"run_cell(tiny_cell({CELLS[0]!r}), 1, 0.1, False, device='cpu')")
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300, env={**os.environ, "PYTHONPATH": str(tmp_path)})
    assert res.returncode != 0
    assert "hommx_tpu_torch" in res.stderr
    assert _run_cli(tmp_path).returncode != 0


DUMMY_KIND = """
from portbench.harness import load_module

_sweep = load_module("traffic", "closed_loop_sweep")
FIELDS = _sweep.FIELDS | {"note"}
params, solve = _sweep.params, _sweep.solve


def end_to_end(window_s, solves):
    return {**_sweep.end_to_end(window_s, solves), "solves_per_s": solves / window_s}
"""


def _dummy_tree(tmp_path):
    """A copy of BENCHMARK.json with a dummy configuration, traffic mix,
    traffic kind and per-layer metric, each a new file."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    pb = tmp_path / "portbench"
    for sub in ("configs", "traffic", "metrics"):
        (pb / sub).mkdir(parents=True)
    cfg = json.loads((ROOT / "portbench" / "configs" / "poisson_cells64.json").read_text())
    cfg.update(name="dummy_cfg", macro_cells_per_axis=4, micro_cells_per_axis=4)
    (pb / "configs" / "dummy_cfg.json").write_text(json.dumps(cfg))
    traffic = json.loads((ROOT / "portbench" / "traffic" / "sweep.json").read_text())
    (pb / "traffic" / "dummy_sweep.json").write_text(json.dumps({**traffic, "low": 0.9,
                                                                 "high": 1.1}))
    for kind in (ROOT / "portbench" / "traffic").glob("*.py"):
        shutil.copy(kind, pb / "traffic")
    (pb / "traffic" / "dummy_kind.py").write_text(DUMMY_KIND)
    (pb / "traffic" / "dummy_kinded.json").write_text(json.dumps(
        {**traffic, "kind": "dummy_kind", "note": "a key the new kind honours"}))
    (pb / "metrics" / "dummy.solves_seen.py").write_text(
        "def read(trace):\n    return float(trace.solves)\n")
    return spec, pb


def test_new_files_are_found_by_name(tmp_path):
    """A configuration, a traffic mix, a traffic kind with an end-to-end
    metric of its own, and a per-layer metric added as new files, and named
    in BENCHMARK.json, run without a change to the harness."""
    spec, pb = _dummy_tree(tmp_path)
    spec["configs"].append({"name": "dummy_cfg", "source": "https://example.org",
                            "file": "portbench/configs/dummy_cfg.json", "reduced": [],
                            "why": "test"})
    spec["workloads"].append({"name": "dummy_cfg.dummy_sweep", "config": "dummy_cfg",
                              "traffic": "dummy_sweep", "chips": 1, "why": "test"})
    spec["workloads"].append({"name": "dummy_cfg.dummy_kinded", "config": "dummy_cfg",
                              "traffic": "dummy_kinded", "chips": 1, "why": "test"})
    spec["end_to_end"].append({"name": "solves_per_s", "unit": "1/s", "better": "higher",
                               "bound": 0.05, "source": "host_clock",
                               "workloads": ["dummy_cfg.dummy_kinded"]})
    spec["per_layer"].append({"name": "dummy.solves_seen", "unit": "solves", "better": "higher",
                              "source": "program_counter", "layer": "test", "moves": "solve_s",
                              "workloads": ["dummy_cfg.dummy_sweep"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    from portbench.harness import load_cell

    cell = load_cell("dummy_cfg.dummy_sweep", tmp_path)
    assert cell.traffic["low"] == 0.9 and cell.config["micro_cells_per_axis"] == 4
    r = run_cell(cell, SEED, 0.2, True, device="cpu")
    assert r["correct"] is True
    assert r["metrics"]["dummy.solves_seen"]["value"] == r["attempted"]
    r = run_cell(load_cell("dummy_cfg.dummy_kinded", tmp_path), SEED, 0.2, False, device="cpu")
    assert r["correct"] is True
    assert r["metrics"]["solves_per_s"]["value"] > 0 and "solve_s" in r["metrics"]


def test_unhonoured_traffic_key_is_refused(tmp_path):
    """A traffic file with a key its kind does not honour is refused when
    the cell is loaded, not run with the key ignored."""
    spec, pb = _dummy_tree(tmp_path)
    traffic = json.loads((pb / "traffic" / "dummy_sweep.json").read_text())
    (pb / "traffic" / "dummy_sweep.json").write_text(json.dumps({**traffic, "clients": 2}))
    spec["configs"].append({"name": "dummy_cfg", "source": "https://example.org",
                            "file": "portbench/configs/dummy_cfg.json", "reduced": [],
                            "why": "test"})
    spec["workloads"].append({"name": "dummy_cfg.dummy_sweep", "config": "dummy_cfg",
                              "traffic": "dummy_sweep", "chips": 1, "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    from portbench.harness import load_cell

    with pytest.raises(ValueError, match="clients"):
        load_cell("dummy_cfg.dummy_sweep", tmp_path)


def test_end_to_end_metric_without_a_value_is_refused():
    """A cell that asks for an end-to-end metric that neither the harness nor
    its traffic kind gives fails, instead of printing a line without it."""
    cell = tiny_cell(CELLS[0])
    cell.end_to_end = cell.end_to_end + [{"name": "grad_s", "unit": "s"}]
    with pytest.raises(KeyError, match="grad_s"):
        run_cell(cell, SEED, 0.1, False, device="cpu")
