"""The check that decides ``correct``, on the CPU at a tiny size: the plain
reference agrees with the program's float64 path; a run with the timed path
broken underneath comes out not correct, once for each fault a sweep can
have; the sample draws from every chunk, so one wrong chunk fails it; the
TF32 control fails the limits.  The card tests run both cells at their own
size on the card, with each fault planted."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from portbench._tiny import tiny_cell
from portbench.harness import ROOT, run_cell

CELLS = ["poisson_cells64.sweep", "beam_cells8.sweep"]
SEED = 987654321987


@pytest.mark.parametrize("name", CELLS)
def test_reference_matches_program_float64(name):
    """The reference's A* and u against the program's float64 path (the
    same arithmetic to rounding)."""
    import importlib

    from portbench.families.common import AstarProbe
    from portbench.reference.fem import Precision

    cell = tiny_cell(name)
    cfg = {**cell.config, "dtype": "float64"}
    fam = importlib.import_module(f"portbench.families.{cfg['family']}")
    theta = torch.tensor(1.3, dtype=torch.float64)
    system = fam.build(cfg, "cpu", theta)
    probe = AstarProbe()
    try:
        with torch.no_grad():
            u = system.step(system.centers)
        A = probe.last
    finally:
        probe.remove()
    ref = importlib.import_module(f"portbench.reference.{cfg['family']}").Model(cfg, "cpu")
    idx = torch.arange(A.shape[0])
    f64 = Precision("float64")
    A_ref = ref.astar(idx, 1.3, f64)
    assert float((A - A_ref).abs().max() / A_ref.abs().max()) < 1e-10
    u_ref = ref.solve(A_ref, f64)
    assert float((u - u_ref).abs().max() / u_ref.abs().max()) < 1e-8


def _stale(step):
    """A step that returns its first answer ever after."""
    first = []

    def broken(centers):
        u = step(centers)
        if not first:
            first.append(u.clone())
        return first[0].clone()

    return broken


def _altered(step):
    """A step whose answer has one entry moved where it is produced."""
    def broken(centers):
        u = step(centers).clone()
        j = int(u.abs().argmax())
        u[j] += 1e-3 * u[j].abs()
        return u

    return broken


def _half_batch(monkeypatch):
    """The micro stage solves half the cells and gives the rest their mean."""
    from hommx_tpu_torch.micro.engine import MicroEngine

    orig = MicroEngine.tensors_for_centers

    def broken(self, coeff, centers, *args, **kwargs):
        half = centers.shape[0] // 2
        A = orig(self, coeff, centers[:half], *args, **kwargs)
        rest = A.mean(dim=0, keepdim=True).expand(centers.shape[0] - half, *A.shape[1:])
        return torch.cat([A, rest])

    monkeypatch.setattr(MicroEngine, "tensors_for_centers", broken)


def _one_chunk(monkeypatch):
    """The micro stage's A* of one chunk of cells (the engine's chunk
    size; the middle chunk) off by 1e-3."""
    from hommx_tpu_torch.micro.engine import MicroEngine

    orig = MicroEngine.tensors_for_centers

    def broken(self, coeff, centers, *args, **kwargs):
        A = orig(self, coeff, centers, *args, **kwargs).clone()
        size = self._auto_chunk(centers.shape[0])
        lo = size * ((-(-centers.shape[0] // size)) // 2)
        A[lo:lo + size] *= 1.001
        return A

    monkeypatch.setattr(MicroEngine, "tensors_for_centers", broken)


FAULTS = {"stale": (_stale, None), "altered": (_altered, None),
          "half_batch": (None, _half_batch), "one_chunk": (None, _one_chunk)}


@pytest.mark.parametrize("fault", ["stale", "half_batch", "altered"])
@pytest.mark.parametrize("name", CELLS)
def test_fault_makes_run_not_correct(name, fault, monkeypatch):
    wrap, patch = FAULTS[fault]
    if patch is not None:
        patch(monkeypatch)
    r = run_cell(tiny_cell(name), SEED, 0.3, False, device="cpu", wrap_step=wrap)
    assert r["correct"] is False


@pytest.mark.parametrize("n,chunks,cells", [(32768, 75, 75), (4320, 57, 57), (72, 6, 6),
                                            (100, 7, 3), (96, 1, 6)])
def test_sample_draws_from_every_chunk(n, chunks, cells):
    """Each sampled solve has at least ``cells`` distinct cells and one or
    more from each of the ``chunks`` runs of consecutive cells."""
    from portbench.check import sample

    size = -(-n // chunks)
    for seed in (1, 2**40 + 7, SEED):
        solves, picks = sample({"check": {"solves": 2, "cells": cells}}, seed, [1, 2, 3], n,
                               chunks)
        assert len(solves) == 2
        for p in picks:
            assert len(set(p.tolist())) == len(p) >= cells and p.max() < n
            assert set((p // size).tolist()) == set(range(-(-n // size)))


@pytest.mark.parametrize("name", CELLS)
def test_one_wrong_chunk_fails_the_check(name):
    """A* off by 1e-3 in one chunk of six, and right elsewhere, reads over
    the limit on every seed: the sample draws from every chunk."""
    import importlib

    import numpy as np

    from portbench.check import check
    from portbench.families.common import AstarProbe

    cell = tiny_cell(name)
    cfg = cell.config
    fam = importlib.import_module(f"portbench.families.{cfg['family']}")
    theta = torch.tensor(1.1, dtype=torch.float64)
    system = fam.build(cfg, "cpu", theta)
    probe = AstarProbe()
    try:
        with torch.no_grad():
            u = system.step(system.centers)
        A = probe.last.clone()
    finally:
        probe.remove()
    size = -(-A.shape[0] // 6)
    A[3 * size:4 * size] *= 1.001
    for seed in (SEED, SEED + 1, 5):
        out = check(cfg, seed, [1], np.array([1.1, 1.1]), lambda j: (u, A), "cpu", chunks=6)
        assert out["astar_gap"]["value"] > cfg["check"]["limits"]["astar_gap"]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_limits(name):
    """The reference in TF32 put in the program's place fails a number;
    the program on the same sample passes them all."""
    from portbench.control import readings

    cell = tiny_cell(name)
    out = readings(cell, [SEED, SEED + 1, SEED + 2], solves=2, device="cpu",
                   emit=lambda line: None)
    limits = cell.config["check"]["limits"]
    assert all(out["program"][k] <= limits[k] for k in limits)
    assert any(out["control"][k] > limits[k] for k in limits)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_correct_on_the_card(card, name):
    """The cell at its own size: a short run is correct, and the control on
    one seed fails a limit."""
    res = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", name, "--seed",
                          str(SEED), "--seconds", "3", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=1500)
    assert res.returncode == 0, res.stderr[-4000:]
    assert json.loads(res.stdout.strip().splitlines()[-1])["correct"] is True
    res = subprocess.run([sys.executable, "-m", "portbench.control", "--workload", name,
                          "--seeds", str(SEED), "--solves", "2"], cwd=ROOT, capture_output=True,
                         text=True, timeout=1500)
    assert res.returncode == 0, res.stderr[-4000:]
    summary = json.loads(res.stdout.strip().splitlines()[-1])
    from portbench.harness import load_cell

    limits = load_cell(name).config["check"]["limits"]
    assert any(summary["control"][k] > limits[k] for k in limits)


@pytest.mark.cuda
@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_fault_on_the_card(card, name, fault, monkeypatch):
    """Each fault at the cell's own size on the card, a short window: the
    run reads not correct."""
    from portbench.harness import load_cell

    wrap, patch = FAULTS[fault]
    if patch is not None:
        patch(monkeypatch)
    r = run_cell(load_cell(name), SEED + 7, 3.0, False, device=card, wrap_step=wrap)
    print(name, fault, json.dumps(r["checks"]))
    assert r["correct"] is False
