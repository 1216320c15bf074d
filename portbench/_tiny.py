"""Tiny versions of the benchmark's cells for the CPU tests: the same
families, traffic, metrics and checks at a few cells."""

from __future__ import annotations

from portbench.harness import load_cell

#: per family: the keys that shrink a configuration to a CPU test's size
TINY = {
    "poisson_hmm": {"macro_cells_per_axis": 6, "micro_cells_per_axis": 8},
    "elasticity_stratified_hmm": {"macro_cells": [4, 2, 2], "micro_cells_per_axis": 4},
}


def tiny_cell(name: str, root=None):
    """Cell ``name`` of BENCHMARK.json with its configuration shrunk and its
    check sampling 6 cells."""
    cell = load_cell(name) if root is None else load_cell(name, root)
    cell.config.update(TINY[cell.config["family"]])
    cell.config["check"] = {**cell.config["check"], "cells": 6}
    return cell
