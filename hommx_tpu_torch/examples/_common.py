"""What several example scripts share: the Darcy boundary conditions, the
periodic circular indicator, the command line's ``--device`` and
``--out``, and writing a plot into ``--out``."""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from hommx_tpu_torch import dirichletbc
from hommx_tpu_torch.ops.function_space import boundary_dofs


def darcy_bcs(V):
    """u = 1 on the left edge of the bounding box, 0 on the right, natural
    elsewhere."""
    lo, hi = V.mesh.bounding_box()
    left = boundary_dofs(V, lambda x: np.isclose(x[0], lo[0]))
    right = boundary_dofs(V, lambda x: np.isclose(x[0], hi[0]))
    return [dirichletbc(1.0, left, V), dirichletbc(0.0, right, V)]


def circle_indicator(a, b, r: float = 0.25):
    """Whether (a, b) lies in the disc of radius ``r`` about (1/2, 1/2) of
    the 1-periodic cell, by the wrapped distance in each coordinate."""
    da = torch.arccos(torch.cos(2 * torch.pi * (a - 0.5)))
    db = torch.arccos(torch.cos(2 * torch.pi * (b - 0.5)))
    return (da**2 + db**2) < ((2 * torch.pi) ** 2 * r**2)


def two_phase(mask, inside: float, outside: float, like):
    """``inside`` where ``mask``, else ``outside``, in the dtype and on the
    device of ``like`` (``torch.where`` on two Python numbers is float32)."""
    one = torch.ones((), dtype=like.dtype, device=like.device)
    return torch.where(mask, inside * one, outside * one)


def parser(description: str) -> argparse.ArgumentParser:
    """An argument parser with the port's two flags beside the example's."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda; 'cpu' runs float64)")
    ap.add_argument("--out", default=".", help="directory for the PNGs (default: .)")
    return ap


def png_path(out: str, name: str) -> str:
    """``name`` inside the directory ``out``, which is created."""
    os.makedirs(out, exist_ok=True)
    return os.path.normpath(os.path.join(out, name))


def close_figure(fig) -> None:
    """Close a matplotlib figure (the raster backend returns an image)."""
    if hasattr(fig, "savefig"):
        import matplotlib.pyplot as plt

        plt.close(fig)
