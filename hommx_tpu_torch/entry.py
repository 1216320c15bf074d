"""The port's entry point (torch counterpart of ``__graft_entry__.py``'s
``entry``): the flagship model's whole solve as a differentiable function.

The flagship is the configuration of the reference's ``examples/hmm.py``:
a PoissonHMM on an 8×8 macro mesh with an 8×8 micro mesh, the laminate
coefficient A(x, y) = 1.1 + x₀ + sin 2πy₀, f = 1, ε = 1/32; float32 on the
card, float64 on the CPU.
"""

from __future__ import annotations

import torch

from hommx_tpu_torch.config import as_device
from hommx_tpu_torch.meshes import create_unit_square
from hommx_tpu_torch.models.hmm import PoissonHMM

__all__ = ["entry"]


def _coefficient(x, y):
    return 1.1 + x[0] + torch.sin(2 * torch.pi * y[0])


def entry(device="cuda"):
    """(step, (centers,)): the flagship's full solve ``step(centers) -> u``
    (micro cell problems, homogenized tensors, macro assembly, macro
    solve) from ``BaseHMM.build_pipeline``, and its example argument."""
    hmm = PoissonHMM(create_unit_square(8, 8), _coefficient, lambda x: 1.0,
                     create_unit_square(8, 8), 1 / 2**5, device=as_device(device))
    step, centers = hmm.build_pipeline()
    return step, (centers,)
