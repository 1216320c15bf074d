"""Program side of the ``poisson_hmm`` family: hommx_tpu_torch's PoissonHMM
on the configuration's rectangle with its Dirichlet values on the left and
right edges (natural on the others), the load f, the laminate coefficient
A(x, y) = a0 + θ·x₀ + amplitude·sin 2π(y₀ + x₁), θ a 0-d tensor that the
harness rewrites before each solve, and its ``build_pipeline`` step."""

from __future__ import annotations

import numpy as np
import torch

from portbench.families.common import System

#: the kernel launchers whose counts a run reports: label -> (module, launcher)
LAUNCHERS = {
    "k1_large": ("hommx_tpu_torch.micro.stencil_pcg", "hommx_stencil_pcg_large_f32"),
    "k1_small": ("hommx_tpu_torch.micro.stencil_pcg", "hommx_stencil_pcg_f32"),
    "k2": ("hommx_tpu_torch.ops.dia", "hommx_dia_spmv_f32"),
}
#: the launcher that takes one chunk of cells a launch: the check samples
#: every chunk
CHUNK_LAUNCHER = "k1_large"


def build(cfg: dict, device, theta: torch.Tensor) -> System:
    import hommx_tpu_torch as H
    from hommx_tpu_torch.ops.function_space import boundary_dofs

    c = cfg["coefficient"]
    a0, amp = float(c["a0"]), float(c["amplitude"])

    def A(x, y):
        return a0 + theta * x[0] + amp * torch.sin(2 * torch.pi * (y[0] + x[1]))

    box = np.asarray(cfg["macro_box"], dtype=np.float64)
    n, m = cfg["macro_cells_per_axis"], cfg["micro_cells_per_axis"]
    hmm = H.PoissonHMM(H.create_rectangle(box.tolist(), [n, n]), A, float(cfg["load"]),
                       H.create_unit_square(m, m), float(cfg["eps"]),
                       H.SolverOptions(**cfg["macro_solver"]), dtype=getattr(torch, cfg["dtype"]),
                       device=device, dedup_cells=False)
    V = hmm.function_space
    bc = cfg["dirichlet"]
    hmm.set_boundary_conditions([
        H.dirichletbc(float(bc["left"]), boundary_dofs(V, lambda x: np.isclose(x[0], box[0, 0])), V),
        H.dirichletbc(float(bc["right"]), boundary_dofs(V, lambda x: np.isclose(x[0], box[1, 0])), V),
    ])
    step, centers = hmm.build_pipeline()
    return System(hmm, step, centers, LAUNCHERS, CHUNK_LAUNCHER)
