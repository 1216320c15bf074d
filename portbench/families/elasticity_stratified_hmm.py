"""Program side of the ``elasticity_stratified_hmm`` family: hommx_tpu_torch's
LinearElasticityStratifiedHMM on the configuration's box, the rotated-fibre
Hooke tensor with the fibre modulus μ_fibre·(1 + slope·θ·(x₀ + x₂)), θ a 0-d
tensor that the harness rewrites before each solve, the rotation
Dθᵀ(x) = R(π/2 · x₁/W)ᵀ, clamped on x₀ = lo₀, and its ``build_pipeline`` step."""

from __future__ import annotations

import numpy as np
import torch

from portbench.families.common import System

#: the kernel launchers whose counts a run reports: label -> (module, launcher)
LAUNCHERS = {
    "k3_large": ("hommx_tpu_torch.ops.chol_kernel", "hommx_chol_solve_large_f32"),
    "k3_small": ("hommx_tpu_torch.ops.chol_kernel", "hommx_chol_solve_f32"),
}
#: the launcher that takes one chunk of cells a launch: the check samples
#: every chunk
CHUNK_LAUNCHER = "k3_large"


def build(cfg: dict, device, theta: torch.Tensor) -> System:
    import hommx_tpu_torch as H
    from hommx_tpu_torch.examples._common import circle_indicator
    from hommx_tpu_torch.ops.function_space import boundary_dofs
    from hommx_tpu_torch.utils.validation import hooke_tensor

    c = cfg["coefficient"]
    box = np.asarray(cfg["macro_box"], dtype=np.float64)
    width = float(box[1, 1] - box[0, 1])
    mu_f, mu_m, slope, radius = (float(c[k]) for k in
                                 ("mu_fibre", "mu_matrix", "fibre_slope", "fibre_radius"))
    lam = float(c["lambda"])

    def mu(x, y):
        one = torch.ones((), dtype=y.dtype, device=y.device)
        stiff = mu_f * (1.0 + slope * theta * (x[0] + x[2])) * one
        return torch.where(circle_indicator(y[1], y[2], radius), stiff, mu_m * one)

    def Dtheta(x):
        g = 0.5 * torch.pi * x[1] / width
        cs, sn = torch.cos(g), torch.sin(g)
        z, o = torch.zeros_like(cs), torch.ones_like(cs)
        return torch.stack([torch.stack([cs, z, sn]), torch.stack([z, o, z]),
                            torch.stack([-sn, z, cs])]).T

    load = torch.tensor([0.0, 0.0, -float(cfg["load_g"])], dtype=torch.float64)
    hmm = H.LinearElasticityStratifiedHMM(
        H.create_box(box.tolist(), list(cfg["macro_cells"])), hooke_tensor(3, mu, lambda x, y: lam),
        lambda x: load, H.create_unit_cube(cfg["micro_cells_per_axis"]), float(cfg["eps"]), Dtheta,
        dtype=getattr(torch, cfg["dtype"]), device=device, dedup_cells=False)
    V = hmm.function_space
    hmm.set_boundary_conditions(H.dirichletbc(
        np.zeros(3), boundary_dofs(V, lambda x: np.isclose(x[0], box[0, 0])), V))
    step, centers = hmm.build_pipeline()
    return System(hmm, step, centers, LAUNCHERS, CHUNK_LAUNCHER)
