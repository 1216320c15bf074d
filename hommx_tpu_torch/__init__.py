"""hommx_tpu_torch — the PyTorch/CUDA port of hommx_tpu (the HMM framework).

Ported so far: ``PoissonHMM`` and ``PoissonStratifiedHMM`` on structured
meshes (the periodic-stencil micro engine with its fused chunk-PCG CUDA
kernel, macro assembly with Dirichlet lifting, and the macro solve: dense
float64 Cholesky, or CG preconditioned by geometric multigrid or Jacobi,
whose matvec is the DIA SpMV CUDA kernel), and the elasticity path,
``LinearElasticityHMM`` and ``LinearElasticityStratifiedHMM`` (the chunk
Cholesky micro route with its batched factor+solve CUDA kernel).  Every
model takes the reference's constructor arguments and defaults: cell dedup
on (``dedup_cells``, ``dedup_verify``), ``SolverOptions`` or PETSc-style
dicts for both solve levels.
Every entry point runs on the card unless the caller passes
``device="cpu"``.
The JAX package ``hommx_tpu`` is the reference it is tested against; this
package imports neither JAX nor ``hommx_tpu``.
"""

from hommx_tpu_torch import config  # noqa: F401  (precision policy: TF32 off)
from hommx_tpu_torch.meshes import (
    SimplexMesh,
    create_box,
    create_rectangle,
    create_unit_cube,
    create_unit_square,
)
from hommx_tpu_torch.micro.engine import MicroEngine
from hommx_tpu_torch.models.hmm import (
    BaseHMM,
    LinearElasticityHMM,
    LinearElasticityStratifiedHMM,
    PoissonHMM,
    PoissonStratifiedHMM,
)
from hommx_tpu_torch.ops.function_space import (
    DirichletBC,
    Function,
    FunctionSpace,
    dirichletbc,
)
from hommx_tpu_torch.utils.options import SolverOptions

__all__ = [
    "SimplexMesh",
    "create_box",
    "create_rectangle",
    "create_unit_cube",
    "create_unit_square",
    "MicroEngine",
    "BaseHMM",
    "PoissonHMM",
    "PoissonStratifiedHMM",
    "LinearElasticityHMM",
    "LinearElasticityStratifiedHMM",
    "DirichletBC",
    "Function",
    "FunctionSpace",
    "dirichletbc",
    "SolverOptions",
]
