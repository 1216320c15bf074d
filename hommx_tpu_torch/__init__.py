"""hommx_tpu_torch — the PyTorch/CUDA port of hommx_tpu (the HMM framework).

Ported so far: ``PoissonHMM`` and ``PoissonStratifiedHMM`` on structured
meshes (the periodic-stencil micro engine with its fused chunk-PCG CUDA
kernel, macro assembly with Dirichlet lifting, and the macro solve: dense
float64 Cholesky, or CG preconditioned by geometric multigrid or Jacobi,
whose matvec is the DIA SpMV CUDA kernel), the elasticity path,
``LinearElasticityHMM`` and ``LinearElasticityStratifiedHMM`` (the chunk
Cholesky micro route with its batched factor+solve CUDA kernel), periodic
homogenization (``PoissonPeriodicHMM``, ``ElasticityPeriodicHMM``), the
single-scale P1 and P2 FEM (``fem_solve``, ``PoissonFEM``,
``LinearElasticityFEM``) with the DOLFINx-style ``functionspace`` and
``Function``, every micro route (the per-cell one, ``cell_tensor``,
``solve_periodic``, the FFT and multigrid cell preconditioners, P2 cell
problems) and ``helpers``.  Every model takes the reference's constructor arguments and
defaults: cell dedup on (``dedup_cells``, ``dedup_verify``),
``SolverOptions`` or PETSc-style dicts for both solve levels.
Multi-device solves (``ShardMesh``, ``device_mesh``, ``shard_cells``,
``make_sharded_solver``, ``dryrun_multichip``) shard the micro stage over
the macro cells and the macro CG over the rows, from one process.
The solve is differentiable end to end: ``BaseHMM.build_pipeline``,
``fem_solve_fn`` and ``entry`` (the flagship's pipeline) carry the
implicit-function rule through every cell solve and the macro solve.
Every entry point runs on the card unless the caller passes
``device="cpu"``.  The reference's example scripts run on the port from
``hommx_tpu_torch.examples`` (``python3 -m hommx_tpu_torch.examples.hmm``).
The JAX package ``hommx_tpu`` is the reference it is tested against; this
package imports neither JAX nor ``hommx_tpu``.
"""

from hommx_tpu_torch import config  # noqa: F401  (precision policy: TF32 off)
from hommx_tpu_torch import helpers  # noqa: F401
from hommx_tpu_torch.meshes import (
    SimplexMesh,
    create_box,
    create_interval,
    create_rectangle,
    create_unit_cube,
    create_unit_square,
    mesh_from_delaunay,
    mesh_from_file,
    rescale_mesh,
    rescale_mesh_in_place,
)
from hommx_tpu_torch.micro.engine import MicroEngine
from hommx_tpu_torch.models.fem import LinearElasticityFEM, PoissonFEM, fem_solve, fem_solve_fn
from hommx_tpu_torch.models.hmm import (
    BaseHMM,
    LinearElasticityHMM,
    LinearElasticityStratifiedHMM,
    PoissonHMM,
    PoissonStratifiedHMM,
)
from hommx_tpu_torch.models.periodic import (
    BasePeriodicHMM,
    ElasticityPeriodicHMM,
    PoissonPeriodicHMM,
)
from hommx_tpu_torch.ops.function_space import (
    DirichletBC,
    Function,
    FunctionSpace,
    dirichletbc,
    functionspace,
    locate_dofs_geometrical,
)
from hommx_tpu_torch.parallel import ShardMesh, device_mesh, make_sharded_solver, shard_cells
from hommx_tpu_torch.utils.options import SolverOptions
from hommx_tpu_torch.entry import dryrun_multichip, entry

__all__ = [
    "SimplexMesh",
    "create_box",
    "create_interval",
    "create_rectangle",
    "create_unit_cube",
    "create_unit_square",
    "mesh_from_delaunay",
    "mesh_from_file",
    "rescale_mesh",
    "rescale_mesh_in_place",
    "helpers",
    "MicroEngine",
    "BaseHMM",
    "PoissonHMM",
    "PoissonStratifiedHMM",
    "LinearElasticityHMM",
    "LinearElasticityStratifiedHMM",
    "BasePeriodicHMM",
    "PoissonPeriodicHMM",
    "ElasticityPeriodicHMM",
    "PoissonFEM",
    "LinearElasticityFEM",
    "fem_solve",
    "fem_solve_fn",
    "entry",
    "dryrun_multichip",
    "ShardMesh",
    "device_mesh",
    "shard_cells",
    "make_sharded_solver",
    "DirichletBC",
    "Function",
    "FunctionSpace",
    "functionspace",
    "dirichletbc",
    "locate_dofs_geometrical",
    "SolverOptions",
]
