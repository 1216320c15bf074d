from hommx_tpu_torch.parallel.macro import make_sharded_solver
from hommx_tpu_torch.parallel.sharding import ShardMesh, device_mesh, shard_cells

__all__ = ["ShardMesh", "device_mesh", "shard_cells", "make_sharded_solver"]
