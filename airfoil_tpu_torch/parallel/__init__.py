from airfoil_tpu_torch.parallel.mesh import (
    Mesh,
    batch_mesh,
    shard_polar_inputs,
    sharded_polar,
)

__all__ = ["Mesh", "batch_mesh", "shard_polar_inputs", "sharded_polar"]
