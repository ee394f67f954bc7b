from .data_parallel import chunk_seeds, replicate, shard_fused_trainer
from .mesh import (
    DATA_AXIS,
    Mesh,
    Ranks,
    distributed_init,
    local_mesh,
    make_mesh,
    shard_batch,
    shard_rows,
    sharded_rollout,
    split_generator,
)

__all__ = [
    "DATA_AXIS",
    "Mesh",
    "make_mesh",
    "local_mesh",
    "distributed_init",
    "sharded_rollout",
    "shard_batch",
    "shard_rows",
    "split_generator",
    "Ranks",
    "shard_fused_trainer",
    "chunk_seeds",
    "replicate",
]
