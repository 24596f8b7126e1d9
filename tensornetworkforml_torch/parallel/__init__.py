from tensornetworkforml_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    batch_sharding,
    make_mesh,
    replicate_params,
    replicated,
    shard_batch,
    site_sharding,
)
from tensornetworkforml_torch.parallel.dist_split import (
    distributed_cholqr_split,
    distributed_polar_split,
    shard_bmat_columns,
)
from tensornetworkforml_torch.parallel.dp import (
    ShardedTrainer,
    make_sharded_train_step,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "batch_sharding",
    "make_mesh",
    "replicate_params",
    "replicated",
    "shard_batch",
    "site_sharding",
    "ShardedTrainer",
    "make_sharded_train_step",
    "distributed_cholqr_split",
    "distributed_polar_split",
    "shard_bmat_columns",
]
