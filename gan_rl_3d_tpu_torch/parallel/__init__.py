"""Mesh / sharding layer (gan_rl_3d_tpu/parallel/): data parallelism
over torch.distributed, with a model axis that column-shards the wide
layers. ``collectives`` holds the differentiable collectives the layers
use."""

from gan_rl_3d_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    DATA_SHARD_GROUPS,
    MODEL_AXIS,
    Mesh,
    init_distributed,
    make_mesh,
    process_local_slice,
    replicated,
    row_sharding,
    shard_batch,
    shard_model_for_mesh,
)
