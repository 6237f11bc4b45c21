"""Meshes over ``torch.distributed`` ranks and sharding rules."""

from explainable_spatial_vqa_tpu_torch.parallel.mesh import (  # noqa: F401
    batch_sharding,
    make_mesh,
    replicated,
    shard_batch,
)
