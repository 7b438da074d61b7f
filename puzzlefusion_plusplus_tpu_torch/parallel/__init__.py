"""Data parallelism on ``torch.distributed``: ``mesh`` (world size, batch sharding, the
collectives that keep a step's meaning that of the global batch) and ``launch`` (one process
a rank); ``dryrun`` runs one training step on a ("data", "model") mesh of CPU processes."""

from puzzlefusion_plusplus_tpu_torch.parallel.mesh import (
    all_reduce_gradients,
    all_reduce_sum,
    global_sum,
    pad_batch_to_devices,
    replicate,
    shard_batch,
    world_size,
)

__all__ = ["all_reduce_gradients", "all_reduce_sum", "global_sum", "pad_batch_to_devices",
           "replicate", "shard_batch", "world_size"]
