"""Data-parallel training and spatially split inference over processes
(counterpart of ofa_sr_tpu/parallel/): one process a device, collectives
through torch.distributed."""

from .mesh import (
    Mesh,
    all_reduce_sum,
    init_distributed,
    make_mesh,
    shard_batch,
    shard_params,
)
from .spatial import make_spatial_infer, pad_rows

__all__ = ["Mesh", "all_reduce_sum", "init_distributed", "make_mesh", "make_spatial_infer",
           "pad_rows", "shard_batch", "shard_params"]
