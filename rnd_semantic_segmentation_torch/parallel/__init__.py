"""Data parallelism over processes: the process group, the collectives of
the train steps and the BatchNorm across ranks."""

from .batchnorm import CrossRankBatchNorm2d, convert_batchnorm
from .dist import (
    all_reduce_,
    all_reduce_sum,
    average_gradients,
    barrier,
    broadcast_module,
    check_world,
    initialize_distributed,
    local_rank,
    mean_over_ranks,
    process_is_primary,
    rank,
    rank_rows,
    world_size,
)

__all__ = ["CrossRankBatchNorm2d", "all_reduce_", "all_reduce_sum", "average_gradients",
           "barrier", "broadcast_module", "check_world", "convert_batchnorm",
           "initialize_distributed", "local_rank", "mean_over_ranks",
           "process_is_primary", "rank", "rank_rows", "world_size"]
