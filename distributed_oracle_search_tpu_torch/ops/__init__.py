from .device_graph import DeviceGraph
from .bellman_ford import (build_fm_columns, dist_to_targets,
                           first_move_from_dist)
from .table_search import extract_paths, pick_buckets, table_search_batch
from .cuda_walk import cuda_walk_batch

__all__ = [
    "DeviceGraph", "dist_to_targets", "first_move_from_dist",
    "build_fm_columns", "table_search_batch", "extract_paths",
    "pick_buckets", "cuda_walk_batch",
]
