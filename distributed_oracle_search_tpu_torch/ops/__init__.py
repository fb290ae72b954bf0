from .device_graph import DeviceGraph
from .bellman_ford import (build_fm_columns, dist_to_targets,
                           first_move_from_dist)
from .table_search import (extract_paths, pick_buckets, table_search_batch,
                           table_search_multi)
from .cuda_walk import cuda_walk_batch, cuda_walk_multi
from .pointer_doubling import (doubled_tables, doubled_tables_multi,
                               lookup_tables, lookup_tables_multi)
from .cuda_doubling import doubling_rows, doubling_sweep, doubling_team
from .batched_astar import astar_batch, astar_batch_np, heuristic_table

__all__ = [
    "DeviceGraph", "dist_to_targets", "first_move_from_dist",
    "build_fm_columns", "table_search_batch", "table_search_multi",
    "extract_paths", "pick_buckets", "cuda_walk_batch", "cuda_walk_multi",
    "doubled_tables", "doubled_tables_multi", "lookup_tables",
    "lookup_tables_multi", "doubling_rows", "doubling_sweep", "doubling_team",
    "astar_batch", "astar_batch_np", "heuristic_table",
]
