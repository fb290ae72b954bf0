from .reference import (
    dijkstra, dist_to_target, first_move_to_target, first_move_matrix,
    table_search_walk,
)
from .astar import AstarStats, astar, min_cost_per_unit

__all__ = [
    "dijkstra", "dist_to_target", "first_move_to_target", "first_move_matrix",
    "table_search_walk", "AstarStats", "astar", "min_cost_per_unit",
]
