from .reference import (
    dijkstra, dist_to_target, first_move_to_target, first_move_matrix,
    table_search_walk,
)

__all__ = [
    "dijkstra", "dist_to_target", "first_move_to_target", "first_move_matrix",
    "table_search_walk",
]
