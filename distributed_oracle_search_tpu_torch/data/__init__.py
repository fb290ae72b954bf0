from .graph import Graph, INF
from .formats import (
    read_xy, write_xy, read_scen, write_scen, read_diff, write_diff,
    xy_node_count,
)
from .synth import (synth_city_graph, synth_road_network, synth_scenario,
                    synth_diff, ensure_synth_dataset)
from .dimacs import graph_from_dimacs, read_co, read_gr

__all__ = [
    "Graph", "INF", "read_xy", "write_xy", "read_scen", "write_scen",
    "read_diff", "write_diff", "xy_node_count",
    "synth_city_graph", "synth_road_network", "synth_scenario",
    "synth_diff", "ensure_synth_dataset",
    "graph_from_dimacs", "read_co", "read_gr",
]
