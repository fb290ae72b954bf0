"""Head-node CLIs: parity with the JAX package's entry points.

* ``make_cpds``            — CPD precompute (reference P2): in-process, or
  one ``worker.build`` process a worker on the host backend
* ``make_fifos``           — resident ``worker.server`` processes (P3)
* ``process_query``        — the query campaign (reference P4): in-process,
  or over the workers' command FIFOs on the host backend
* ``reorder``              — BFS / RCM node reordering of a dataset
* ``gen_distribute_conf``  — the partition oracle (reference C2)
* ``args``                 — the shared flag surface (reference P1)
"""

from .args import build_parser, get_time_ns, parse_args, process_filename

__all__ = ["build_parser", "get_time_ns", "parse_args", "process_filename"]
