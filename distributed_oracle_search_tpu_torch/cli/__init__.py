"""Head-node CLIs: parity with the JAX package's entry points.

* ``make_cpds``            — CPD precompute (reference P2), in-process
* ``process_query``        — the query campaign (reference P4), in-process
* ``gen_distribute_conf``  — the partition oracle (reference C2)
* ``args``                 — the shared flag surface (reference P1)
"""

from .args import build_parser, get_time_ns, parse_args, process_filename

__all__ = ["build_parser", "get_time_ns", "parse_args", "process_filename"]
