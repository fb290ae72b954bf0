"""Partition oracle CLI: the framework's ``gen_distribute_conf``.

CLI + wire parity with reference C2 (SURVEY.md §2.2; invoked at reference
``process_query.py:46``)::

    python -m distributed_oracle_search_tpu_torch.cli.gen_distribute_conf \
        --nodenum <int> --maxworker <int> \
        --partmethod <div|mod|alloc|tpu> --partkey <int...>

Stdout: one header line, then one CSV row per node — ``node,wid,bid,bidx``
(parsed by the reference head at ``process_query.py:50-53``). A pure
function of its flags: the single source of truth that keeps build-time
sharding and query-time routing consistent. In-process callers should use
``parallel.DistributionController`` directly; this program exists for
interop with external tooling that shells out. A copy of the JAX
package's CLI: for the same flags its stdout is the same.
"""

from __future__ import annotations

import argparse
import sys

from ..parallel.partition import DistributionController


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--nodenum", type=int, required=True)
    p.add_argument("--maxworker", type=int, required=True)
    p.add_argument("--partmethod", required=True,
                   choices=["div", "mod", "alloc", "tpu"])
    p.add_argument("--partkey", type=int, nargs="+", default=[1])
    p.add_argument("--replication", type=int, default=None,
                   help="R-way replica placement: appends rep<r> "
                        "columns naming the worker hosting each node's "
                        "rank-r replica (default: DOS_REPLICATION or 1; "
                        "1 emits the legacy 4-column format)")
    return p


def main(argv=None) -> int:
    from ..utils.env import env_cast

    args = build_parser().parse_args(argv)
    partkey = args.partkey if args.partmethod == "alloc" else args.partkey[0]
    replication = args.replication
    if replication is None:
        # env policy: a malformed or out-of-range DOS_REPLICATION
        # degrades to the legacy table (the explicit flag still raises)
        replication = env_cast("DOS_REPLICATION", 1, int)
        if not 1 <= replication <= args.maxworker:
            replication = 1
    dc = DistributionController(args.partmethod, partkey, args.maxworker,
                                args.nodenum, replication=replication)
    try:
        print(dc.format_conf())
    except BrokenPipeError:  # downstream `| head` closed the pipe; not an error
        sys.stderr.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
