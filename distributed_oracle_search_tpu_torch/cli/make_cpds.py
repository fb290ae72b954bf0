"""CPD precompute launcher: the port's ``make_cpds.py``.

Role parity with reference P2 (SURVEY.md §2.1) and the JAX package's
``cli/make_cpds.py``: read the cluster conf, build every worker's CPD
rows, save the index to the conf's ``outdir`` with its manifest.

With ``partmethod: "tpu"`` (or ``--backend tpu``) the build runs
in-process: one :class:`~..models.cpd.CPDOracle` builds the whole
``[W, R, N]`` table on one device (``--device``, default ``cuda``) and
saves it — no ssh, no worker processes.

``-t`` builds the canned smoke config (``utils.config.test_config`` with
8 workers, the shape of the checked-in ``data/index``: one card holds
every worker), generating the synthetic dataset under ``./data`` if it
is absent.

Not ported, and refused with the ``ROADMAP.md`` item that ports each:
the host backend (per-worker ``worker.build`` processes over ssh/tmux),
``--verify`` and ``--scrub``, and ``--delta-from``.

    python -m distributed_oracle_search_tpu_torch.cli.make_cpds -c conf.json
"""

from __future__ import annotations

import os
import sys

from .args import parse_args
from ..utils.atomicio import sweep_stale_artifacts
from ..utils.config import ClusterConfig, mesh_layout, test_config
from ..utils.log import get_logger, set_verbosity

log = get_logger(__name__)


def run_tpu(conf: ClusterConfig, args) -> None:
    """In-process build of every worker's rows on one device."""
    from ..data.graph import Graph
    from ..models.cpd import CPDOracle
    from ..parallel.partition import DistributionController

    # debris of killed builds goes before the new blocks are written
    sweep_stale_artifacts(conf.outdir)
    mesh_layout(conf)
    graph = Graph.from_xy(conf.xy_file)
    dc = DistributionController(conf.partmethod, conf.partkey,
                                conf.maxworker, graph.n)
    oracle = CPDOracle(graph, dc, device=args.device)
    oracle.build(chunk=args.chunk)
    oracle.save(conf.outdir, codec=args.codec)
    print(f"built the CPD for {graph.n} nodes over {conf.maxworker} "
          f"workers on {oracle.device} -> {conf.outdir}")


def main(argv=None) -> int:
    args = parse_args(argv, prog="make_cpds")
    set_verbosity(args.verbose)
    if args.test:
        from ..data.synth import ensure_synth_dataset

        conf = test_config(n_workers=8)
        ensure_synth_dataset(os.path.dirname(conf.xy_file) or "./data")
    else:
        conf = ClusterConfig.load(args.c)
    if args.scrub or args.verify:
        raise SystemExit("--verify/--scrub (verify_index) is not ported "
                         "(ROADMAP.md A4)")
    if args.delta_from:
        raise SystemExit("--delta-from (delta rebuilds) is not ported "
                         "(ROADMAP.md A10)")
    if not (args.backend == "tpu" or (args.backend == "auto"
                                      and conf.is_tpu)):
        raise SystemExit(
            f"the host backend (partmethod {conf.partmethod!r}: per-worker "
            "builds over ssh/tmux) is not ported (ROADMAP.md A6); use "
            "partmethod 'tpu' or --backend tpu for the in-process build")
    run_tpu(conf, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
