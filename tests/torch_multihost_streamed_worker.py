"""Subprocess body of the PyTorch port's two-process SHARDED STREAMED
serving test (not a pytest file; imports no JAX).

Each controller serves only its own workers' queries, streaming only
those workers' rows; the disjoint partials merge by an all-gather
(``cli.process_query._StreamedServe``). Prints the merged cost checksum
and this process's streamed bytes; process 0 saves the merged answers.

Usage: torch_multihost_streamed_worker.py <pid> <nproc> <coord> <xy>
       <index> <scen> <out_dir>
"""

import os
import sys

pid, nproc, coord, xy, index, scen, out = (
    int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
    sys.argv[5], sys.argv[6], sys.argv[7])

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402

from distributed_oracle_search_tpu_torch.cli.process_query import (  # noqa: E402
    _StreamedServe,
)
from distributed_oracle_search_tpu_torch.data import Graph, read_scen  # noqa: E402
from distributed_oracle_search_tpu_torch.parallel import (  # noqa: E402
    DistributionController, multihost,
)

multihost.initialize(coordinator=coord, num_processes=nproc,
                     process_id=pid, cpu_devices_per_process=4)
g = Graph.from_xy(xy)
dc = DistributionController("mod", 4, 4, g.n)
queries = read_scen(scen)
serve = _StreamedServe(g, dc, index, chunk=64, device="cpu")
assert serve.pcount == nproc and serve.pidx == pid
cost, plen, fin = serve.query(queries)
assert bool(np.asarray(fin).all()), "merged campaign left queries behind"
if pid == 0:
    np.savez(os.path.join(out, "streamed.npz"), cost=cost, plen=plen,
             fin=fin)
stats = serve.st.last_stats
print(f"STREAMED_OK process={pid} nproc={nproc} "
      f"cost_sum={int(np.asarray(cost).sum())} "
      f"bytes={stats['bytes_streamed']} chunks={stats['row_chunks']}")
