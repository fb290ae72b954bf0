"""Subprocess body of the PyTorch port's two-process oracle test (not a
pytest file; imports no JAX).

Each process joins one gloo group, holds its contiguous block of W/P of
the 8 workers of an 8x6 city on the CPU, builds only their rows, and
answers a round and a fused two-diff round that merge across the
processes. The rows are checked against the port's CPU reference here;
process 0 saves the index (every worker's rows gathered to it) and the
merged answers for the test to hold against the JAX package.

Usage: torch_multihost_worker.py <process_id> <num_processes>
       <coordinator> <out_dir>
"""

import os
import sys

pid, nproc, coord, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                          sys.argv[4])

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402

from distributed_oracle_search_tpu_torch.data import (  # noqa: E402
    synth_city_graph, synth_diff, synth_scenario,
)
from distributed_oracle_search_tpu_torch.models.cpd import CPDOracle  # noqa: E402
from distributed_oracle_search_tpu_torch.models.reference import (  # noqa: E402
    first_move_matrix,
)
from distributed_oracle_search_tpu_torch.parallel import (  # noqa: E402
    DistributionController, multihost,
)

multihost.initialize(coordinator=coord, num_processes=nproc,
                     process_id=pid, cpu_devices_per_process=4)
assert multihost.process_info() == (pid, nproc)

n_workers = 8
g = synth_city_graph(8, 6, seed=7)
dc = DistributionController("tpu", None, n_workers, g.n)
oracle = CPDOracle(g, dc, device="cpu").build()
per = n_workers // nproc
assert list(oracle.workers) == list(range(pid * per, (pid + 1) * per))
assert not oracle.single and len(oracle.fm) == 1
golden = first_move_matrix(g, np.arange(g.n))
for wid in oracle.workers:
    owned = dc.owned(wid)
    got = oracle.fm[0][wid - pid * per, :len(owned)].numpy()
    assert (got == golden[owned]).all(), f"worker {wid} rows differ"
oracle.save(os.path.join(out, "index"))     # gathers; process 0 writes

queries = synth_scenario(g.n, 24, seed=8)
w_diff = g.weights_with_diff(synth_diff(g, frac=0.3, seed=9))
cm, pm, fm_ = oracle.query_multi(queries, [None, w_diff])
assert fm_.all(), "multihost fused campaign left queries unfinished"
c0, p0, f0 = oracle.query(queries)
c1, p1, f1 = oracle.query(queries, w_query=w_diff)
assert (cm[0] == c0).all() and (cm[1] == c1).all(), "fused != sequential"
assert (pm == p0).all() and (pm == p1).all()
if pid == 0:
    np.savez(os.path.join(out, "answers.npz"), c0=c0, p0=p0, f0=f0, c1=c1,
             cm=cm, pm=pm)
multihost.barrier("test-done")
print(f"MULTIHOST_OK process={pid} nproc={nproc} "
      f"slots={multihost.cpu_device_slots()}")
