"""Subprocess body of the PyTorch port's two-process campaign test (not a
pytest file; imports no JAX).

Runs the campaign CLI itself, ``cli.process_query.main``, on a cluster conf
whose ``multihost`` key joins the processes into one gloo group; the
process id comes from ``$DOS_PROCESS_ID``. Every process writes (if it
writes at all) under its own output directory, so the test can tell
that process 0 alone wrote the artifacts.

Usage: torch_multihost_campaign_worker.py <process_id> <conf_path>
       <out_dir> [process_query arguments...]
"""

import os
import sys

pid, conf_path, out_dir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
extra = sys.argv[4:]

os.environ["DOS_PROCESS_ID"] = str(pid)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from distributed_oracle_search_tpu_torch.cli import process_query  # noqa: E402
from distributed_oracle_search_tpu_torch.ops import cuda_walk  # noqa: E402
from distributed_oracle_search_tpu_torch.parallel import multihost  # noqa: E402

rc = process_query.main(["-c", conf_path, "-o", out_dir, "--device", "cpu",
                         "-v", *extra])
assert rc == 0, rc
pidx, pcount = multihost.process_info()
walks = cuda_walk.cuda_walk_batch.plain + cuda_walk.cuda_walk_multi.plain
print(f"CAMPAIGN_OK process={pidx} nproc={pcount} walks={walks}")
