"""PyTorch port, durable CPD builds (atomic artifacts, checksummed
manifests, crash-resume, self-healing loads) against the JAX package's.

The JAX package's ``tests/test_durability.py`` cases run over the port
(``torch_port_cases``), on the CPU. The two that start a subprocess
(``dos-serve`` drained by SIGTERM; the ``slow`` kill-mid-build drill's
``worker.build``) pass it ``--device cpu``: the port's entry points run
on the card unless asked."""

import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)
from torch_port_cases import load_cases  # noqa: E402

#: the port keeps the block counters in ``models.cpd.COUNTERS`` (the
#: JAX package in registry counters, ``M_BLOCKS_*``); the cases read
#: them through this view, by the same names
_COUNTER_VIEW = '''from distributed_oracle_search_tpu.models import cpd as _cpd


class _Count:
    def __init__(self, key):
        self.key = key

    @property
    def value(self):
        return _cpd.COUNTERS[self.key]


M_BLOCKS_CORRUPT = _Count("cpd_blocks_corrupt_total")
M_BLOCKS_REBUILT = _Count("cpd_blocks_rebuilt_total")
M_BLOCKS_RESUMED = _Count("build_blocks_resumed_total")
M_BLOCKS_VERIFIED = _Count("cpd_blocks_verified_total")
from distributed_oracle_search_tpu.models.cpd import (
    CPDOracle, INDEX_VERSION, BuildLedger, block_complete,'''

globals().update(load_cases("test_durability.py", __name__, drop={},
                            replace={
    """from distributed_oracle_search_tpu.models.cpd import (
    CPDOracle, INDEX_VERSION, M_BLOCKS_CORRUPT, M_BLOCKS_REBUILT,
    M_BLOCKS_RESUMED, M_BLOCKS_VERIFIED, BuildLedger, block_complete,""":
        _COUNTER_VIEW,
    '"-t", "--ingress", "stdin", "--metrics-dump", "serve_obs.json"]':
        '"-t", "--ingress", "stdin", "--metrics-dump", "serve_obs.json",\n'
        '         "--device", "cpu"]',
    '"--outdir", outdir, "--block-size", "8"]':
        '"--outdir", outdir, "--block-size", "8", "--device", "cpu"]',
}))
