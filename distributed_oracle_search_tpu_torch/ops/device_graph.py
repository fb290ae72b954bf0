"""Device-resident graph arrays.

The padded ELL layout of ``data.Graph`` as torch tensors on one device,
ready for gather-based relaxation and the walk: ``[N, K]`` neighbor/edge
tables and a ``[M+1]`` weight vector whose last slot is INF, so ELL
padding lanes can never win a min (see ``data.graph.Graph.ell``).
Everything downstream (CPD build, table-search) consumes only these
tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..data.graph import Graph, INF
from ..utils.device import resolve_device


class DeviceGraph(NamedTuple):
    """ELL graph on one device.

    out_nbr : int32 [N, K] — k-th out-neighbor (self for padding)
    out_eid : int32 [N, K] — edge id (M for padding)
    w_pad   : int32 [M+1]  — free-flow weights; w_pad[M] = INF
    """
    out_nbr: torch.Tensor
    out_eid: torch.Tensor
    w_pad: torch.Tensor

    @property
    def n(self) -> int:
        return self.out_nbr.shape[0]

    @property
    def k(self) -> int:
        return self.out_nbr.shape[1]

    @property
    def device(self) -> torch.device:
        return self.out_nbr.device

    @classmethod
    def from_graph(cls, g: Graph, weights: np.ndarray | None = None,
                   device=None) -> "DeviceGraph":
        """Upload ``g``'s ELL tables to ``device`` (None → ``cuda``;
        raises without a GPU unless ``device="cpu"``)."""
        dev = resolve_device(device)
        nbr, eid = g.ell("out")
        return cls(
            out_nbr=torch.as_tensor(nbr, dtype=torch.int32, device=dev),
            out_eid=torch.as_tensor(eid, dtype=torch.int32, device=dev),
            w_pad=torch.as_tensor(g.padded_weights(weights),
                                  dtype=torch.int32, device=dev),
        )

    def with_weights(self, w_pad) -> "DeviceGraph":
        """Same topology, different (e.g. congestion-perturbed) weights."""
        return self._replace(w_pad=torch.as_tensor(
            w_pad, dtype=torch.int32, device=self.device))


TINF = int(INF)
