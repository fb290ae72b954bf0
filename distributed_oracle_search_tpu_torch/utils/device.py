"""Device resolution for the port's entry points.

Every entry point runs on the card unless its caller asks for the CPU:
``device=None`` means ``cuda``, and a ``cuda`` request on a host without
a usable GPU raises instead of quietly carrying on on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` (None → ``cuda``) as a ``torch.device``; raises
    ``RuntimeError`` for a CUDA device when no GPU is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on "
            "the CPU")
    return dev
