"""Fixtures of the benchmark's CPU tests."""

import pytest
import torch

from bench_support import make_root

# the tiny graphs' operations are small: more threads than this only
# crowd the cores when test workers run side by side
torch.set_num_threads(2)


@pytest.fixture
def tiny_root(tmp_path):
    """A checkout whose cells run at tiny sizes on the CPU."""
    return make_root(tmp_path)
