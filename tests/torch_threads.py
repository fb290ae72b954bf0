"""One intra-op thread for the PyTorch port's tests.

The port's plain-torch CPU paths run many tiny ops, and each op opens a
parallel region as wide as the host. With several pytest-xdist workers
on one host those regions collide, and a test that takes a second alone
takes minutes. Every ``tests/test_torch_*.py`` imports this module, so
each worker process runs torch on one thread. Answers do not depend on
the thread count. Imports nothing of JAX.
"""

try:
    import torch
except ImportError:           # the files skip themselves without torch
    torch = None

if torch is not None:
    torch.set_num_threads(1)
