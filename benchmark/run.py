"""The benchmark of the PyTorch/CUDA port: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. ``BENCHMARK.json`` names the cells; see
``benchmark/harness/main.py`` for what a run does and prints.
"""

import os
import sys

from harness.main import main, process_start

if __name__ == "__main__":
    T_START = process_start()
    HERE = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(1, os.path.dirname(HERE))
    sys.exit(main(t_start=T_START))
