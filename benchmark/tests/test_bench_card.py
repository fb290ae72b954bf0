"""Each cell's whole run on the card, a short window: run on a machine
with a GPU by ``python -m pytest -m cuda benchmark/tests/test_bench_card.py``
from the root of a checkout."""

import json
import subprocess
import sys

import pytest
import torch

from bench_support import CELLS, ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card_is_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         "2718281828", "--seconds", "1", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert res["device"]["busy_s"] > 0 and res["metrics"]


def test_without_a_card_the_run_refuses(monkeypatch):
    """No result and a non-zero exit where the card is missing."""
    from harness.main import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"],
                root=ROOT) == 2
