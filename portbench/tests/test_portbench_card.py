"""A short run of every cell on the card (skips without one)."""

import json
import os
import subprocess
import sys

import pytest

from portbench import harness
from portbench.tests.tiny import CELLS, SEED


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_on_the_card(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    p = subprocess.run(
        [sys.executable, os.path.join(harness.HERE, "run.py"), "--workload", name, "--seed", str(SEED),
         "--seconds", "3", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=600,
    )
    assert p.returncode == 0, p.stderr[-4000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["device"]["platform"] == "gpu"
