"""Every cell's traffic loop at a tiny size on the CPU: set-up, a short
window, the reference's judgement and the result line."""

import json
import os
import subprocess
import sys

import pytest

from portbench import harness
from portbench.tests.tiny import CELLS, run_tiny


@pytest.mark.parametrize("name", CELLS)
def test_one_window_of_each_cell_is_correct(name):
    result = run_tiny(name)
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    cell = harness.resolve(harness.load_spec(), name)
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(m["value"] > 0 for m in result["metrics"].values())
    # the compared numbers come last, each with its limit
    assert list(result)[-1] == "checks"
    assert all(set(c) == {"value", "limit"} for c in result["checks"].values())
    json.dumps(result)


@pytest.mark.parametrize("name", ["deepseek_llm_7b.take", "deepseek_llm_7b.read"])
def test_traced_window_reads_the_program_counters(name):
    result = run_tiny(name, trace=True)
    assert result["correct"] is True
    # on the CPU the trace holds no device time: no roofline or idle
    # share is read, the program's phase seconds are
    assert all("roofline" not in k and "idle" not in k for k in result["metrics"])
    assert result["device"]["busy_s"] == 0.0 and result["device"]["window_s"] > 0
    if name.endswith(".take"):
        stage = [v["value"] for k, v in result["metrics"].items() if k.startswith("stage_ms.")]
        assert stage and all(v > 0 for v in stage)


def test_run_refuses_without_a_gpu_and_prints_no_result():
    if __import__("torch").cuda.is_available():
        pytest.skip("this machine has a GPU")
    p = subprocess.run(
        [sys.executable, os.path.join(harness.HERE, "run.py"), "--workload", CELLS[0], "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=120,
    )
    assert p.returncode != 0 and p.stdout.strip() == ""
