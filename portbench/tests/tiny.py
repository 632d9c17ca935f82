"""Tiny configurations and a CPU run of a cell, for the tests."""

from __future__ import annotations

import time
from typing import Any, Dict

from portbench import harness

TINY = {
    "lm_adamw": dict(hidden_size=64, intermediate_size=128, num_attention_heads=4,
                     num_key_value_heads=4, vocab_size=512, max_position_embeddings=64),
    "dlrm_adagrad": dict(table_rows=[64, 3, 17, 1000], embedding_dim=8, dense_features=4,
                         bottom_mlp=[4, 16, 8], top_mlp=[16, 1]),
}
CELLS = [w["name"] for w in harness.load_spec()["workloads"]]
SEED = 2**31 + 977  # more than 32 signed bits hold


def tiny_cell(name: str) -> harness.Cell:
    cell = harness.resolve(harness.load_spec(), name)
    cell.config.update(TINY[cell.config["builder"]])
    return cell


def run_tiny(name: str, seconds: float = 0.5, trace: bool = False, seed: int = SEED) -> Dict[str, Any]:
    """One run of the cell at a tiny size on the CPU: everything a run
    does but the look for a GPU."""
    return harness.run_cell(tiny_cell(name), seed, seconds, trace, "cpu", time.perf_counter())
