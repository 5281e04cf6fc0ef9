"""On the card: each cell's control (the reference put in the program's
place in TF32) fails at least one of the cell's compared numbers. `tools/calibrate.py` measures the same
at the cell's size on more seeds; this keeps one seed of it as a test.
Without CUDA it skips."""

import json
from pathlib import Path

import pytest
import torch

from perfbench.harness import registry
from perfbench.harness.bench import cell_config

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_a_limit(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control is TF32, which only the card computes")
    cfg, traffic = cell_config(registry.find_workload(registry.load_benchmark(), cell))
    ref = registry.load_module("reference", cfg["reference"])
    for kind, readings in ref.control_readings(cfg, traffic, 4242424242, torch.device("cuda")).items():
        failed = [k for k, limit in cfg["limits"].items() if readings[k] > limit]
        assert failed, f"the {kind} control passes every limit: {readings}"
