"""A run without a card fails and prints no result: there is no CPU
fallback. A checkout that holds only the benchmark fails too."""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]


def run(cwd, workload):
    return subprocess.run([sys.executable, "perfbench/run.py", "--workload", workload, "--seed", "5",
                           "--seconds", "1", "--trace", "0"], cwd=cwd, capture_output=True, text=True,
                          timeout=300)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    import json

    workload = json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"][0]["name"]
    p = run(ROOT, workload)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA device" in p.stderr


def test_benchmark_alone_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    import json

    workload = json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"][0]["name"]
    p = run(tmp_path, workload)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
