"""Finds what a cell names, by name, under `perfbench/`.

`BENCHMARK.json` at the root of the checkout names each cell's
configuration and traffic mix, and each per-layer metric. Each of them is a
file of its own, found here by that name, so a later change adds a cell, a
mix or a metric by adding files and entries, never by editing one:

    configs/<config>.json     sizes, precision, conditioning, limits
    traffic/<traffic>.json    the mix's parameters; its "driver" names
                              drivers/<driver>.py, which runs the window
    metrics/<metric>.py       read(ctx) -> number or None
    counts/<name>.py          operations and bytes of a model or kernel
    systems/<system>.py       builds the port's entry for a configuration
    reference/<name>.py       the plain reference a configuration names
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def check_name(name: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def find_workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"BENCHMARK.json has no workload {name!r}")


def load_json(kind: str, name: str, bench_dir: Path = BENCH_DIR) -> dict:
    path = bench_dir / kind / f"{check_name(name)}.json"
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    """perfbench/<kind>/<name>.py as a module (names may hold '.' and '-',
    so it is loaded from its path, once per process)."""
    path = bench_dir / kind / f"{check_name(name)}.py"
    key = "perfbench_" + kind + "_" + re.sub(r"[^A-Za-z0-9_]", "_", name) + "_" + str(abs(hash(str(path))))
    mod = sys.modules.get(key)
    if mod is not None:
        return mod
    if not path.is_file():
        raise FileNotFoundError(f"{path} (named by the benchmark) does not exist")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, workload: str, section: str) -> Dict[str, dict]:
    """The metrics of `section` ("end_to_end" or "per_layer") that the
    cell reports: those with no "workloads" key, and those that list it."""
    out = {}
    for m in bench[section]:
        cells: Optional[list] = m.get("workloads")
        if cells is None or workload in cells:
            out[m["name"]] = m
    return out
