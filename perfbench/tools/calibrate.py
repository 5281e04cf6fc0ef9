"""The readings that a cell's limits are set from, on the card.

    python3 perfbench/tools/calibrate.py --workload lidar-closed-b8 \
        --seeds 11,12,13 --control-seeds 21,22,23 [--seconds 4]

Lower readings: the program, run by the harness as a run of the cell runs
it (its window at the cell's load, for --seconds), on each of --seeds.
Upper readings: the reference module's `control_readings` on each of
--control-seeds: the control, the reference put in the program's place and
computed with TF32 on (the nearest precision below the configuration's
float32 with TF32 off), judged against the float32 reference. Prints one JSON line a seed and a summary
line: the largest lower reading and, by kind, the smallest upper reading
of each number. Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=4.0)
    args = ap.parse_args()
    import torch

    from perfbench.harness import registry
    from perfbench.harness.bench import cell_config, run_cell

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    lower, upper = {}, {}
    for s in [int(x) for x in args.seeds.split(",") if x]:
        res = run_cell(args.workload, s, args.seconds, False, time.perf_counter())
        vals = res["notes"]["readings"]
        print(json.dumps({"program_seed": s, "correct": res["correct"], "readings": vals,
                          "metrics": res["metrics"], "notes": res["notes"]}), flush=True)
        for k, v in vals.items():
            lower[k] = max(lower.get(k, 0.0), v if v is not None else float("inf"))
    cfg, traffic = cell_config(registry.find_workload(registry.load_benchmark(ROOT), args.workload))
    ref = registry.load_module("reference", cfg["reference"])
    for s in [int(x) for x in args.control_seeds.split(",") if x]:
        kinds = ref.control_readings(cfg, traffic, s, torch.device("cuda"))
        print(json.dumps({"control_seed": s, "readings": kinds}), flush=True)
        for kind, vals in kinds.items():
            for k, v in vals.items():
                upper.setdefault(kind, {})[k] = min(upper.get(kind, {}).get(k, float("inf")), v)
    print(json.dumps({"workload": args.workload, "lower": lower, "upper": upper,
                      "card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
