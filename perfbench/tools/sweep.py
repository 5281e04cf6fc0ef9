"""Sweep one parameter of a traffic mix on the card: the knee of an
open-loop cell (the highest rate without a growing backlog), or the client
count of a closed loop. Run by hand when a cell is defined; the cell then
names a traffic file with the value fixed.

    python3 perfbench/tools/sweep.py --config kfpn18-bev608-fp32 \
        --traffic open-poisson-200 --param rate_per_s --values 230,250,270 \
        [--seconds 10] [--repeats 1]

Each value (each repeat) runs in a fresh process, as a run of the cell
does: the system built, the mix's buckets warmed through the server, then
one window through the mix's driver. A line each: requests, answered in the window a second,
p50 and p95 latency over the window and over its first and last fifth (a
backlog that grows makes the last fifth climb), frames a batch, and the
mean device-call and submit times. Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def pct(values, q):
    v = sorted(values)
    return v[max(0, math.ceil(q * len(v)) - 1)] if v else None


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--param", required=True)
    ap.add_argument("--values", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--repeats", type=int, default=1)
    ap.add_argument("--seed", type=int, default=424242)
    args = ap.parse_args()
    values = args.values.split(",")
    if len(values) > 1 or args.repeats > 1:
        for value in values:
            for rep in range(args.repeats):
                cmd = [sys.executable, __file__, "--config", args.config, "--traffic", args.traffic,
                       "--param", args.param, "--values", value, "--seconds", str(args.seconds),
                       "--seed", str(args.seed + rep)]
                if subprocess.run(cmd).returncode != 0:
                    return 1
        return 0
    import torch

    from perfbench.harness import registry
    from perfbench.harness.bench import set_precision
    from perfbench.harness.spans import Spans

    cfg = registry.load_json("configs", args.config)
    traffic = registry.load_json("traffic", args.traffic)
    set_precision(cfg)
    spans = Spans()
    system = registry.load_module("systems", cfg["system"]).System(cfg, args.seed, torch.device("cuda"), spans)
    pool = system.pool(args.seed, int(traffic["pool"]))
    warm = traffic.get("warm", "all")
    system.warm(system.buckets() if warm == "all" else [int(b) for b in warm], pool[0])
    driver = registry.load_module("drivers", traffic["driver"])
    value = float(values[0])
    try:
        before = dict(system.counters())
        w = driver.run(system, {**traffic, args.param: value}, pool, args.seconds, args.seed)
        after = system.counters()
        done = sorted(w.requests, key=lambda r: r.start)
        lat = [(r.end - r.start) * 1e3 if r.end is not None and r.error is None else math.inf for r in done]
        fifth = max(1, len(lat) // 5)
        print(json.dumps({
            args.param: value, "seed": args.seed, "requests": len(lat), "failed": w.failed(),
            "answered_in_window_per_s": sum(1 for r in w.answered() if r.end <= w.end) / w.seconds,
            "p50_ms": pct(lat, 0.5), "p95_ms": pct(lat, 0.95),
            "p95_first_fifth_ms": pct(lat[:fifth], 0.95), "p95_last_fifth_ms": pct(lat[-fifth:], 0.95),
            "batch_frames": (after["served"] - before["served"]) / max(1, after["batches"] - before["batches"]),
            "device_call_ms": spans.mean_ms("device_call", w.start, w.end),
            "submit_ms": spans.mean_ms("submit", w.start, w.end), **w.notes}), flush=True)
    finally:
        system.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
