"""The benchmark of the PyTorch + CUDA port (`sfa3d_tpu_torch`): one run of
one cell.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout, on a machine with the card(s) the cell
asks for. The last line of standard output is the result (JSON); the last
lines of standard error are the numbers compared with the reference, each
beside its limit. Without CUDA, or with fewer cards than the cell asks
for, it exits 2 and prints no result. It exits 3 and prints no result if
JAX or the JAX package was loaded. See perfbench/README.md.
"""

import time

T_SCRIPT = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def process_start() -> float:
    """The process's start on the perf_counter clock (from /proc; the
    script's first line where /proc cannot say)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return min(T_SCRIPT, time.perf_counter() - age)
    except (OSError, ValueError, IndexError):
        return T_SCRIPT


def main(argv=None) -> int:
    t_process = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    import torch

    from perfbench.harness import guard, registry
    from perfbench.harness.bench import run_cell

    bench = registry.load_benchmark(ROOT)
    cell = registry.find_workload(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: the cell needs {cell['chips']} CUDA device(s); this machine has {have}",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t_process, bench=bench)
    loaded = guard.forbidden_loaded()
    if loaded:
        print(f"perfbench: the run loaded {', '.join(loaded)}; no result", file=sys.stderr)
        return 3
    print(f"correct = {result['correct']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
