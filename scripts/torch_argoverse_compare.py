"""The BEV tile kernel's entries of one checkout of the repo, timed on one
GPU, so that two commits can be compared in turns.

    python3 scripts/torch_argoverse_compare.py [--root DIR] [--label NAME]

Imports `sfa3d_tpu_torch` from --root (default: the checkout holding this
script), builds its kernels, and prints one JSON line per shape, each on
seeded random inputs (about 70% of the points in the raster) and with the
card's name and power limit from nvidia-smi:

  bev_raster_reduce at (8, 32768) -> 608 x 608 (the served batch)
  argoverse_raster_reduce at (1, 16 and 64, 131072) -> 1000 x 1000

  ms            CUDA events around one wrapper call, median of 30
  device_ms     device time of one call, every kernel and memset summed
                (torch.profiler)
  gap_ms        ms - device_ms: the host's share of a call
  enqueue_us    host time of one call, from 100 calls made back to back
                with no synchronisation between them, median of 5
  kernels       launches a call by kernel name

With --against DIR (a checkout whose `build/kernels/libbev_counts-*.so`
a run of this script there has built), one more line: both libraries
loaded in this process, their `bev_raster_reduce_cuda` called directly
(no Python wrapper) in turns, 20 rounds of 200 calls each on one small
frame (1024 points: the device keeps up, so the launch queue never
fills), host microseconds per call, median and every round: the C entry's
host cost in the two checkouts without the noise between processes.

Needs CUDA; exits non-zero without it.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time

KERNELS = r"bev_tile_kernel|argoverse_band_\w+_kernel|Memset"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--label", default=None, help="name of the checkout in the output")
    ap.add_argument("--against", default=None, help="a built checkout whose raster C entry to time in turns")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_argoverse_compare: no CUDA device", file=sys.stderr)
        return 1
    from sfa3d_tpu_torch.ops import bev_counts

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(0)

    def indices(b, n, h, w):
        row = rng.integers(0, h, (b, n)).astype(np.int32)
        col = rng.integers(0, w, (b, n)).astype(np.int32)
        drop = rng.random((b, n)) < 0.3
        row[drop] = col[drop] = -1
        return torch.from_numpy(row).to(dev), torch.from_numpy(col).to(dev)

    def event_ms(fn, reps=30):
        for _ in range(3):
            fn()
        times = []
        for _ in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def device(fn, reps=20):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total, kernels = 0.0, {}
        for e in prof.key_averages():
            m = re.search(KERNELS, e.key)
            us = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
            if m and us > 0:
                total += us
                kernels[m.group(0)] = kernels.get(m.group(0), 0) + e.count / reps
        return total / reps / 1e3, kernels

    def enqueue_us(fn, calls=100):
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            times.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
        return statistics.median(times)

    def report(entry, shape, fn):
        ms = event_ms(fn)
        dms, kernels = device(fn)
        print(json.dumps({"label": args.label, "root": os.path.abspath(args.root), "entry": entry,
                          "shape": shape, "ms": ms, "device_ms": dms, "gap_ms": ms - dms,
                          "enqueue_us": enqueue_us(fn), "kernels": kernels, "card": smi}), flush=True)

    row, col = indices(8, 32768, 608, 608)
    key = torch.from_numpy(rng.integers(0, 1 << 25, (8, 32768)).astype(np.int32)).to(dev)
    key = torch.where(row >= 0, key, -1)
    report("bev_raster_reduce", [8, 32768, 608, 608], lambda: bev_counts.bev_raster_reduce(row, col, key))
    for b in (1, 16, 64):
        row, col = indices(b, 131072, 1000, 1000)
        z = torch.from_numpy(rng.uniform(-3, 5, (b, 131072)).astype(np.float32)).to(dev)
        r = torch.from_numpy(rng.uniform(-0.1, 1, (b, 131072)).astype(np.float32)).to(dev)
        report("argoverse_raster_reduce", [b, 131072, 1000, 1000],
               lambda: bev_counts.argoverse_raster_reduce(row, col, z, r, 1000, 1000))
    if args.against:
        c_entries_in_turns(args, bev_counts, dev, smi)
    return 0


def c_entries_in_turns(args, bev_counts, dev, smi) -> None:
    """Host us per direct call of each checkout's bev_raster_reduce_cuda,
    in turns in this process (see the module docstring)."""
    import ctypes
    import glob

    import numpy as np
    import torch

    from sfa3d_tpu_torch import _build

    (other,) = glob.glob(os.path.join(os.path.abspath(args.against), "build", "kernels", "libbev_counts-*.so"))
    libs = {"this": _build.library_path("bev_counts"), "against": other}
    b, n, h, w = 1, 1024, 608, 608
    rng = np.random.default_rng(1)
    row = torch.from_numpy(rng.integers(0, h, (b, n)).astype(np.int32)).to(dev)
    col = torch.from_numpy(rng.integers(0, w, (b, n)).astype(np.int32)).to(dev)
    key = torch.from_numpy(rng.integers(0, 1 << 25, (b, n)).astype(np.int32)).to(dev)
    out = torch.empty((b, 3, h, w), device=dev)
    tile_rows, n_tiles = bev_counts.tile_plan(b, h, w, bev_counts.RASTER_BYTES_PER_CELL, bev_counts.shared_memory_limit(dev))
    stream = torch.cuda.current_stream(dev).cuda_stream
    calls = {}
    for name, path in libs.items():
        fn = ctypes.CDLL(str(path)).bev_raster_reduce_cuda
        fn.restype, fn.argtypes = bev_counts._SIGNATURES["bev_raster_reduce_cuda"]
        a = (row.data_ptr(), col.data_ptr(), key.data_ptr(), out.data_ptr(), b, n, h, w, tile_rows, n_tiles,
             1.0 / 4095, 1.0 / 8191, 0.24, dev.index, stream)
        calls[name] = (fn, a)
    rounds = {name: [] for name in calls}
    for _ in range(20):
        for name, (fn, a) in calls.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                if fn(*a) != 0:
                    raise RuntimeError(f"{name}: bev_raster_reduce_cuda failed")
            rounds[name].append((time.perf_counter() - t0) / 200 * 1e6)
            torch.cuda.synchronize()
    print(json.dumps({"label": args.label, "c_entry": "bev_raster_reduce_cuda", "shape": [b, n, h, w],
                      "libraries": {k: str(v) for k, v in libs.items()},
                      "host_us_per_call_median": {k: statistics.median(v) for k, v in rounds.items()},
                      "host_us_per_call_rounds": rounds, "card": smi}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
