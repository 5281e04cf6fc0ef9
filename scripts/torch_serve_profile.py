"""Where a served batch's time goes on one NVIDIA GPU, for the PyTorch port.

    python3 scripts/torch_serve_profile.py [--reps 20] [--trace PATH]

Runs `sfa3d_tpu_torch.Detector(device="cuda")` (fpn_resnet_18, 608x608,
32768 padded points, K=50, random weights from a fixed seed) on
KITTI-like numpy scans and prints one JSON line each for:

  bucket   host wall time of one `detect_batch` call (numpy in, numpy out,
           the call the batching server makes) at batch 1, 2, 4 and 8,
           median over --reps, float32 with TF32 off (the parity mode)
  tf32     the same at batch 8 with cuDNN/matmul TF32 on (an opt-in fast
           mode; its detections are not held to the 1e-3 parity here)
  profile  torch.profiler over --reps batch-8 calls: device time by kernel
           (top 15), by kernel family, the device's busy share of the wall
           time, and the BEV tile kernel's own device time

The last line is the card's name and power limit from nvidia-smi. Needs
CUDA; exits non-zero without it. --trace writes a Chrome trace.
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

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import bump_heatmap_bias, make_scan  # noqa: E402
from sfa3d_tpu_torch.detector import Detector  # noqa: E402
from sfa3d_tpu_torch.ops.bev import filter_and_pad_points  # noqa: E402

FAMILIES = (
    ("bev_tile_kernel", r"bev_tile_kernel"),
    ("conv_gemm", r"conv|cudnn|gemm|xmma|implicit|winograd|fft|sm90|sm80|cutlass"),
    ("memcpy_memset", r"[Mm]emcpy|[Mm]emset"),
    ("reduce_sort_topk", r"reduce|sort|topk|scatter|gather|index|radix|bitonic"),
)


def wall_ms(fn, reps: int) -> float:
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def self_device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--trace", default=None, help="write a Chrome trace here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_serve_profile: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]

    det = Detector(device="cuda", seed=0)
    bump_heatmap_bias(det.model)
    rng = np.random.default_rng(7)
    padded = [filter_and_pad_points(make_scan(rng)) for _ in range(8)]
    pts = np.stack([p for p, _ in padded])
    valid = np.stack([v for _, v in padded])

    for b in (1, 2, 4, 8):
        ms = wall_ms(lambda: det.detect_batch(pts[:b], valid[:b]), args.reps)
        print(json.dumps({"bucket": b, "batch_ms": ms, "frames_per_s": b / ms * 1e3,
                          "mode": "float32, TF32 off", "card": smi}), flush=True)

    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    ms = wall_ms(lambda: det.detect_batch(pts, valid), args.reps)
    print(json.dumps({"tf32": True, "bucket": 8, "batch_ms": ms,
                      "frames_per_s": 8 / ms * 1e3, "card": smi}), flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    det.detect_batch(pts, valid)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.reps):
            det.detect_batch(pts, valid)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
        prof.export_chrome_trace(args.trace)

    events = prof.key_averages()
    on_device = [e for e in events
                 if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    kernels = [(e.key, e.count, self_device_us(e)) for e in (on_device or events)]
    kernels = [k for k in kernels if k[2] > 0]
    device_us = sum(k[2] for k in kernels)
    families = {name: 0.0 for name, _ in FAMILIES}
    families["other"] = 0.0
    for key, _, us in kernels:
        fam = next((n for n, pat in FAMILIES if re.search(pat, key)), "other")
        families[fam] += us
    top = sorted(kernels, key=lambda k: -k[2])[:15]
    bev_us = sum(us for key, _, us in kernels if re.search(FAMILIES[0][1], key))
    print(json.dumps({
        "profile": {"bucket": 8, "batches": args.reps,
                    "wall_ms_per_batch": wall_us / args.reps / 1e3,
                    "device_ms_per_batch": device_us / args.reps / 1e3,
                    "device_busy_share": device_us / wall_us if wall_us else None,
                    "bev_kernel_device_us_per_batch": bev_us / args.reps,
                    "families_ms_per_batch": {k: v / args.reps / 1e3 for k, v in families.items()},
                    "top_kernels": [{"name": k[:120], "calls_per_batch": c / args.reps,
                                     "ms_per_batch": us / args.reps / 1e3} for k, c, us in top]},
        "card": smi}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
