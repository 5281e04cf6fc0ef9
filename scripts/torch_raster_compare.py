"""The BEV raster stage and per-batch time of the PyTorch port's LiDAR and
fused paths, on one GPU, for one checkout of the repo, so that two commits
can be compared in turns.

    python3 scripts/torch_raster_compare.py [--root DIR] [--label NAME] [--reps 30]

Imports `sfa3d_tpu_torch` and `chip_smoke` (for its scan generator) from
--root (default: the checkout holding this script), builds its kernels, and
prints one JSON line, on 8 KITTI-like scans (fpn_resnet_18, 608x608, 32768
padded points, float32, TF32 off):

  raster_ms     points_to_bev_nchw at batch 8, CUDA events, median of --reps
  prelude_ms    cell_indices_and_keys (the elementwise half of the raster)
  reduce_ms     raster_ms - prelude_ms: what follows the prelude
  raster_device_ms, raster_kernels
                device time and number of kernel launches of one raster call,
                from torch.profiler
  batch_ms_bucket1, batch_ms_bucket8, frames_per_s_bucket8
                host wall time of one Detector.detect_batch call (numpy in and
                out, the call the batching server makes), median of --reps
  raster_enqueue_us
                host time per bev_raster_reduce call at batch 8, 200 calls
                with no synchronisation between them (what the caller's
                thread pays to enqueue the kernel)
  fused_batch_ms_bucket1, fused_batch_ms_bucket8
                host wall time of one FusedDetector.run_batch call at the
                224x640 canvas on 375x1242 frames (chip_smoke's fused_serve
                weights and requests), median of --reps

The line carries the card's name and power limit from nvidia-smi. Needs
CUDA; exits non-zero without it.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--label", default=None, help="name of the checkout in the output")
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_raster_compare: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import bump_heatmap_bias, make_scan
    from sfa3d_tpu_torch import _build
    from sfa3d_tpu_torch.detector import Detector
    from sfa3d_tpu_torch.ops import bev as bev_ops

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    _build.build_libraries()

    def cuda_ms(fn):
        for _ in range(3):
            fn()
        times = []
        for _ in range(args.reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def wall_ms(fn):
        for _ in range(3):
            fn()
        times = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    det = Detector(device="cuda", seed=0)
    bump_heatmap_bias(det.model)
    rng = np.random.default_rng(7)
    padded = [bev_ops.filter_and_pad_points(make_scan(rng)) for _ in range(8)]
    pts = np.stack([p for p, _ in padded])
    valid = np.stack([v for _, v in padded])
    pts_d, valid_d = torch.from_numpy(pts).cuda(), torch.from_numpy(valid).cuda()

    out = {"label": args.label or os.path.abspath(args.root)}
    with torch.inference_mode():
        out["raster_ms"] = cuda_ms(lambda: bev_ops.points_to_bev_nchw(pts_d, valid_d))
        out["prelude_ms"] = cuda_ms(lambda: bev_ops.cell_indices_and_keys(pts_d, valid_d))
        out["reduce_ms"] = out["raster_ms"] - out["prelude_ms"]
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(args.reps):
                bev_ops.points_to_bev_nchw(pts_d, valid_d)
            torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    device_us = sum(getattr(e, "self_device_time_total", 0.0) for e in kernels)
    out["raster_device_ms"] = device_us / args.reps / 1e3
    out["raster_kernels"] = sum(e.count for e in kernels) / args.reps
    for bucket in (1, 8):
        out[f"batch_ms_bucket{bucket}"] = wall_ms(
            lambda: det.detect_batch(pts[:bucket], valid[:bucket]))
    out["frames_per_s_bucket8"] = 8 / out["batch_ms_bucket8"] * 1e3
    with torch.inference_mode():
        idx = bev_ops.cell_indices_and_keys(pts_d, valid_d)
        bev_ops.bev_raster_reduce(*idx)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            bev_ops.bev_raster_reduce(*idx)
        out["raster_enqueue_us"] = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
    out.update(fused_batch_ms(wall_ms))
    out["card"] = smi
    print(json.dumps(out), flush=True)
    return 0


def fused_batch_ms(wall_ms):
    """{fused_batch_ms_bucket1, fused_batch_ms_bucket8}: FusedDetector.run_batch
    on chip_smoke's conditioned fused weights and requests."""
    import numpy as np

    from chip_smoke import CANVAS, IMG_HW, bump_fused_biases, fused_requests, yolo_gate_bias
    from sfa3d_tpu_torch.detector import FusedDetector
    from sfa3d_tpu_torch.models.yolov8 import letterbox
    from sfa3d_tpu_torch.ops.bev import filter_and_pad_points

    reqs = fused_requests(8)
    fd = FusedDetector(imgsz=CANVAS, device="cuda", seed=0)
    bump_fused_biases(fd, yolo_gate_bias(fd.yolo, reqs[0][1]))
    rows = []
    for points, image, calib in reqs:
        pts, valid = filter_and_pad_points(points)
        img, r, pad = letterbox(image, CANVAS)
        rows.append((pts, valid, img, *(np.float32(m) for m in (calib.V2C, calib.R0, calib.P2)),
                     np.float32(IMG_HW), np.float32(r), np.float32(pad)))
    batch = [np.stack(a) for a in zip(*rows)]
    return {f"fused_batch_ms_bucket{b}": wall_ms(lambda: fd.run_batch(*[a[:b] for a in batch])) for b in (1, 8)}


if __name__ == "__main__":
    sys.exit(main())
