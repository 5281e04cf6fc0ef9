"""Where an exported program's time goes on one GPU, beside the live
program it was exported from.

    python3 scripts/torch_export_profile.py [--reps 10] [--top 12]

Builds the kernels, makes chip_smoke's export configurations (the LiDAR
detector at 608x608, 32768 points, K = 50, heatmap biases raised; the fused
program at a fixed batch of 8 on 375x1242 frames letterboxed onto 640, the
weights conditioned as chip_smoke conditions them), exports each, loads it
and prints one JSON line per program and batch with, for the artifact's
graph module and the live program on the same device tensors (strict
float32, in turns live / artifact / artifact / live):

  wall_ms        host wall time of one call ending in a synchronize, median
  enqueue_ms     host time of one call from an idle device, not waiting
  device_ms      the call's kernel time, summed (torch.profiler)
  kernels        kernel launches in one call
  cpu_top        the --top ATen / custom ops by self CPU time in one call
                 (name, calls, self CPU ms)

The line carries the card's name and power limit. Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_export_profile: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from sfa3d_tpu_torch import _build
    from sfa3d_tpu_torch.detector import ArtifactDetector, ArtifactFusedDetector, Detector, FusedDetector
    from sfa3d_tpu_torch.fusion.batch import FusedProgram
    from sfa3d_tpu_torch.models.yolov8 import letterbox
    from sfa3d_tpu_torch.ops.bev import filter_and_pad_points
    from sfa3d_tpu_torch.pipeline import detect_program
    from sfa3d_tpu_torch.runtime.export import export_detector, export_fused, letterbox_geometry, save_exported

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    _build.build_libraries()
    dev = torch.device("cuda")

    def wall_ms(fn):
        fn()
        times = []
        for _ in range(args.reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    def enqueue_ms(fn):
        fn()
        times = []
        for _ in range(args.reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        return statistics.median(times)

    def profile(fn):
        fn()
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        kernels = [e for e in events if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
        cpu = sorted((e for e in events if getattr(e, "device_type", None) == torch.autograd.DeviceType.CPU),
                     key=lambda e: -e.self_cpu_time_total)
        return {"device_ms": sum(cs.self_device_us(e) for e in kernels) / 1e3,
                "kernels": sum(e.count for e in kernels),
                "cpu_top": [[e.key, e.count, e.self_cpu_time_total / 1e3] for e in cpu[:args.top]]}

    def report(name, runs):
        out = {"program": name}
        for label in list(runs) + list(runs)[::-1]:
            rec = out.setdefault(label, {"wall_ms": [], "enqueue_ms": []})
            rec["wall_ms"].append(wall_ms(runs[label]))
            rec["enqueue_ms"].append(enqueue_ms(runs[label]))
        for label, fn in runs.items():
            out[label].update(profile(fn))
        out["card"] = smi
        print(json.dumps(out), flush=True)

    rng = np.random.default_rng(cs.SEED + 21)
    frames = [filter_and_pad_points(cs.make_scan(rng), cs.N) for _ in range(cs.EXPORT_BATCH)]
    pts = torch.from_numpy(np.stack([p for p, _ in frames])).to(dev)
    valid = torch.from_numpy(np.stack([v for _, v in frames])).to(dev)
    with tempfile.TemporaryDirectory() as tmp:
        det = Detector(device=dev, seed=cs.SEED)
        cs.bump_heatmap_bias(det.model)
        exported, manifest = export_detector(det.model, max_points=cs.N)
        save_exported(f"{tmp}/det.sfa3dt", exported, manifest)
        ad = ArtifactDetector(f"{tmp}/det.sfa3dt")
        with torch.inference_mode():
            for b in (1, 8):
                report(f"detector_bucket{b}", {
                    "live": lambda: detect_program(det.model, pts[:b], valid[:b], 50, 0.2),
                    "artifact": lambda: ad.artifact.module(pts[:b], valid[:b])})

        reqs = cs.fused_requests(cs.EXPORT_BATCH)
        fd = FusedDetector(imgsz=cs.EXPORT_LETTERBOX, device=dev, seed=cs.SEED)
        cs.bump_fused_biases(fd, cs.yolo_gate_bias(fd.yolo, reqs[0][1], cs.EXPORT_LETTERBOX))
        exported, manifest = export_fused(fd.kfpn, fd.yolo, batch=cs.EXPORT_BATCH, max_points=cs.N,
                                          img_hw=cs.IMG_HW, letterbox=cs.EXPORT_LETTERBOX)
        save_exported(f"{tmp}/fused.sfa3dt", exported, manifest)
        afd = ArtifactFusedDetector(f"{tmp}/fused.sfa3dt")
        scale, pad_x, pad_y = letterbox_geometry(cs.IMG_HW, cs.EXPORT_LETTERBOX)
        rows = []
        for points, image, calib in reqs:
            p, v = filter_and_pad_points(points, cs.N)
            rows.append((p, v, letterbox(image, cs.EXPORT_LETTERBOX)[0],
                         *(np.float32(m) for m in (calib.V2C, calib.R0, calib.P2)),
                         np.float32(cs.IMG_HW), np.float32(scale), np.float32([pad_x, pad_y])))
        with torch.inference_mode():
            on_card = [torch.from_numpy(np.stack(a)).to(dev) for a in zip(*rows)]
            program = FusedProgram(fd.kfpn, fd.yolo)
            report("fused_batch8", {"live": lambda: program(*on_card),
                                    "artifact": lambda: afd.artifact.module(*on_card[:6])})
    return 0


if __name__ == "__main__":
    sys.exit(main())
