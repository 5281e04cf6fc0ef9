"""bfloat16 against float32 serving, and the bfloat16 training step, of the
PyTorch port on one GPU, for one checkout of the repo, so that two trees
can be compared in turns (parent, change, change, parent).

    python3 scripts/torch_bf16_compare.py [--root DIR] [--label NAME] [--reps 20]

Imports `sfa3d_tpu_torch` and `chip_smoke` (for its weights, scans and
requests) from --root (default: the checkout holding this script), builds
its kernels, and prints one JSON line (strict float32: TF32 off):

  lidar_ms_bucket{1,8}_{float32,bfloat16}
        host wall time of one Detector.detect_batch call (numpy in and out),
        median of --reps, on fused_serve's conditioned KFPN weights and
        scans (fpn_resnet_18, 608 x 608, 32768 padded points)
  fused_ms_bucket{1,8}_{float32,bfloat16}
        the same for FusedDetector.run_batch (YOLOv8n, 224 x 640 canvas)
  kernels_bucket1_{float32,bfloat16}, device_ms_bucket1_{...}
        CUDA kernels a bucket-1 detect_batch launches and their summed
        device time (torch.profiler)
  top_host_ops_bucket1_{...}, top_kernels_bucket1_{...}
        the operators with the most host self time, and the kernels with
        the most device time, in a bucket-1 detect_batch: [name, calls, ms]
  train_step_ms_{float32,bfloat16}
        CUDA-event ms of one training step (the CLI's fpn_resnet_18 at 608 x
        608, batch 16, S = 1, Adam) on a 16-frame synthetic mini-KITTI,
        median of the steps after the first

Each Detector of a dtype is built from the same saved weights.
--channels_last also turns the bfloat16 networks to channels-last memory
(an experiment; no entry point does it). --no_train skips the training
step. The line
carries the card's name and power limit from nvidia-smi. Needs CUDA;
exits non-zero without it.
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

TRAIN_FRAMES = 16
TRAIN_STEPS = 6


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--label", default=None, help="name of the checkout in the output")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--channels_last", action="store_true")
    ap.add_argument("--no_train", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_bf16_compare: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from sfa3d_tpu_torch import _build
    from sfa3d_tpu_torch.detector import Detector, FusedDetector
    from sfa3d_tpu_torch.models.yolov8 import letterbox
    from sfa3d_tpu_torch.ops import bev as bev_ops

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    _build.build_libraries()
    out = {"label": args.label or os.path.abspath(args.root)}

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

    def profile_of(fn, dt):
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        cuda = [e for e in events if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
        host = [e for e in events if getattr(e, "device_type", None) == torch.autograd.DeviceType.CPU]
        dev_us = [getattr(e, "self_device_time_total", 0.0) for e in cuda]
        out[f"kernels_bucket1_{dt}"] = sum(e.count for e in cuda)
        out[f"device_ms_bucket1_{dt}"] = sum(dev_us) / 1e3
        out[f"top_kernels_bucket1_{dt}"] = [[e.key[:90], e.count, us / 1e3] for e, us in
                                           sorted(zip(cuda, dev_us), key=lambda p: -p[1])[:6]]
        out[f"top_host_ops_bucket1_{dt}"] = [[e.key[:60], e.count, e.self_cpu_time_total / 1e3] for e in
                                             sorted(host, key=lambda e: -e.self_cpu_time_total)[:8]]

    reqs = cs.fused_requests(8)
    base = FusedDetector(imgsz=cs.CANVAS, device="cuda", seed=cs.SEED)
    cs.bump_fused_biases(base, cs.yolo_gate_bias(base.yolo, reqs[0][1]))
    prepared = []
    for points, image, calib in reqs:
        pts, valid = bev_ops.filter_and_pad_points(points, cs.N)
        img, r, pad = letterbox(image, cs.CANVAS)
        prepared.append((pts, valid, img, calib.V2C.astype(np.float32), calib.R0.astype(np.float32),
                         calib.P2.astype(np.float32), np.float32(cs.IMG_HW), np.float32(r), np.float32(pad)))
    batch = [np.stack(a) for a in zip(*prepared)]
    with tempfile.TemporaryDirectory() as tmp:
        kfpn_path, yolo_path = os.path.join(tmp, "kfpn.pth"), os.path.join(tmp, "yolov8n.pt")
        torch.save(base.kfpn.state_dict(), kfpn_path)
        torch.save({"model": base.yolo.state_dict()}, yolo_path)
        del base
        for dt in ("float32", "bfloat16"):
            det = Detector(checkpoint=kfpn_path, device="cuda", dtype=dt)
            fd = FusedDetector(checkpoint=kfpn_path, yolo_checkpoint=yolo_path, imgsz=cs.CANVAS, device="cuda",
                               dtype=dt)
            if args.channels_last and dt == "bfloat16":
                for m in (det.model, fd.kfpn, fd.yolo):
                    m.to(memory_format=torch.channels_last)
            for b in (1, 8):
                out[f"lidar_ms_bucket{b}_{dt}"] = wall_ms(lambda: det.detect_batch(batch[0][:b], batch[1][:b]))
                out[f"fused_ms_bucket{b}_{dt}"] = wall_ms(lambda: fd.run_batch(*[a[:b] for a in batch]))
            profile_of(lambda: det.detect_batch(batch[0][:1], batch[1][:1]), dt)
            del det, fd
        if not args.no_train:
            out.update(train_step_ms(cs, tmp))
    out["card"] = smi
    print(json.dumps(out), flush=True)
    return 0


def train_step_ms(cs, tmp):
    """CUDA-event ms of the training step in each compute dtype, on one
    16-frame batch of a synthetic mini-KITTI through the CLI's loader."""
    import torch

    from sfa3d_tpu_torch.config.train import parse_train_configs
    from sfa3d_tpu_torch.data.loader import create_train_loader
    from sfa3d_tpu_torch.data.synthetic import write_mini_kitti
    from sfa3d_tpu_torch.models import create_model
    from sfa3d_tpu_torch.parallel import create_train_state, make_train_step
    from sfa3d_tpu_torch.runtime.schedules import create_optimizer

    root = write_mini_kitti(os.path.join(tmp, "kitti"), n_frames=TRAIN_FRAMES, seed=cs.SEED,
                            splits={"train": range(TRAIN_FRAMES), "val": range(2)})
    configs = parse_train_configs(["--dataset_dir", root, "--root-dir", os.path.join(tmp, "run"),
                                   "--seed", str(cs.SEED), "--batch_size", str(TRAIN_FRAMES),
                                   "--effective_batch", str(TRAIN_FRAMES)])
    loader = create_train_loader(configs, device=cs.DEVICE)
    batch = next(iter(cs._epoch_batches(loader, 1)))
    init_sd = create_model("fpn_resnet_18").init_weights(torch.Generator().manual_seed(cs.SEED)).state_dict()
    out = {}
    for dt in ("float32", "bfloat16"):
        model = cs._train_model(init_sd).to(cs.DEVICE)
        spec = create_optimizer(configs.optim, 1, TRAIN_STEPS)
        step = make_train_step(model, spec, compute_dtype=dt, device=cs.DEVICE)
        _, ms, losses, _, _ = cs._timed_steps(step, create_train_state(model, spec), [batch] * TRAIN_STEPS)
        out[f"train_step_ms_{dt}"] = statistics.median(ms[1:])
        out[f"train_losses_{dt}"] = losses
        del model, step
    return out


if __name__ == "__main__":
    sys.exit(main())
