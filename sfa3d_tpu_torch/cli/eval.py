"""KITTI AP evaluation of the port, the counterpart of
`sfa3d_tpu/cli/eval.py`:

    python -m sfa3d_tpu_torch.cli.eval --dataset_dir DIR --pretrained_path CKPT.pth [flags]

Runs the LiDAR detector (`pipeline.detect_frames`: one `bev_raster_reduce`
launch per frame) over a split, projects each detection into the image for
the devkit's minimum-height rule, and prints per-class 3D (or BEV) AP and
AOS, then the Easy / Moderate / Hard table (`eval/kitti_eval.py`).
`--save_results DIR` also writes KITTI submission-format label files;
`--use_ema` evaluates the EMA weights of a port training checkpoint. It
runs on cuda (raising without a GPU) unless `--platform cpu` is given.
Returns the results dict, with the table under "by_difficulty".
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

CLASS_NAMES = {0: "Pedestrian", 1: "Car", 2: "Cyclist"}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="sfa3d_tpu_torch KITTI AP evaluation")
    p.add_argument("--arch", type=str, default="fpn_resnet_18")
    p.add_argument("--pretrained_path", type=str, default=None)
    p.add_argument("--dataset_dir", type=str, default="./dataset/kitti")
    p.add_argument("--split", type=str, default="val", choices=["train", "val"])
    p.add_argument("--K", type=int, default=50)
    p.add_argument("--peak_thresh", type=float, default=0.2)
    p.add_argument("--metric", type=str, default="3d", choices=["3d", "bev"])
    p.add_argument("--num_samples", type=int, default=None)
    p.add_argument("--save_results", type=str, default=None, metavar="DIR",
                   help="also write per-frame KITTI submission-format label files "
                        "(camera-frame rows + score) under DIR")
    p.add_argument("--platform", type=str, default=None, choices=["cpu", "cuda"],
                   help="'cpu' runs on the CPU; the default is cuda")
    p.add_argument("--use_ema", action="store_true",
                   help="evaluate the EMA weights saved by an --ema_decay training run")
    return p.parse_args(argv)


def load_model(arch: str, pretrained_path, use_ema: bool, device: torch.device):
    """The KFPN of `arch` with the checkpoint's weights (random weights,
    with a warning, when there is none), in eval mode on `device`."""
    from sfa3d_tpu_torch.models import create_model
    from sfa3d_tpu_torch.models.port import load_torch_checkpoint

    model = create_model(arch)
    if pretrained_path:
        if not os.path.isfile(pretrained_path):
            raise FileNotFoundError(f"checkpoint not found: {pretrained_path} (expected a .pth file)")
        model.load_state_dict(load_torch_checkpoint(pretrained_path, use_ema=use_ema), strict=True)
    else:
        if use_ema:
            raise ValueError("--use_ema needs --pretrained_path")
        print("WARNING: no --pretrained_path given; using RANDOM weights", file=sys.stderr)
        model.init_weights(torch.Generator().manual_seed(0))
    return model.to(device).eval()


def main(argv=None):
    from sfa3d_tpu_torch.data.kitti import KittiDataset
    from sfa3d_tpu_torch.detector import format_detections, write_kitti_results
    from sfa3d_tpu_torch.device import resolve_device
    from sfa3d_tpu_torch.eval import evaluate_kitti_ap, evaluate_kitti_ap_by_difficulty
    from sfa3d_tpu_torch.fusion.boxes2d import project_boxes_to_image
    from sfa3d_tpu_torch.pipeline import detect_frames

    args = parse_args(argv)
    device = resolve_device("cpu" if args.platform == "cpu" else None)
    model = load_model(args.arch, args.pretrained_path, args.use_ema, device)
    dataset = KittiDataset(args.dataset_dir, mode=args.split, hflip_prob=0.0, num_samples=args.num_samples)

    detections, ground_truths = [], []
    for idx in range(len(dataset)):
        sample = dataset[idx]
        out = detect_frames(model, sample.points[None], sample.valid[None], K=args.K,
                            peak_thresh=args.peak_thresh, device=device)
        host = {k: out[k].cpu().numpy() for k in ("mask", "boxes_real", "detections")}
        mask, real, scores = host["mask"][0], host["boxes_real"][0], host["detections"][0, :, 0]
        det = {"boxes": real[mask][:, 1:8], "scores": scores[mask], "classes": real[mask][:, 0].astype(int)}
        if sample.calib is not None:
            # projected 2D heights feed the devkit's minimum-height rule in the
            # difficulty buckets; a detection outside the camera gets height 0
            b2d, v2d = project_boxes_to_image(
                out["boxes_real"][0], out["detections"][0, :, 0], out["mask"][0],
                np.asarray(sample.calib.V2C, np.float32), np.asarray(sample.calib.R0, np.float32),
                np.asarray(sample.calib.P2, np.float32), conf_gate=0.0)
            h2d = torch.where(v2d, b2d[:, 3], 0.0).cpu().numpy()
            det["heights"] = h2d[mask]
        detections.append(det)
        lab = sample.labels[: int(sample.n_labels)]
        gt = {"boxes": lab[:, 1:8], "classes": lab[:, 0].astype(int)}
        if sample.levels is not None:
            gt["difficulty"] = sample.levels[: int(sample.n_labels)]
        ground_truths.append(gt)
        if args.save_results:
            write_kitti_results(format_detections(host, 0), sample.calib,
                                os.path.join(args.save_results, f"{sample.sample_id:06d}.txt"))
        if (idx + 1) % 50 == 0:
            print(f"{idx + 1}/{len(dataset)} frames")

    results = evaluate_kitti_ap(detections, ground_truths, metric=args.metric, with_aos=True, device=device)
    for cls, name in CLASS_NAMES.items():
        key = f"AP_{cls}"
        if key in results:
            print(f"AP_{args.metric} {name}: {results[key] * 100:.2f}   AOS: {results[f'AOS_{cls}'] * 100:.2f}")
    print(f"mAP_{args.metric}: {results['mAP'] * 100:.2f}   mAOS: {results['mAOS'] * 100:.2f}")

    table = evaluate_kitti_ap_by_difficulty(detections, ground_truths, metric=args.metric, device=device)
    print(f"{'class':<12}" + "".join(f"{b:>10}" for b in table))
    for cls, name in CLASS_NAMES.items():
        row = [table[b].get(f"AP_{cls}") for b in table]
        if any(v is not None for v in row):
            print(f"{name:<12}" + "".join(f"{(v * 100 if v is not None else float('nan')):>10.2f}" for v in row))
    print(f"{'mAP':<12}" + "".join(f"{table[b]['mAP'] * 100:>10.2f}" for b in table))
    results["by_difficulty"] = table
    return results


if __name__ == "__main__":
    main()
