"""Argoverse runner of the port, the counterpart of
`sfa3d_tpu/cli/argoverse_test.py`:

    python -m sfa3d_tpu_torch.cli.argoverse_test --dataset_dir DIR [flags]

For each paired sweep: the 1000 x 1000 Argoverse raster on the device (one
launch of the tile kernel's Argoverse mode), its centre 608 x 608 crop, the
KFPN detector and the decode to metric ego-frame boxes
(`pipeline.detect_bev`), the ground-truth 3D boxes projected into the
camera through the JSON SE3 calibration, one line per frame, and the raster
as `{timestamp}_bev.png` under `--output_dir` (its channels [density,
height, intensity] stored as B, G, R, the layout of the JAX runner's image).
The JAX runner also draws the projected boxes on the camera frame; that
composite needs a JPEG codec and a cv2-free drawing module, which the port
does not have yet, so it is not written. Weights come from a `.pth`
checkpoint (`--pretrained_path`, through `cli/eval.py::load_model`; random
weights with a warning without one). A frame that raises is reported with
its traceback and skipped, as in the JAX runner; `main` returns the number
of frames that failed. It runs on cuda (raising without a GPU) unless
`--platform cpu` is given.
"""

from __future__ import annotations

import argparse
import os
import traceback

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="sfa3d_tpu_torch Argoverse runner")
    p.add_argument("--dataset_dir", type=str, required=True)
    p.add_argument("--arch", type=str, default="fpn_resnet_18")
    p.add_argument("--pretrained_path", type=str, default=None)
    p.add_argument("--use_ema", action="store_true",
                   help="load the EMA weights of an --ema_decay run")
    p.add_argument("--target_camera", type=str, default="ring_front_center")
    p.add_argument("--peak_thresh", type=float, default=0.2)
    p.add_argument("--num_samples", type=int, default=None)
    p.add_argument("--output_dir", type=str, default="./results/argoverse")
    p.add_argument("--platform", type=str, default=None, choices=["cpu", "cuda"],
                   help="'cpu' runs on the CPU; the default is cuda")
    return p.parse_args(argv)


def project_ground_truth(sample):
    """Each ground-truth box's 8 corners projected into the target camera:
    a list of (8, 2) pixel arrays, None for a box with a corner behind the
    camera (the JAX runner draws only fully visible boxes)."""
    from sfa3d_tpu_torch.geometry.transforms import center_to_corner_box3d

    n = int(sample.n_labels)
    if sample.calib is None or n == 0:
        return []
    projected = []
    for corners in center_to_corner_box3d(sample.labels[:n, 1:8]):
        uv, valid = sample.calib.project_ego_to_image(corners)
        projected.append(uv if valid.all() else None)
    return projected


def main(argv=None, results=None) -> int:
    """Run over the dataset; returns the number of frames that failed. When
    `results` is a list, each answered frame's {"timestamp", "detections",
    "boxes_real", "mask", "gt_corners_uv"} (numpy) is appended to it."""
    from sfa3d_tpu_torch.cli.eval import load_model
    from sfa3d_tpu_torch.data.argoverse import ArgoverseDataset, crop_raster
    from sfa3d_tpu_torch.data.png import write_png_rgb
    from sfa3d_tpu_torch.device import resolve_device
    from sfa3d_tpu_torch.ops.bev import argoverse_points_to_bev_nchw
    from sfa3d_tpu_torch.pipeline import detect_bev

    args = parse_args(argv)
    device = resolve_device("cpu" if args.platform == "cpu" else None)
    os.makedirs(args.output_dir, exist_ok=True)
    model = load_model(args.arch, args.pretrained_path, args.use_ema, device)
    dataset = ArgoverseDataset(args.dataset_dir, mode="test", target_camera=args.target_camera,
                               num_samples=args.num_samples)
    print(f"Loaded {len(dataset)} Argoverse samples")

    failed = 0
    for idx in range(len(dataset)):
        try:
            sample = dataset[idx]
            with torch.inference_mode():
                points = torch.from_numpy(sample.points[None]).to(device)
                valid = torch.from_numpy(sample.valid[None]).to(device)
                bev = argoverse_points_to_bev_nchw(points, valid)
                crop = crop_raster(bev)
            dets, _boxes_bev, real, mask = detect_bev(model, crop.permute(0, 2, 3, 1), K=50,
                                                      peak_thresh=args.peak_thresh)
            n_det = int(mask.sum())
            gt_uv = project_ground_truth(sample)
            bev_u8 = bev[0].permute(1, 2, 0).cpu().numpy().astype(np.uint8)
            write_png_rgb(os.path.join(args.output_dir, f"{sample.timestamp}_bev.png"), bev_u8[:, :, ::-1])
            print(f"frame {sample.timestamp}: {n_det} detections, {int(sample.n_labels)} GT boxes")
            if results is not None:
                results.append({"timestamp": sample.timestamp, "detections": dets[0].cpu().numpy(),
                                "boxes_real": real[0].cpu().numpy(), "mask": mask[0].cpu().numpy(),
                                "gt_corners_uv": gt_uv})
        except Exception:
            # one bad frame must not end the run (argo_sfa_test.py:219-383)
            failed += 1
            print(f"frame {idx} failed:")
            traceback.print_exc()
    return failed


if __name__ == "__main__":
    raise SystemExit(1 if main() else 0)
