"""Argoverse runner of the port, the counterpart of
`sfa3d_tpu/cli/argoverse_test.py`:

    python -m sfa3d_tpu_torch.cli.argoverse_test --dataset_dir DIR [flags]

For each paired sweep: the 1000 x 1000 Argoverse raster on the device (one
launch of the tile kernel's Argoverse mode), its centre 608 x 608 crop, the
KFPN detector and the decode to metric ego-frame boxes
(`pipeline.detect_bev`), the ground-truth 3D boxes projected into the
camera through the JSON SE3 calibration, one line per frame, and two
images under `--output_dir`, JPEG-encoded as the JAX runner's cv2.imwrite
does (`data/jpeg.py`): `{timestamp}_bev.jpg`, the raster as uint8 (its
channels [density, height, intensity] stored as B, G, R), and
`{timestamp}_rgb.jpg`, the camera frame (`read_image_bgr`; black 1200 x
1920 when it cannot be found) with the 12 edges of every ground-truth box
whose 8 corners all project drawn in green, 2 px. Weights come from a
`.pth` checkpoint (`--pretrained_path`, through `cli/eval.py::load_model`;
random weights with a warning without one). A frame that raises is
reported with its traceback and skipped, as in the JAX runner; `main`
returns the number of frames that failed. It runs on cuda (raising without
a GPU) unless `--platform cpu` is given.
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


# the 12 edges of a box's 8 corners (center_to_corner_box3d's order)
BOX_EDGES = ((0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7), (7, 4),
             (0, 4), (1, 5), (2, 6), (3, 7))


def draw_ground_truth(img: np.ndarray, gt_uv) -> np.ndarray:
    """The edges of each fully projected box (pixels truncated to int), in
    green at 2 px, on the BGR frame in place."""
    from sfa3d_tpu_torch.viz import raster

    for uv in gt_uv:
        if uv is None:
            continue
        pts = np.asarray(uv).astype(int)
        for a, b in BOX_EDGES:
            raster.line(img, tuple(pts[a]), tuple(pts[b]), (0, 255, 0), 2)
    return img


def main(argv=None, results=None) -> int:
    """Run over the dataset; returns the number of frames that failed. When
    `results` is a list, each answered frame's {"timestamp", "detections",
    "boxes_real", "mask", "gt_corners_uv", "bev_u8", "camera"} (numpy; the
    last two the arrays written as `_bev.jpg` and `_rgb.jpg`) is appended
    to it."""
    from sfa3d_tpu_torch.cli.eval import load_model
    from sfa3d_tpu_torch.data.argoverse import ArgoverseDataset, crop_raster
    from sfa3d_tpu_torch.data.png import read_image_bgr, write_image_bgr
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
            img = (read_image_bgr(sample.img_path) if os.path.isfile(sample.img_path)
                   else np.zeros((1200, 1920, 3), np.uint8))
            draw_ground_truth(img, gt_uv)
            bev_u8 = bev[0].permute(1, 2, 0).cpu().numpy().astype(np.uint8)
            write_image_bgr(os.path.join(args.output_dir, f"{sample.timestamp}_bev.jpg"), bev_u8)
            write_image_bgr(os.path.join(args.output_dir, f"{sample.timestamp}_rgb.jpg"), img)
            print(f"frame {sample.timestamp}: {n_det} detections, {int(sample.n_labels)} GT boxes")
            if results is not None:
                results.append({"timestamp": sample.timestamp, "detections": dets[0].cpu().numpy(),
                                "boxes_real": real[0].cpu().numpy(), "mask": mask[0].cpu().numpy(),
                                "gt_corners_uv": gt_uv, "bev_u8": bev_u8, "camera": img})
        except Exception:
            # one bad frame must not end the run (argo_sfa_test.py:219-383)
            failed += 1
            print(f"frame {idx} failed:")
            traceback.print_exc()
    return failed


if __name__ == "__main__":
    raise SystemExit(1 if main() else 0)
