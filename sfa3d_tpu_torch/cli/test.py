"""Inference + visualization runner of the port, the counterpart of
`sfa3d_tpu/cli/test.py`:

    python -m sfa3d_tpu_torch.cli test --dataset_dir DIR [--pretrained_path CKPT.pth] [flags]

For each frame of the test split: the LiDAR detector (`pipeline.detect_frames`:
one `bev_raster_reduce` launch, the KFPN, the decode), then on the host the
rotated boxes drawn on the BEV image (turned 180 degrees), the 3D boxes
projected and drawn on the camera frame, and the two stacked into one
composite `{id}.png` under `--output_dir`. `--save_test_output` also writes
`visualizations/{id}_raw_bev.png` and the raw and sigmoid centre heatmap of
each class through the JET colour map (`{id}_{raw,sigmoid}_heatmap_cls{c}.png`),
from the same forward. Images are drawn BGR as the JAX runner draws them
and written as PNG (the JAX runner writes JPEG; the port has no JPEG
encoder yet). `--output_format video` and `--enable_kfpn_viz` need the AVI
writer and the KFPN feature dumps, which the port does not have yet, and
`--show` a display and cv2: each exits with a message. It runs on cuda
(raising without a GPU) unless `--platform cpu` is given. `main` returns
one record per frame: sample_id, n_dets, the host times (ms) of the
detection (results on the host), the drawing and the PNG writes, and the
frame's boxes_bev, boxes_real, mask and calib.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="sfa3d_tpu_torch testing (the test runner)")
    p.add_argument("--saved_fn", type=str, default="fpn_resnet_18", metavar="FN")
    p.add_argument("--arch", type=str, default="fpn_resnet_18", metavar="ARCH")
    p.add_argument("--pretrained_path", type=str, default=None, metavar="PATH")
    p.add_argument("--use_ema", action="store_true",
                   help="load the EMA weights of an --ema_decay run")
    p.add_argument("--dataset_dir", type=str, default="./dataset/kitti")
    p.add_argument("--K", type=int, default=50)
    p.add_argument("--peak_thresh", type=float, default=0.2)
    p.add_argument("--save_test_output", action="store_true")
    p.add_argument("--output_format", type=str, default="image", choices=["image", "video"])
    p.add_argument("--output_dir", type=str, default="./results")
    p.add_argument("--output-width", dest="output_width", type=int, default=608)
    p.add_argument("--num_samples", type=int, default=None)
    p.add_argument("--enable_kfpn_viz", action="store_true")
    p.add_argument("--show", action="store_true")
    p.add_argument("--platform", type=str, default=None, choices=["cpu", "cuda"],
                   help="'cpu' runs on the CPU; the default is cuda")
    return p.parse_args(argv)


def refuse_unported(args) -> None:
    """Exit with a message for the options the port cannot serve yet."""
    if args.output_format == "video":
        raise SystemExit("--output_format video needs an AVI (MJPEG) writer, which the port does "
                         "not have yet; drop it to write one PNG per frame")
    if args.enable_kfpn_viz:
        raise SystemExit("--enable_kfpn_viz needs the KFPN feature dumps (viz/kfpn_viz.py), which "
                         "the port does not have yet")
    if args.show:
        raise SystemExit("--show needs a display and cv2's windows; the port writes files only "
                         "(drop --show)")


def read_frame_bgr(img_path: str, shape=(375, 1242)) -> np.ndarray:
    """The camera frame as a BGR uint8 image (black when the file is absent)."""
    from sfa3d_tpu_torch.data.png import read_png_rgb

    if not os.path.isfile(img_path):
        return np.zeros(shape + (3,), np.uint8)
    return np.ascontiguousarray(read_png_rgb(img_path)[:, :, ::-1])


def frame_calibration(img_path: str):
    from sfa3d_tpu_torch.geometry.calibration import KittiCalibration

    calib_path = img_path.replace(".png", ".txt").replace("image_2", "calib")
    return KittiCalibration(calib_path if os.path.isfile(calib_path) else None)


def write_bgr(path: str, image_bgr: np.ndarray) -> None:
    """Write a BGR image as PNG with the pixels a cv2.imwrite would store."""
    from sfa3d_tpu_torch.data.png import write_png_rgb

    write_png_rgb(path, np.ascontiguousarray(image_bgr[:, :, ::-1]))


def main(argv=None):
    from sfa3d_tpu_torch.cli.eval import load_model
    from sfa3d_tpu_torch.config import kitti as cnf
    from sfa3d_tpu_torch.data.kitti import KittiDataset
    from sfa3d_tpu_torch.device import resolve_device
    from sfa3d_tpu_torch.geometry.transforms import lidar_to_camera_box
    from sfa3d_tpu_torch.models import clamped_sigmoid
    from sfa3d_tpu_torch.pipeline import detect_frames
    from sfa3d_tpu_torch.viz import raster
    from sfa3d_tpu_torch.viz.draw import (
        bev_map_to_image,
        draw_predictions_bev,
        merge_rgb_to_bev,
        show_rgb_image_with_boxes,
    )

    args = parse_args(argv)
    refuse_unported(args)
    device = resolve_device("cpu" if args.platform == "cpu" else None)
    model = load_model(args.arch, args.pretrained_path, args.use_ema, device)
    dataset = KittiDataset(args.dataset_dir, mode="test", num_samples=args.num_samples)
    os.makedirs(args.output_dir, exist_ok=True)

    records = []
    for idx in range(len(dataset)):
        sample = dataset[idx]
        t0 = time.perf_counter()
        out = detect_frames(
            model, sample.points[None], sample.valid[None], K=args.K, peak_thresh=args.peak_thresh,
            return_heads=bool(args.save_test_output), device=device,
        )
        # the fetch waits for the device; this is the whole-frame latency
        boxes_bev = out["boxes_bev"][0].cpu().numpy()
        boxes_real = out["boxes_real"][0].cpu().numpy()
        mask = out["mask"][0].cpu().numpy()
        bev = out["bev"][0].cpu().numpy()
        t1 = time.perf_counter()
        dt = t1 - t0
        print(f"frame {sample.sample_id}: {mask.sum()} dets, "
              f"{dt * 1000:.1f} ms ({1.0 / max(dt, 1e-9):.1f} FPS)")

        bev_img = bev_map_to_image(bev)
        bev_img = raster.resize(bev_img, (cnf.BEV_WIDTH, cnf.BEV_HEIGHT))
        draw_predictions_bev(bev_img, boxes_bev, mask)
        bev_img = raster.rotate_180(bev_img)

        img_bgr = read_frame_bgr(sample.img_path)
        calib = frame_calibration(sample.img_path)
        if mask.any():
            cam = np.asarray(lidar_to_camera_box(boxes_real[mask][:, 1:8], calib.V2C, calib.R0, calib.P2))
            cam_labels = np.concatenate([boxes_real[mask][:, :1], cam], axis=1)
            img_bgr = show_rgb_image_with_boxes(img_bgr, cam_labels, calib)
        out_img = merge_rgb_to_bev(img_bgr, bev_img, output_width=args.output_width)

        images = {}
        if args.save_test_output:
            # the raw BEV, then the raw and sigmoid centre heatmap of each
            # class, from the same forward as the detections
            viz_dir = os.path.join(args.output_dir, "visualizations")
            os.makedirs(viz_dir, exist_ok=True)
            images[os.path.join(viz_dir, f"{sample.sample_id:06d}_raw_bev.png")] = raster.resize(
                bev_map_to_image(bev), (cnf.BEV_WIDTH, cnf.BEV_HEIGHT))
            heads = out["heads"]
            hm_raw = heads["hm_cen"].float()[0].cpu().numpy()  # (H, W, C)
            hm_sig = clamped_sigmoid(heads["hm_cen"])[0].cpu().numpy()
            for cls_id in range(hm_raw.shape[-1]):
                for tag, hm in (("raw", hm_raw), ("sigmoid", hm_sig)):
                    heat = (np.clip(hm[..., cls_id], 0, 1) * 255).astype(np.uint8)
                    name = f"{sample.sample_id:06d}_{tag}_heatmap_cls{cls_id}.png"
                    images[os.path.join(viz_dir, name)] = raster.apply_colormap_jet(heat)
        images[os.path.join(args.output_dir, f"{sample.sample_id:06d}.png")] = out_img
        t2 = time.perf_counter()
        for path, image in images.items():
            write_bgr(path, image)
        t3 = time.perf_counter()
        records.append({"sample_id": sample.sample_id, "n_dets": int(mask.sum()),
                        "detect_ms": dt * 1000, "draw_ms": (t2 - t1) * 1000,
                        "write_ms": (t3 - t2) * 1000, "boxes_bev": boxes_bev, "boxes_real": boxes_real,
                        "mask": mask, "calib": calib})
    return records


if __name__ == "__main__":
    main()
