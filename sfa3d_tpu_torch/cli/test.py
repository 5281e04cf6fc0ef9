"""Inference + visualization runner of the port, the counterpart of
`sfa3d_tpu/cli/test.py`:

    python -m sfa3d_tpu_torch.cli test --dataset_dir DIR [--pretrained_path CKPT.pth] [flags]

For each frame of the test split: the LiDAR detector (`pipeline.detect_frames`:
one `bev_raster_reduce` launch, the KFPN, the decode), then on the host the
rotated boxes drawn on the BEV image (turned 180 degrees), the 3D boxes
projected and drawn on the camera frame, and the two stacked into one
composite, written as `{id}.jpg` under `--output_dir` or, with
`--output_format video`, as a frame of `{saved_fn}.avi` (MJPEG at 30 fps,
`data/avi.py`). `--save_test_output` also writes
`visualizations/{id}_raw_bev.jpg` and the raw and sigmoid centre heatmap of
each class through the JET colour map (`{id}_{raw,sigmoid}_heatmap_cls{c}.jpg`),
from the same forward. `--enable_kfpn_viz` runs `KFPN.forward_features` on
the frame's raster and writes the feature dumps of `viz/kfpn_viz.py` into
`kfpn_viz_{id}/`. Images are drawn BGR and JPEG-encoded as the JAX runner's
cv2.imwrite does (`data/jpeg.py`, byte for byte). `--show` needs a display
and cv2's windows: it exits with a message. It runs on cuda (raising
without a GPU) unless `--platform cpu` is given. `main` returns one record
per frame: sample_id, n_dets, the host times (ms) of the detection (results
on the host), the drawing and the writes (JPEG or video), and the frame's
boxes_bev, boxes_real, mask and calib.
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
    """Exit with a message for the option the port does not serve."""
    if args.show:
        raise SystemExit("--show needs a display and cv2's windows; the port writes files only "
                         "(drop --show)")


def read_frame_bgr(img_path: str, shape=(375, 1242)) -> np.ndarray:
    """The camera frame (PNG or JPEG) as a BGR uint8 image (black when the
    file is absent)."""
    from sfa3d_tpu_torch.data.png import read_image_bgr

    if not os.path.isfile(img_path):
        return np.zeros(shape + (3,), np.uint8)
    return read_image_bgr(img_path)


def frame_calibration(img_path: str):
    from sfa3d_tpu_torch.geometry.calibration import KittiCalibration

    calib_path = img_path.replace(".png", ".txt").replace("image_2", "calib")
    return KittiCalibration(calib_path if os.path.isfile(calib_path) else None)


def main(argv=None):
    from sfa3d_tpu_torch.cli.eval import load_model
    from sfa3d_tpu_torch.data.avi import AviMjpegWriter
    from sfa3d_tpu_torch.data.kitti import KittiDataset
    from sfa3d_tpu_torch.data.png import write_image_bgr
    from sfa3d_tpu_torch.device import resolve_device
    from sfa3d_tpu_torch.geometry.transforms import lidar_to_camera_box
    from sfa3d_tpu_torch.models import clamped_sigmoid
    from sfa3d_tpu_torch.pipeline import detect_frames
    from sfa3d_tpu_torch.viz import raster
    from sfa3d_tpu_torch.viz.draw import bev_panel_image, draw_bev_panel, merge_rgb_to_bev, show_rgb_image_with_boxes

    args = parse_args(argv)
    refuse_unported(args)
    device = resolve_device("cpu" if args.platform == "cpu" else None)
    model = load_model(args.arch, args.pretrained_path, args.use_ema, device)
    dataset = KittiDataset(args.dataset_dir, mode="test", num_samples=args.num_samples)
    os.makedirs(args.output_dir, exist_ok=True)

    records = []
    video_writer = None
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

        bev_img = draw_bev_panel(bev, boxes_bev, mask)

        img_bgr = read_frame_bgr(sample.img_path)
        calib = frame_calibration(sample.img_path)
        if mask.any():
            cam = np.asarray(lidar_to_camera_box(boxes_real[mask][:, 1:8], calib.V2C, calib.R0, calib.P2))
            cam_labels = np.concatenate([boxes_real[mask][:, :1], cam], axis=1)
            img_bgr = show_rgb_image_with_boxes(img_bgr, cam_labels, calib)
        out_img = merge_rgb_to_bev(img_bgr, bev_img, output_width=args.output_width)

        images = {}
        if args.enable_kfpn_viz:
            from sfa3d_tpu_torch.viz.kfpn_viz import save_all

            with torch.inference_mode():
                _, viz = model.forward_features(out["bev"].permute(0, 3, 1, 2))
            save_all(viz, os.path.join(args.output_dir, f"kfpn_viz_{sample.sample_id:06d}"))
        if args.save_test_output:
            # the raw BEV, then the raw and sigmoid centre heatmap of each
            # class, from the same forward as the detections
            viz_dir = os.path.join(args.output_dir, "visualizations")
            os.makedirs(viz_dir, exist_ok=True)
            images[os.path.join(viz_dir, f"{sample.sample_id:06d}_raw_bev.jpg")] = bev_panel_image(bev)
            heads = out["heads"]
            hm_raw = heads["hm_cen"].float()[0].cpu().numpy()  # (H, W, C)
            hm_sig = clamped_sigmoid(heads["hm_cen"])[0].cpu().numpy()
            for cls_id in range(hm_raw.shape[-1]):
                for tag, hm in (("raw", hm_raw), ("sigmoid", hm_sig)):
                    heat = (np.clip(hm[..., cls_id], 0, 1) * 255).astype(np.uint8)
                    name = f"{sample.sample_id:06d}_{tag}_heatmap_cls{cls_id}.jpg"
                    images[os.path.join(viz_dir, name)] = raster.apply_colormap_jet(heat)
        if args.output_format == "image":
            images[os.path.join(args.output_dir, f"{sample.sample_id:06d}.jpg")] = out_img
        t2 = time.perf_counter()
        for path, image in images.items():
            write_image_bgr(path, image)
        if args.output_format == "video":
            if video_writer is None:
                video_writer = AviMjpegWriter(os.path.join(args.output_dir, f"{args.saved_fn}.avi"), 30,
                                              (out_img.shape[1], out_img.shape[0]))
            video_writer.write(out_img)
        t3 = time.perf_counter()
        records.append({"sample_id": sample.sample_id, "n_dets": int(mask.sum()),
                        "detect_ms": dt * 1000, "draw_ms": (t2 - t1) * 1000,
                        "write_ms": (t3 - t2) * 1000, "boxes_bev": boxes_bev, "boxes_real": boxes_real,
                        "mask": mask, "calib": calib, "composite": out_img})
    if video_writer is not None:
        video_writer.release()
    return records


if __name__ == "__main__":
    main()
