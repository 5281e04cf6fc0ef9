"""Raw-drive video demo of the port, the counterpart of
`sfa3d_tpu/cli/demo.py` (front only, or front and back with `--two_sides`):

    python -m sfa3d_tpu_torch.cli demo --drive_dir DRIVE [--pretrained_path CKPT.pth] [--two_sides]

For each scan of a KITTI raw drive (`image_02/data` + `velodyne_points/data`,
`data/kitti.py::DemoKittiDataset`): the front BEV raster on the device (one
`bev_raster_reduce` launch) and the detector on it (`pipeline.detect_bev`);
with `--two_sides` also the rear window (`config/kitti.py::boundary_back`,
a second raster launch), its raster flipped on both axes before detection,
as the reference's demo does. Each window's detections are drawn on its
BEV image (turned 180 degrees; the rear panel turned back and stacked
under the front one), the panel merged under the camera frame
(`merge_rgb_to_bev`), the credit and the frame rate written on it, and the
composite appended to `demo_{saved_fn}.avi` (MJPEG at 30 fps through
`data/avi.py`, JPEG as cv2.imwrite encodes it). It runs on cuda (raising
without a GPU) unless `--platform cpu` is given. `main` returns one record
per frame: the composite, each window's detections, metric boxes and mask,
the frame rate written on it, and the host times (ms) of the detection
(results on the host), the drawing, the JPEG encode and the AVI write.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="sfa3d_tpu_torch demo (front or two-sided raw-drive video)")
    p.add_argument("--saved_fn", type=str, default="fpn_resnet_18")
    p.add_argument("--arch", type=str, default="fpn_resnet_18")
    p.add_argument("--pretrained_path", type=str, default=None)
    p.add_argument("--use_ema", action="store_true",
                   help="load the EMA weights of an --ema_decay run")
    p.add_argument("--drive_dir", type=str, required=True,
                   help="KITTI raw drive folder containing image_02/ and velodyne_points/")
    p.add_argument("--two_sides", action="store_true")
    p.add_argument("--K", type=int, default=50)
    p.add_argument("--peak_thresh", type=float, default=0.2)
    p.add_argument("--output_dir", type=str, default="./results")
    p.add_argument("--output-width", dest="output_width", type=int, default=608)
    p.add_argument("--platform", type=str, default=None, choices=["cpu", "cuda"],
                   help="'cpu' runs on the CPU; the default is cuda")
    return p.parse_args(argv)


def scan_to_device(points: np.ndarray, valid: np.ndarray, device: torch.device):
    return torch.from_numpy(points).to(device), torch.from_numpy(valid).to(device)


def detect_boxes(model, bev: torch.Tensor, args):
    """One detector pass on an (H, W, 3) raster: (detections (K, 10),
    boxes_bev (K, 9), boxes_real (K, 8), mask (K,)), numpy."""
    from sfa3d_tpu_torch.pipeline import detect_bev

    dets, boxes_bev, real, mask = detect_bev(model, bev[None], K=args.K, peak_thresh=args.peak_thresh)
    return tuple(t[0].cpu().numpy() for t in (dets, boxes_bev, real, mask))


def compose(img_bgr: np.ndarray, bev_panel: np.ndarray, output_width: int, fps=None) -> np.ndarray:
    """The camera frame over the BEV panel, with the credit and, when given,
    the frame rate (positions kept on the frame as the JAX demo keeps
    them)."""
    from sfa3d_tpu_torch.viz.draw import merge_rgb_to_bev, write_credit

    out_img = merge_rgb_to_bev(img_bgr, bev_panel, output_width=output_width)
    y = min(210, out_img.shape[0] - 20)
    write_credit(out_img, org_author=(10, y), text_author="Cre: github.com/maudzung",
                 org_fps=(10, min(y + 40, out_img.shape[0] - 5)), fps=fps)
    return out_img


def main(argv=None):
    from sfa3d_tpu_torch.cli.eval import load_model
    from sfa3d_tpu_torch.cli.test import read_frame_bgr
    from sfa3d_tpu_torch.config import kitti as cnf
    from sfa3d_tpu_torch.data.avi import AviMjpegWriter
    from sfa3d_tpu_torch.data.jpeg import encode_jpeg
    from sfa3d_tpu_torch.data.kitti import DemoKittiDataset
    from sfa3d_tpu_torch.device import resolve_device
    from sfa3d_tpu_torch.ops.bev import points_to_bev
    from sfa3d_tpu_torch.viz import raster
    from sfa3d_tpu_torch.viz.draw import draw_bev_panel

    args = parse_args(argv)
    device = resolve_device("cpu" if args.platform == "cpu" else None)
    model = load_model(args.arch, args.pretrained_path, args.use_ema, device)
    dataset = DemoKittiDataset(args.drive_dir)
    os.makedirs(args.output_dir, exist_ok=True)
    back_bound = tuple(cnf.boundary_back[k] for k in ("minX", "maxX", "minY", "maxY", "minZ", "maxZ"))

    video_writer = None
    records = []
    for idx in range(len(dataset)):
        points, valid, img_path = dataset[idx]
        t0 = time.perf_counter()
        pts, val = scan_to_device(points, valid, device)
        with torch.inference_mode():
            bevs = [points_to_bev(pts, val)]
            if args.two_sides:
                # the rear view is detected on the raster flipped on H and W
                # (the reference's do_detect flips both axes)
                bevs.append(points_to_bev(pts, val, bound=back_bound).flip(0, 1))
        windows = [detect_boxes(model, bev, args) for bev in bevs]
        bevs = [bev.cpu().numpy() for bev in bevs]
        t1 = time.perf_counter()
        panels = [draw_bev_panel(bev, w[1], w[3]) for bev, w in zip(bevs, windows)]
        if args.two_sides:
            panels[1] = raster.rotate_180(panels[1])
        fps = 1.0 / max(time.perf_counter() - t0, 1e-9)
        bev_panel = raster.vconcat(panels) if len(panels) > 1 else panels[0]
        out_img = compose(read_frame_bgr(img_path), bev_panel, args.output_width, fps)
        t2 = time.perf_counter()
        jpeg = encode_jpeg(out_img)
        t3 = time.perf_counter()
        if video_writer is None:
            video_writer = AviMjpegWriter(os.path.join(args.output_dir, f"demo_{args.saved_fn}.avi"), 30,
                                          (out_img.shape[1], out_img.shape[0]))
        video_writer.write_encoded(jpeg)
        t4 = time.perf_counter()
        print(f"frame {idx}: {fps:.1f} FPS")
        records.append({"index": idx, "composite": out_img, "fps": fps,
                        "detections": [w[0] for w in windows], "boxes_real": [w[2] for w in windows],
                        "mask": [w[3] for w in windows], "detect_ms": (t1 - t0) * 1000,
                        "draw_ms": (t2 - t1) * 1000, "encode_ms": (t3 - t2) * 1000,
                        "write_ms": (t4 - t3) * 1000})
    if video_writer is not None:
        video_writer.release()
    return records


if __name__ == "__main__":
    main()
