"""3D multi-object tracking demo of the port over a KITTI raw drive, the
counterpart of `sfa3d_tpu/cli/track.py`:

    python -m sfa3d_tpu_torch.cli track --drive_dir DRIVE [--pretrained_path CKPT.pth] [--max_age 3] [--min_hits 2]

Per scan: the front BEV raster (one `bev_raster_reduce` launch), the
detector (`pipeline.detect_bev`), then the fixed-slot Kalman tracker
(`tracking.tracker_step`, whose association is one `track_associate`
launch) fed the metric boxes. The confirmed tracks (with `--show_coasting`
every live one) are drawn on the BEV image: the rotated box, a `#id` label
(`(id)` while unconfirmed) and the velocity as an arrow five frames long;
the panel goes under the camera frame into `track_{saved_fn}.avi` (MJPEG
at 30 fps, `data/avi.py`). It prints one line a frame and, at the end, the
number of distinct confirmed ids. It runs on cuda (raising without a GPU)
unless `--platform cpu` is given. `main` returns one record per frame: the
tracker's outputs (numpy), the composite, and the host times (ms) of the
detection, the tracker step, the drawing, the JPEG encode and the AVI
write.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="sfa3d_tpu_torch 3D MOT demo")
    p.add_argument("--saved_fn", type=str, default="fpn_resnet_18")
    p.add_argument("--arch", type=str, default="fpn_resnet_18")
    p.add_argument("--pretrained_path", type=str, default=None)
    p.add_argument("--use_ema", action="store_true",
                   help="load the EMA weights of an --ema_decay run")
    p.add_argument("--drive_dir", type=str, required=True,
                   help="KITTI raw drive folder (image_02/ + velodyne_points/)")
    p.add_argument("--K", type=int, default=50)
    p.add_argument("--peak_thresh", type=float, default=0.2)
    p.add_argument("--max_tracks", type=int, default=64)
    p.add_argument("--iou_min", type=float, default=0.01)
    p.add_argument("--max_age", type=int, default=3)
    p.add_argument("--min_hits", type=int, default=2)
    p.add_argument("--show_coasting", action="store_true",
                   help="also draw unconfirmed/coasting tracks (id in brackets)")
    p.add_argument("--output_dir", type=str, default="./results")
    p.add_argument("--output-width", dest="output_width", type=int, default=608)
    p.add_argument("--platform", type=str, default=None, choices=["cpu", "cuda"],
                   help="'cpu' runs on the CPU; the default is cuda")
    return p.parse_args(argv)


def metric_to_bev_px(box):
    """[cls, x, y, z, h, w, l, yaw] metric velodyne row -> BEV pixels
    (x_px, y_px, w_px, l_px, yaw_px), the inverse of
    ops/decode.py::detections_to_real."""
    from sfa3d_tpu_torch.config import kitti as cnf

    _, x, y, _z, _h, w, l, yaw = box
    x_px = (y - cnf.boundary["minY"]) / cnf.bound_size_y * cnf.BEV_WIDTH
    y_px = (x - cnf.boundary["minX"]) / cnf.bound_size_x * cnf.BEV_HEIGHT
    w_px = w / cnf.bound_size_y * cnf.BEV_WIDTH
    l_px = l / cnf.bound_size_x * cnf.BEV_HEIGHT
    return x_px, y_px, w_px, l_px, -yaw


def draw_tracks_bev(img, out, show_coasting: bool = False):
    """Draw the confirmed (or every live) track: its rotated box, its id
    and its velocity (metres a frame, drawn five frames long)."""
    from sfa3d_tpu_torch.config import kitti as cnf
    from sfa3d_tpu_torch.viz import raster
    from sfa3d_tpu_torch.viz.draw import draw_rotated_box

    which = out["alive"] if show_coasting else out["confirmed"]
    for t in np.nonzero(np.asarray(which))[0]:
        box = np.asarray(out["boxes"][t])
        tid = int(out["ids"][t])
        confirmed = bool(out["confirmed"][t])
        x_px, y_px, w_px, l_px, yaw_px = metric_to_bev_px(box)
        color = cnf.colors[int(box[0]) % len(cnf.colors)]
        draw_rotated_box(img, x_px, y_px, w_px, l_px, yaw_px, color)
        vx, vy = np.asarray(out["velocities"][t][:2])
        # metric x runs down the rows, metric y along the columns
        tip = (int(x_px + vy / cnf.bound_size_y * cnf.BEV_WIDTH * 5),
               int(y_px + vx / cnf.bound_size_x * cnf.BEV_HEIGHT * 5))
        raster.arrowed_line(img, (int(x_px), int(y_px)), tip, color, 1, tipLength=0.3)
        label = f"#{tid}" if confirmed else f"({tid})"
        raster.put_text(img, label, (int(x_px) + 3, int(y_px) - 3), raster.FONT_HERSHEY_SIMPLEX, 0.4, color, 1,
                        raster.LINE_AA)
    return img


def main(argv=None):
    from sfa3d_tpu_torch.cli.demo import scan_to_device
    from sfa3d_tpu_torch.cli.eval import load_model
    from sfa3d_tpu_torch.cli.test import read_frame_bgr
    from sfa3d_tpu_torch.data.avi import AviMjpegWriter
    from sfa3d_tpu_torch.data.jpeg import encode_jpeg
    from sfa3d_tpu_torch.data.kitti import DemoKittiDataset
    from sfa3d_tpu_torch.device import resolve_device
    from sfa3d_tpu_torch.ops.bev import points_to_bev
    from sfa3d_tpu_torch.pipeline import detect_bev
    from sfa3d_tpu_torch.tracking import init_tracks, tracker_step
    from sfa3d_tpu_torch.viz import raster
    from sfa3d_tpu_torch.viz.draw import bev_panel_image, merge_rgb_to_bev

    args = parse_args(argv)
    device = resolve_device("cpu" if args.platform == "cpu" else None)
    model = load_model(args.arch, args.pretrained_path, args.use_ema, device)
    dataset = DemoKittiDataset(args.drive_dir)
    os.makedirs(args.output_dir, exist_ok=True)

    state = init_tracks(args.max_tracks, device=device)
    video_writer = None
    seen_ids = set()
    records = []
    for idx in range(len(dataset)):
        points, valid, img_path = dataset[idx]
        t0 = time.perf_counter()
        pts, val = scan_to_device(points, valid, device)
        with torch.inference_mode():
            bev = points_to_bev(pts, val)
        dets, _, boxes_real, mask = detect_bev(model, bev[None], K=args.K, peak_thresh=args.peak_thresh)
        bev_np = bev.cpu().numpy()
        t1 = time.perf_counter()
        state, out = tracker_step(state, boxes_real[0], dets[0, :, 0], mask[0], iou_min=args.iou_min,
                                  max_age=args.max_age, min_hits=args.min_hits)
        out = {k: v.cpu().numpy() for k, v in out.items()}
        t2 = time.perf_counter()
        seen_ids.update(out["ids"][out["confirmed"]].tolist())

        img = bev_panel_image(bev_np)
        draw_tracks_bev(img, out, show_coasting=args.show_coasting)
        out_img = merge_rgb_to_bev(read_frame_bgr(img_path), raster.rotate_180(img), output_width=args.output_width)
        t3 = time.perf_counter()
        jpeg = encode_jpeg(out_img)
        t4 = time.perf_counter()
        if video_writer is None:
            video_writer = AviMjpegWriter(os.path.join(args.output_dir, f"track_{args.saved_fn}.avi"), 30,
                                          (out_img.shape[1], out_img.shape[0]))
        video_writer.write_encoded(jpeg)
        t5 = time.perf_counter()
        n_conf = int(out["confirmed"].sum())
        print(f"frame {idx}: {n_conf} confirmed track(s), {int(out['alive'].sum())} alive")
        records.append({"index": idx, "outputs": out, "composite": out_img, "n_dets": int(mask.sum()),
                        "detect_ms": (t1 - t0) * 1000, "track_ms": (t2 - t1) * 1000, "draw_ms": (t3 - t2) * 1000,
                        "encode_ms": (t4 - t3) * 1000, "write_ms": (t5 - t4) * 1000})
    if video_writer is not None:
        video_writer.release()
    print(f"done: {len(seen_ids)} distinct confirmed track id(s) over {len(dataset)} frames")
    return records


if __name__ == "__main__":
    main()
