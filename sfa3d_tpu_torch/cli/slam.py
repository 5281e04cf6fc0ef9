"""Dynamic-calibration fusion runner of the port, the counterpart of
`sfa3d_tpu/cli/slam.py`:

    python -m sfa3d_tpu_torch.cli slam --dataset_dir DIR [--calib_method METHOD]
        [--use_pnp] [--mode nms|weighted|bayesian] [--pretrained_path CKPT.pth]
        [--yolo_weights yolov8n.pt] [--platform cpu] [flags]

The `fuse` runner's path under a calibration that changes per frame: for
each test-split frame, `slam/calib_sources.py::get_calibration_from_slam`
gives P2, R0 and V2C (`--calib_method`; `--use_pnp` recovers the simulated
visual-SLAM pose with RANSAC PnP on the device), injected into
`KittiCalibration(None)`. YOLOv8 runs on the camera frame (one
`hard_nms_keep` launch) and SFA3D on the scan (`pipeline.detect_frames`:
one `bev_raster_reduce` launch), then `fusion/pipeline.py::fuse_frame`
(`greedy_match` in weighted and bayesian, `hard_nms_keep` after fusion).
The fused boxes are drawn coloured by source under a `calib: METHOD`
header and written as `{id}_slam.jpg` (`data/jpeg.py`, cv2.imwrite's
bytes). It runs on cuda (raising without a GPU) unless `--platform cpu`
is given. `main` returns one record per frame: sample_id, the fused
count and boxes, the calibration matrices, and the host times (ms) of the
detection, the calibration, the fusion, the drawing and the JPEG write.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from sfa3d_tpu_torch.slam.calib_sources import SLAM_METHODS

SOURCE_COLORS = ((0, 255, 255), (255, 0, 0), (0, 255, 0))  # yolo / sfa / fused


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="sfa3d_tpu_torch dynamic-calibration fusion")
    p.add_argument("--arch", type=str, default="fpn_resnet_18")
    p.add_argument("--pretrained_path", type=str, default=None)
    p.add_argument("--use_ema", action="store_true",
                   help="load the EMA weights of an --ema_decay run")
    p.add_argument("--yolo_weights", type=str, default=None,
                   help="ultralytics yolov8 .pt to import (random weights if absent)")
    p.add_argument("--imgsz", type=int, default=640,
                   help="YOLOv8 letterbox size (stride-32 multiple)")
    p.add_argument("--dataset_dir", type=str, default="./dataset/kitti")
    p.add_argument("--calib_method", type=str, default="KITTI_DATASET_CALIB",
                   choices=list(SLAM_METHODS))
    p.add_argument("--use_pnp", action="store_true",
                   help="recover the simulated visual-SLAM pose with RANSAC PnP")
    p.add_argument("--mode", type=str, default="bayesian",
                   choices=["nms", "weighted", "bayesian"])
    p.add_argument("--confidence_threshold", type=float, default=0.25)
    p.add_argument("--fusion_iou_threshold", type=float, default=0.7)
    p.add_argument("--peak_thresh", type=float, default=0.2)
    p.add_argument("--num_samples", type=int, default=None)
    p.add_argument("--output_dir", type=str, default="./results/slam_fusion")
    p.add_argument("--platform", type=str, default=None, choices=["cpu", "cuda"],
                   help="'cpu' runs on the CPU; the default is cuda")
    return p.parse_args(argv)


def main(argv=None):
    from sfa3d_tpu_torch.cli.eval import load_model
    from sfa3d_tpu_torch.cli.test import read_frame_bgr
    from sfa3d_tpu_torch.data.kitti import KittiDataset
    from sfa3d_tpu_torch.data.png import write_image_bgr
    from sfa3d_tpu_torch.device import resolve_device
    from sfa3d_tpu_torch.fusion import pipeline as fusion_pipeline
    from sfa3d_tpu_torch.geometry.calibration import KittiCalibration
    from sfa3d_tpu_torch.models.yolov8 import YOLOv8Detector
    from sfa3d_tpu_torch.pipeline import detect_frames
    from sfa3d_tpu_torch.slam.calib_sources import get_calibration_from_slam
    from sfa3d_tpu_torch.viz import raster

    args = parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)
    device = resolve_device("cpu" if args.platform == "cpu" else None)
    model = load_model(args.arch, args.pretrained_path, args.use_ema, device)
    if args.yolo_weights:
        yolo = YOLOv8Detector.from_weights(args.yolo_weights, imgsz=args.imgsz, device=device)
    else:
        yolo = YOLOv8Detector(imgsz=args.imgsz, device=device)

    dataset = KittiDataset(args.dataset_dir, mode="test", num_samples=args.num_samples)
    header = f"calib: {args.calib_method}{' +PnP' if args.use_pnp else ''}"
    records = []
    for idx in range(len(dataset)):
        sample = dataset[idx]
        t0 = time.perf_counter()
        img = read_frame_bgr(sample.img_path)
        out = detect_frames(model, sample.points[None], sample.valid[None], K=50,
                            peak_thresh=args.peak_thresh, device=device)
        boxes_real = out["boxes_real"][0].cpu().numpy()
        scores = out["detections"][0, :, 0].cpu().numpy()
        mask = out["mask"][0].cpu().numpy()
        yb, ys, yc = yolo(np.ascontiguousarray(img[:, :, ::-1]), conf=args.confidence_threshold)
        t_detect = time.perf_counter()

        # this frame's calibration, injected into a default one
        slam_calib = get_calibration_from_slam(
            sample.img_path,
            slam_method=args.calib_method,
            img_shape=img.shape,
            use_pnp=args.use_pnp,
            calib_file=sample.img_path.replace("image_2", "calib").replace(".png", ".txt"),
            device=device,
        )
        calib = KittiCalibration(None)
        calib.set_matrices(**slam_calib)
        t_calib = time.perf_counter()

        result = fusion_pipeline.fuse_frame(
            yb, ys, yc, boxes_real, scores, mask, calib, img.shape[:2],
            mode=args.mode,
            confidence_threshold=args.confidence_threshold,
            fusion_iou_threshold=args.fusion_iou_threshold,
            device=device,
        )
        t_fuse = time.perf_counter()
        for (x, y, w, h), src in zip(result["boxes"], result["source"]):
            raster.rectangle(img, (x, y), (x + w, y + h), SOURCE_COLORS[int(src)], 2)
        raster.put_text(img, header, (10, 25), raster.FONT_HERSHEY_SIMPLEX, 0.8, (255, 255, 255), 2)
        t_draw = time.perf_counter()
        write_image_bgr(os.path.join(args.output_dir, f"{sample.sample_id:06d}_slam.jpg"), img)
        t_write = time.perf_counter()
        print(f"frame {sample.sample_id}: {len(result['boxes'])} fused dets [{args.calib_method}]")
        records.append({"sample_id": sample.sample_id, "fused": len(result["boxes"]),
                        "boxes": np.asarray(result["boxes"]).reshape(-1, 4),
                        "calib": {k: np.asarray(v) for k, v in slam_calib.items()},
                        "detect_ms": (t_detect - t0) * 1000, "calib_ms": (t_calib - t_detect) * 1000,
                        "fuse_ms": (t_fuse - t_calib) * 1000, "draw_ms": (t_draw - t_fuse) * 1000,
                        "write_ms": (t_write - t_draw) * 1000})
    return records


if __name__ == "__main__":
    main()
