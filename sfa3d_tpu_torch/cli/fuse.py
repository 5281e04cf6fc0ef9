"""Camera-LiDAR fusion runner of the port, the counterpart of
`sfa3d_tpu/cli/fuse.py`:

    python -m sfa3d_tpu_torch.cli fuse --dataset_dir DIR [--pretrained_path CKPT.pth]
        [--yolo_weights yolov8n.pt] [--mode nms|weighted|bayesian] [--gaussian_nms] [flags]

Per test-split frame: YOLOv8 on the camera frame (`YOLOv8Detector`: one
`hard_nms_keep` launch) and SFA3D on the scan (`pipeline.detect_frames`:
one `bev_raster_reduce` launch), then `fusion/pipeline.py::fuse_frame` in
the chosen mode (`greedy_match` in weighted and bayesian; `hard_nms_keep`
after fusion, or `soft_nms_gaussian` with --gaussian_nms). The fused boxes
are drawn on the frame, coloured by source and labelled, under a header
with the mode and the frame rate, and written as `{id}_fused.jpg`;
`--side_by_side` also writes `{id}_yolov8.jpg` and `{id}_sfa3d.jpg`. The
run ends with `summary.txt`, the detection counts before and after fusion.
`--artifact` runs each frame through a fused export (`cli export --fused`,
`ArtifactFusedDetector`) instead, with the weights, the fusion settings and
the camera geometry baked in. Images are JPEG-encoded as the JAX runner's
cv2.imwrite does (`data/jpeg.py`, byte for byte). It runs on cuda (raising
without a GPU) unless `--platform cpu` is given. `main` returns one record
per frame: sample_id, the counts, and the host times (ms) of the detection,
the fusion, the drawing and the JPEG writes.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="sfa3d_tpu_torch camera-LiDAR fusion")
    p.add_argument("--arch", type=str, default="fpn_resnet_18")
    p.add_argument("--pretrained_path", type=str, default=None)
    p.add_argument("--use_ema", action="store_true",
                   help="load the EMA weights of an --ema_decay run")
    p.add_argument("--yolo_weights", type=str, default=None,
                   help="ultralytics yolov8 .pt to import (random weights if absent)")
    p.add_argument("--dataset_dir", type=str, default="./dataset/kitti")
    p.add_argument("--mode", type=str, default="bayesian",
                   choices=["nms", "weighted", "bayesian"])
    p.add_argument("--confidence_threshold", type=float, default=0.25)
    p.add_argument("--fusion_iou_threshold", type=float, default=0.7)
    p.add_argument("--nms_threshold", type=float, default=0.5)
    p.add_argument("--gaussian_nms", action="store_true")
    p.add_argument("--gaussian_sigma", type=float, default=0.5)
    p.add_argument("--peak_thresh", type=float, default=0.2)
    p.add_argument("--num_samples", type=int, default=None)
    p.add_argument("--output_dir", type=str, default="./results/fusion")
    p.add_argument("--side_by_side", action="store_true",
                   help="also save separate {id}_yolov8.jpg / {id}_sfa3d.jpg comparison images")
    p.add_argument("--imgsz", type=int, default=640,
                   help="YOLOv8 letterbox size (stride-32 multiple; ultralytics imgsz)")
    p.add_argument("--artifact", type=str, default=None, metavar="PATH.sfa3dt",
                   help="run frames through a FUSED export (cli export --fused) instead of "
                        "rebuilding the models: weights, fusion mode/thresholds, and camera "
                        "geometry come baked from the artifact manifest")
    p.add_argument("--platform", type=str, default=None, choices=["cpu", "cuda"],
                   help="'cpu' runs on the CPU; the default is cuda")
    return p.parse_args(argv)


SOURCE_COLORS = {0: (0, 255, 255), 1: (255, 0, 0), 2: (0, 255, 0)}  # yolo/sfa/fused
SOURCE_NAMES = {0: "YOLOv8", 1: "SFA3D", 2: "Fused"}


def _open_artifact(args):
    from sfa3d_tpu_torch.detector import ArtifactFusedDetector
    from sfa3d_tpu_torch.runtime.export import read_manifest

    if args.side_by_side:
        raise SystemExit(
            "--side_by_side needs the separate YOLO/SFA3D branches; a "
            "fused artifact runs them as one program (drop --artifact "
            "or --side_by_side)"
        )
    try:
        platforms = read_manifest(args.artifact).get("platforms")
        platform = args.platform or "cuda"
        if platforms != [platform]:
            raise ValueError(f"{args.artifact} was exported for {platforms}; it cannot run on "
                             f"{platform} (re-export with --platform {platform})")
        artifact = ArtifactFusedDetector(args.artifact)
    except ValueError as e:
        raise SystemExit(str(e)) from e
    print(
        "fusion config comes baked from the artifact manifest "
        f"({artifact.artifact.manifest.get('fused_kwargs')}); "
        "--mode/threshold flags are ignored"
    )
    return artifact


def _run_artifact_frame(artifact_detector, sample, img_bgr, calib):
    """One frame through the fused export; a geometry mismatch becomes a
    clean CLI error."""
    try:
        return artifact_detector.detect(
            sample.points[np.asarray(sample.valid)],
            np.ascontiguousarray(img_bgr[:, :, ::-1]),
            calib,
        )
    except ValueError as e:
        raise SystemExit(str(e)) from e


def main(argv=None):
    from sfa3d_tpu_torch.cli.eval import load_model
    from sfa3d_tpu_torch.cli.test import frame_calibration, read_frame_bgr
    from sfa3d_tpu_torch.data.png import write_image_bgr
    from sfa3d_tpu_torch.data.kitti import KittiDataset
    from sfa3d_tpu_torch.device import resolve_device
    from sfa3d_tpu_torch.fusion import pipeline as fusion_pipeline
    from sfa3d_tpu_torch.models.yolov8 import COCO_NAMES, YOLOv8Detector
    from sfa3d_tpu_torch.pipeline import detect_frames
    from sfa3d_tpu_torch.viz import raster

    args = parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)

    artifact = None
    if args.artifact:
        artifact = _open_artifact(args)
        device = artifact.device
    else:
        device = resolve_device("cpu" if args.platform == "cpu" else None)
        model = load_model(args.arch, args.pretrained_path, args.use_ema, device)
        if args.yolo_weights:
            yolo = YOLOv8Detector.from_weights(args.yolo_weights, imgsz=args.imgsz, device=device)
        else:
            yolo = YOLOv8Detector(imgsz=args.imgsz, device=device)

    dataset = KittiDataset(args.dataset_dir, mode="test", num_samples=args.num_samples)
    counts_before, counts_after, records = [], [], []
    for idx in range(len(dataset)):
        sample = dataset[idx]
        t0 = time.perf_counter()
        img = read_frame_bgr(sample.img_path)
        calib = frame_calibration(sample.img_path)

        if artifact is not None:
            result = _run_artifact_frame(artifact, sample, img, calib)
            t_detect = t_fuse = time.perf_counter()
            # pre-fusion branch counts are not observable from the single
            # fused program; the dashboard records output counts only
            counts_before.append(len(result["boxes"]))
            counts_after.append(len(result["boxes"]))
        else:
            out = detect_frames(model, sample.points[None], sample.valid[None], K=50,
                                peak_thresh=args.peak_thresh, device=device)
            boxes_real = out["boxes_real"][0].cpu().numpy()
            scores = out["detections"][0, :, 0].cpu().numpy()
            mask = out["mask"][0].cpu().numpy()
            yb, ys, yc = yolo(np.ascontiguousarray(img[:, :, ::-1]), conf=args.confidence_threshold)
            t_detect = time.perf_counter()
            result = fusion_pipeline.fuse_frame(
                yb, ys, yc, boxes_real, scores, mask, calib, img.shape[:2],
                mode=args.mode,
                confidence_threshold=args.confidence_threshold,
                fusion_iou_threshold=args.fusion_iou_threshold,
                nms_threshold=args.nms_threshold,
                use_gaussian_nms=args.gaussian_nms,
                gaussian_sigma=args.gaussian_sigma,
                device=device,
            )
            t_fuse = time.perf_counter()
            counts_before.append(len(yb) + int(mask.sum()))
            counts_after.append(len(result["boxes"]))
        dt = t_fuse - t0

        images = {}
        if args.side_by_side:
            from sfa3d_tpu_torch.fusion.boxes2d import project_boxes_to_image

            img_y = img.copy()
            for (x, y, w, h), score in zip(yb, ys):
                raster.rectangle(img_y, (x, y), (x + w, y + h), (0, 255, 255), 2)
                raster.put_text(img_y, f"{score:.2f}", (x, max(0, y - 4)),
                                raster.FONT_HERSHEY_SIMPLEX, 0.5, (0, 255, 255), 1)
            images[f"{sample.sample_id:06d}_yolov8.jpg"] = img_y

            img_s = img.copy()
            s2d, sval = project_boxes_to_image(
                out["boxes_real"][0], out["detections"][0, :, 0], out["mask"][0],
                calib.V2C, calib.R0, calib.P2, img_h=img.shape[0], img_w=img.shape[1],
                conf_gate=args.confidence_threshold,
            )
            for (x, y, w, h), ok in zip(s2d.cpu().numpy().astype(int), sval.cpu().numpy()):
                if ok:
                    raster.rectangle(img_s, (x, y), (x + w, y + h), (255, 0, 0), 2)
            images[f"{sample.sample_id:06d}_sfa3d.jpg"] = img_s

        for (x, y, w, h), score, cls, src in zip(
            result["boxes"], result["scores"], result["classes"], result["source"]
        ):
            color = SOURCE_COLORS[int(src)]
            raster.rectangle(img, (x, y), (x + w, y + h), color, 2)
            name = COCO_NAMES[cls] if int(src) != 1 and cls < len(COCO_NAMES) else f"cls{cls}"
            raster.put_text(img, f"{SOURCE_NAMES[int(src)]} {name} {score:.2f}",
                            (x, max(0, y - 5)), raster.FONT_HERSHEY_SIMPLEX, 0.5, color, 1)
        mode_label = "artifact" if artifact is not None else args.mode
        raster.put_text(img, f"{mode_label} fusion  {1.0 / max(dt, 1e-9):.1f} FPS",
                        (10, 25), raster.FONT_HERSHEY_SIMPLEX, 0.8, (255, 255, 255), 2)
        images[f"{sample.sample_id:06d}_fused.jpg"] = img
        t_draw = time.perf_counter()
        for name, image in images.items():
            write_image_bgr(os.path.join(args.output_dir, name), image)
        t_write = time.perf_counter()
        print(f"frame {sample.sample_id}: {counts_before[-1]} -> {counts_after[-1]} dets "
              f"({dt * 1000:.1f} ms)")
        records.append({"sample_id": sample.sample_id, "before": counts_before[-1],
                        "after": counts_after[-1], "detect_ms": (t_detect - t0) * 1000,
                        "fuse_ms": (t_fuse - t_detect) * 1000, "draw_ms": (t_draw - t_fuse) * 1000,
                        "write_ms": (t_write - t_draw) * 1000})

    # detection-count dashboard
    with open(os.path.join(args.output_dir, "summary.txt"), "w") as f:
        if artifact is not None:
            f.write(f"mode: artifact ({args.artifact})\n"
                    f"frames: {len(counts_before)}\n")
            f.write("pre-fusion branch counts are not observable from the "
                    "single fused program\n")
        else:
            f.write(f"mode: {args.mode}\nframes: {len(counts_before)}\n")
            f.write(f"mean detections before fusion/NMS: {np.mean(counts_before):.2f}\n")
        f.write(f"mean detections after fusion/NMS: {np.mean(counts_after):.2f}\n")
    return records


if __name__ == "__main__":
    main()
