"""Targetless stereo self-calibration runner of the port, the counterpart of
`sfa3d_tpu/cli/stereo_calib.py`:

    python -m sfa3d_tpu_torch.cli stereo-calib --dataset_dir DIR [--num_samples N]
        [--run_yolo [--yolo_weights yolov8n.pt] [--imgsz 640]] [--platform cpu] [flags]

For each KITTI stereo pair (training/image_2 and image_3, read grey as
cv2.imread(IMREAD_GRAYSCALE) reads them), `slam/stereo.py` runs the port's
ORB, the Hamming matcher, F-RANSAC, E and pose recovery with the cheirality
gate, and writes `{id}_estimated_calib.txt`: the frame's calibration with
the estimated R_stereo / t_stereo appended as comments on success. With
`--run_yolo`, YOLOv8 (one `hard_nms_keep` launch per pair) runs on each
calibrated left image and the boxes are drawn into `{id}_yolo.jpg`. The run
ends with `calibrated n/m pairs successfully`. It runs on cuda (raising
without a GPU) unless `--platform cpu` is given. `main` returns one
record per pair: the id, the `StereoCalibResult` and the host times (ms)
of its stages (`timings` of `perform_targetless_stereo_calibration`).
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="sfa3d_tpu_torch targetless stereo calibration")
    p.add_argument("--dataset_dir", type=str, default="./dataset/kitti")
    p.add_argument("--num_samples", type=int, default=None)
    p.add_argument("--min_matches", type=int, default=50)
    p.add_argument("--min_cheirality", type=float, default=0.7)
    p.add_argument("--output_dir", type=str, default="./results/stereo_calib")
    p.add_argument("--run_yolo", action="store_true",
                   help="also run YOLOv8 on the left images with the estimated calib")
    p.add_argument("--yolo_weights", type=str, default=None,
                   help="ultralytics yolov8 .pt to import (random weights if absent)")
    p.add_argument("--imgsz", type=int, default=640,
                   help="YOLOv8 letterbox size (stride-32 multiple)")
    p.add_argument("--platform", type=str, default=None, choices=["cpu", "cuda"],
                   help="'cpu' runs on the CPU; the default is cuda")
    return p.parse_args(argv)


def main(argv=None):
    from sfa3d_tpu_torch.data.png import read_image_bgr, read_png_grey, write_image_bgr
    from sfa3d_tpu_torch.device import resolve_device
    from sfa3d_tpu_torch.geometry.calibration import read_calib_file
    from sfa3d_tpu_torch.slam.stereo import (
        perform_targetless_stereo_calibration,
        save_estimated_calibration,
    )
    from sfa3d_tpu_torch.viz import raster

    args = parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)
    device = resolve_device("cpu" if args.platform == "cpu" else None)

    left_dir = os.path.join(args.dataset_dir, "training", "image_2")
    right_dir = os.path.join(args.dataset_dir, "training", "image_3")
    calib_dir = os.path.join(args.dataset_dir, "training", "calib")
    ids = sorted(
        os.path.splitext(f)[0] for f in os.listdir(left_dir) if f.endswith(".png")
    )[: args.num_samples]

    yolo = None
    if args.run_yolo:
        from sfa3d_tpu_torch.models.yolov8 import YOLOv8Detector

        if args.yolo_weights:
            yolo = YOLOv8Detector.from_weights(args.yolo_weights, imgsz=args.imgsz, device=device)
        else:
            yolo = YOLOv8Detector(imgsz=args.imgsz, device=device)

    n_ok, records = 0, []
    for sid in ids:
        left_path, right_path = os.path.join(left_dir, f"{sid}.png"), os.path.join(right_dir, f"{sid}.png")
        if not (os.path.isfile(left_path) and os.path.isfile(right_path)):
            continue
        left, right = read_png_grey(left_path), read_png_grey(right_path)
        calib = read_calib_file(os.path.join(calib_dir, f"{sid}.txt"))
        K = calib["P2"].reshape(3, 4)[:, :3]

        timings = {}
        result = perform_targetless_stereo_calibration(
            left, right, K,
            min_matches=args.min_matches, min_cheirality=args.min_cheirality,
            device=device, timings=timings,
        )
        status = "OK" if result.success else f"FAIL ({result.reason})"
        print(f"{sid}: {result.n_matches} matches, {result.n_inliers} inliers, "
              f"cheirality {result.cheirality_fraction:.2f} -> {status}")
        if result.success:
            n_ok += 1
        save_estimated_calibration(
            os.path.join(args.output_dir, f"{sid}_estimated_calib.txt"), calib, result
        )

        if yolo is not None and result.success:
            img = read_image_bgr(left_path)
            boxes, confs, classes = yolo(img[:, :, ::-1].copy())
            for (x, y, w, h), c in zip(boxes, confs):
                raster.rectangle(img, (x, y), (x + w, y + h), (0, 255, 0), 2)
            write_image_bgr(os.path.join(args.output_dir, f"{sid}_yolo.jpg"), img)
        records.append({"id": sid, "result": result, "timings": timings})

    print(f"calibrated {n_ok}/{len(ids)} pairs successfully")
    return records


if __name__ == "__main__":
    main()
