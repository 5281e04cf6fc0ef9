"""Fusion check of the port: the held-out 3D AP of the LiDAR detector alone
against camera-confirmed rescoring. The port of `scripts/fusion_check.py`.

Rows, as in the JAX artefact: lidar_only; the reference's max(conf_3d,
conf_2d) rule; its error-free-camera control (separates the camera model's
noise from properties of the rule); the monotone demote rule
(`rescore_3d_from_camera(mode="demote")`: confirmed detections keep their
score, unconfirmed in-frustum ones are scaled by --demote, out-of-frustum
ones pass through). The gate is the demote rule's mean delta_mAP > 0.

Camera detections come from a calibrated oracle built from the ground
truth (`build_camera_oracle`: each box's occlusion-aware image projection,
jittered, confidences around --oracle_conf, misses, false positives), drawn
with numpy's default_rng exactly as the JAX script draws them, averaged over
--oracle_seeds draws. `--yolo_weights best.pt` adds trained_camera_* rows
from the port's own YOLOv8 (`YOLOv8Detector.from_weights`: one
`hard_nms_keep` launch a frame) on the split's image_2 frames.

Pass 1 runs `detect_frames` once a frame (one `bev_raster_reduce` launch),
then `project_boxes_to_image`; pass 2 rescores every rule with
`rescore_3d_from_camera` (one `greedy_match` launch a call) and scores with
`evaluate_kitti_ap` / `evaluate_kitti_ap_by_difficulty`.

    python3 scripts/torch_fusion_check.py --dataset_dir RUN/kitti \\
        --pretrained_path RUN/checkpoints/gen/Model_gen_epoch_N.pth --use_ema
    CPU smoke: add --platform cpu --num_samples 4 --smoke

It runs on cuda unless `--platform cpu` is given (raising without a GPU),
in strict float32, and writes TORCH_FUSION_CHECK.json (--out), or a block
of an existing report (--merge_into, --block_name).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
sys.path.insert(0, os.path.join(_ROOT, "scripts"))


def build_camera_oracle(labels, P2, rng, conf=0.85, conf_sigma=0.05,
                        miss_prob=0.1, n_fp=2, jitter=0.05,
                        hw=(375, 1242), k_slots=16):
    """GT velodyne label rows -> a noisy fixed-K image-plane detection set
    (boxes (k_slots, 4) xywh float32, scores, int32 classes, bool valid).

    The fixture's occlusion-aware projective annotation
    (`data.synthetic.annotate_labels_camera`) gives the true boxes; then
    the error model: per-box centre / size jitter ~ N(0, jitter * size),
    confidence ~ N(conf, conf_sigma) clipped to [0.05, 0.999], the box
    dropped (a camera miss) with miss_prob, plus n_fp uniform false
    positives at confidence ~ U(0.2, 0.5). The draws are the JAX script's,
    call for call."""
    import numpy as np

    from sfa3d_tpu_torch.data.synthetic import annotate_labels_camera

    h_img, w_img = hw
    boxes, scores, classes = [], [], []
    anns = annotate_labels_camera(labels, P2, hw=hw)
    for row, ann in zip(labels, anns):
        if ann["truncation"] >= 0.9:
            continue  # effectively invisible to the camera
        if rng.uniform() < miss_prob:
            continue
        x1, y1, x2, y2 = ann["bbox"]
        w, h = x2 - x1, y2 - y1
        if w <= 2 or h <= 2:
            continue
        cx = (x1 + x2) / 2 + rng.normal(0, jitter * w)
        cy = (y1 + y2) / 2 + rng.normal(0, jitter * h)
        w = w * (1 + rng.normal(0, jitter))
        h = h * (1 + rng.normal(0, jitter))
        boxes.append([cx - w / 2, cy - h / 2, w, h])
        scores.append(float(np.clip(rng.normal(conf, conf_sigma), 0.05, 0.999)))
        classes.append(int(row[0]))
    for _ in range(n_fp):
        w = rng.uniform(20, 120)
        h = rng.uniform(20, 80)
        boxes.append([rng.uniform(0, w_img - w), rng.uniform(0, h_img - h), w, h])
        scores.append(float(rng.uniform(0.2, 0.5)))
        classes.append(int(rng.integers(0, 3)))

    out_boxes = np.zeros((k_slots, 4), np.float32)
    out_scores = np.zeros((k_slots,), np.float32)
    out_classes = np.zeros((k_slots,), np.int32)
    out_valid = np.zeros((k_slots,), bool)
    n = min(len(boxes), k_slots)
    if n:
        out_boxes[:n] = np.asarray(boxes, np.float32)[:n]
        out_scores[:n] = np.asarray(scores, np.float32)[:n]
        out_classes[:n] = np.asarray(classes, np.int32)[:n]
        out_valid[:n] = True
    return out_boxes, out_scores, out_classes, out_valid


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset_dir", required=True)
    ap.add_argument("--pretrained_path", required=True)
    ap.add_argument("--arch", default="fpn_resnet_18")
    ap.add_argument("--split", default="val")
    ap.add_argument("--num_samples", type=int, default=None)
    ap.add_argument("--K", type=int, default=50)
    ap.add_argument("--peak_thresh", type=float, default=0.2)
    ap.add_argument("--fusion_iou", type=float, default=0.5,
                    help="2D IoU for camera <-> projected-3D matching (projection AABBs are looser "
                         "than box-to-box IoU, so this sits below the box-fusion 0.7)")
    ap.add_argument("--use_ema", action="store_true")
    ap.add_argument("--oracle_conf", type=float, default=0.85)
    ap.add_argument("--oracle_miss", type=float, default=0.1)
    ap.add_argument("--oracle_fp", type=int, default=2)
    ap.add_argument("--oracle_jitter", type=float, default=0.05)
    ap.add_argument("--oracle_seed", type=int, default=0)
    ap.add_argument("--demote", type=float, default=0.9,
                    help="score scale for unconfirmed in-frustum detections under the monotone "
                         "demote rule (gentle by design: every camera MISS demotes a true positive)")
    ap.add_argument("--oracle_seeds", type=int, default=4,
                    help="independent camera draws the rule deltas are averaged over")
    ap.add_argument("--platform", default=None, choices=["cpu", "cuda"],
                    help="'cpu' runs on the CPU; the default is cuda")
    ap.add_argument("--smoke", action="store_true", help="plumbing-only: report but do not enforce the gate")
    ap.add_argument("--yolo_weights", type=str, default=None,
                    help="a trained YOLOv8 .pt (the yolo_train CLI's best.pt): adds trained_camera_* "
                         "rows whose camera detections come from the port's own 2D detector on image_2")
    ap.add_argument("--yolo_imgsz", type=str, default="192x640",
                    help="'HxW' letterbox of the trained detector (its training canvas)")
    ap.add_argument("--yolo_conf", type=float, default=0.25)
    ap.add_argument("--merge_into", type=str, default=None,
                    help="insert this run's rows as a named block into an existing report instead of "
                         "overwriting it (e.g. --merge_into TORCH_FUSION_CHECK.json --block_name "
                         "held_out_confirmation)")
    ap.add_argument("--block_name", type=str, default="held_out_confirmation")
    ap.add_argument("--out", default=os.path.join(_ROOT, "TORCH_FUSION_CHECK.json"))
    return ap.parse_args(argv)


def detection_pass(model, dataset, args, device):
    """Pass 1: one detection + projection a frame. Returns the frames
    (mask, boxes_real, scores as numpy; the projected set on the device;
    labels, P2, image path) and the ground truths."""
    import numpy as np

    from sfa3d_tpu_torch.fusion.boxes2d import project_boxes_to_image
    from sfa3d_tpu_torch.fusion.fuse import DetectionSet
    from sfa3d_tpu_torch.pipeline import detect_frames

    frames, gts = [], []
    for idx in range(len(dataset)):
        sample = dataset[idx]
        out = detect_frames(model, sample.points[None], sample.valid[None], K=args.K,
                            peak_thresh=args.peak_thresh, device=device)
        real_t, scores_t, mask_t = out["boxes_real"][0], out["detections"][0, :, 0], out["mask"][0]
        calib = sample.calib
        sfa2d_boxes, sfa2d_valid = project_boxes_to_image(
            real_t, scores_t, mask_t, np.asarray(calib.V2C, np.float32), np.asarray(calib.R0, np.float32),
            np.asarray(calib.P2, np.float32), conf_gate=0.0)
        sfa2d = DetectionSet(sfa2d_boxes, scores_t, real_t[:, 0].int(), sfa2d_valid)
        mask, real, scores = mask_t.cpu().numpy(), real_t.cpu().numpy(), scores_t.cpu().numpy()
        lab = sample.labels[: int(sample.n_labels)]
        frames.append((mask, real, scores, sfa2d, lab, calib.P2, sample.img_path))
        gt = {"boxes": lab[:, 1:8], "classes": lab[:, 0].astype(int)}
        if sample.levels is not None:
            gt["difficulty"] = sample.levels[: int(sample.n_labels)]
        gts.append(gt)
        if (idx + 1) % 16 == 0:
            print(f"{idx + 1}/{len(dataset)} frames")
    return frames, gts


def _camera(boxes, scores, classes, valid, device):
    import torch

    from sfa3d_tpu_torch.fusion.fuse import DetectionSet

    return DetectionSet(*(torch.as_tensor(a).to(device) for a in (boxes, scores, classes, valid)))


def _rescored(camera, sfa2d, mask, real, args, **mode):
    """The frame's masked detections with `rescore_3d_from_camera`'s scores
    (sfa2d.scores are the 3D detections' own)."""
    from sfa3d_tpu_torch.fusion.fuse import rescore_3d_from_camera

    new = rescore_3d_from_camera(camera, sfa2d, sfa2d.scores, args.fusion_iou, **mode).cpu().numpy()
    return {"boxes": real[mask][:, 1:8], "classes": real[mask][:, 0].astype(int), "scores": new[mask]}


def rescore_pass(frames, args, device):
    """Pass 2: the rules under args.oracle_seeds camera draws and the
    error-free control draw. Returns (per-seed detections of each rule,
    the control's detections, camera-confirmed count of the first draw)."""
    import numpy as np

    per_seed = {"reference_max_rule": [], "monotone_demote_rule": []}
    n_confirmed = 0
    for seed in range(args.oracle_seed, args.oracle_seed + args.oracle_seeds):
        rng = np.random.default_rng(seed)
        dets_fused, dets_demote = [], []
        for mask, real, scores, sfa2d, lab, P2, _ in frames:
            cam = _camera(*build_camera_oracle(lab, P2, rng, conf=args.oracle_conf, miss_prob=args.oracle_miss,
                                               n_fp=args.oracle_fp, jitter=args.oracle_jitter), device)
            fused = _rescored(cam, sfa2d, mask, real, args)
            demoted = _rescored(cam, sfa2d, mask, real, args, mode="demote", demote=args.demote)
            if seed == args.oracle_seed:
                n_confirmed += int((fused["scores"] > scores[mask] + 1e-9).sum())
            dets_fused.append(fused)
            dets_demote.append(demoted)
        per_seed["reference_max_rule"].append(dets_fused)
        per_seed["monotone_demote_rule"].append(dets_demote)
        print(f"oracle seed {seed} scored")

    rng = np.random.default_rng(args.oracle_seed)
    dets_perfect = []
    for mask, real, scores, sfa2d, lab, P2, _ in frames:
        cam = _camera(*build_camera_oracle(lab, P2, rng, conf=args.oracle_conf, miss_prob=0.0, n_fp=0,
                                           jitter=0.0), device)
        dets_perfect.append(_rescored(cam, sfa2d, mask, real, args))
    return per_seed, dets_perfect, n_confirmed


def trained_camera_pass(frames, args, device):
    """The trained-camera rows' detections: the port's YOLOv8 on each
    frame's image_2 (deterministic: one row per rule)."""
    import numpy as np

    from sfa3d_tpu_torch.cli.yolo_train import parse_imgsz
    from sfa3d_tpu_torch.data.png import read_image_bgr
    from sfa3d_tpu_torch.models.yolov8 import YOLOv8Detector

    det2d = YOLOv8Detector.from_weights(args.yolo_weights, imgsz=parse_imgsz(args.yolo_imgsz), device=device)
    dets_trained = {"max": [], "demote": []}
    n_cam_dets = 0
    for mask, real, scores, sfa2d, lab, P2, img_path in frames:
        if not os.path.isfile(img_path):
            raise FileNotFoundError(f"{img_path}: trained-camera rows need rendered image_2 frames "
                                    "(write_mini_kitti cameras=True)")
        yb, ys, yc = det2d(np.ascontiguousarray(read_image_bgr(img_path)[:, :, ::-1]), conf=args.yolo_conf)
        k_slots = 32
        cb = np.zeros((k_slots, 4), np.float32)
        cs = np.zeros((k_slots,), np.float32)
        cc = np.zeros((k_slots,), np.int32)
        cv_ = np.zeros((k_slots,), bool)
        n = min(len(yb), k_slots)
        if n:
            cb[:n] = np.asarray(yb, np.float32)[:n]
            cs[:n] = np.asarray(ys, np.float32)[:n]
            cc[:n] = np.asarray(yc, np.int32)[:n]
            cv_[:n] = True
        n_cam_dets += n
        cam = _camera(cb, cs, cc, cv_, device)
        dets_trained["max"].append(_rescored(cam, sfa2d, mask, real, args))
        dets_trained["demote"].append(_rescored(cam, sfa2d, mask, real, args, mode="demote", demote=args.demote))
    print(f"trained camera: {n_cam_dets} detections over {len(frames)} frames")
    return dets_trained


def main(argv=None) -> int:
    args = parse_args(argv)
    import numpy as np
    import torch_check_common as common

    from sfa3d_tpu_torch.cli.eval import load_model
    from sfa3d_tpu_torch.data.kitti import KittiDataset
    from sfa3d_tpu_torch.eval import evaluate_kitti_ap, evaluate_kitti_ap_by_difficulty

    device = common.resolve(args.platform)
    model = load_model(args.arch, args.pretrained_path, args.use_ema, device)
    dataset = KittiDataset(args.dataset_dir, mode=args.split, hflip_prob=0.0, num_samples=args.num_samples)
    launches0 = common.launches()
    frames, gts = detection_pass(model, dataset, args, device)
    per_seed, dets_perfect, n_confirmed = rescore_pass(frames, args, device)
    dets_lidar = [{"boxes": real[mask][:, 1:8], "classes": real[mask][:, 0].astype(int), "scores": scores[mask]}
                  for mask, real, scores, _, _, _, _ in frames]
    dets_trained = trained_camera_pass(frames, args, device) if args.yolo_weights else None

    report = {
        "cmd": " ".join(["python", "scripts/torch_fusion_check.py"] + (sys.argv[1:] if argv is None else argv)),
        "frames": len(dataset),
        "camera_oracle": {
            "conf": args.oracle_conf, "miss_prob": args.oracle_miss,
            "false_positives_per_frame": args.oracle_fp,
            "bbox_jitter": args.oracle_jitter, "seed": args.oracle_seed,
            "independent_draws_averaged": args.oracle_seeds,
            "demote": args.demote,
            "why_oracle": "the oracle is the CONTROLLED camera-information source with a known error "
                          "model (misses, jitter, false positives), kept as the controlled comparison "
                          "next to the trained_camera_* rows, which use the port's own YOLOv8 detector "
                          "(the yolo_train CLI)",
        },
        "fusion_iou": args.fusion_iou,
        "camera_confirmed_detections": n_confirmed,
    }

    def score(dets):
        res = evaluate_kitti_ap(dets, gts, metric="3d", with_aos=True, device=device)
        table = evaluate_kitti_ap_by_difficulty(dets, gts, metric="3d", device=device)
        return {
            "mAP": round(res["mAP"], 4),
            "per_class": {k: round(v, 4) for k, v in res.items() if k.startswith("AP_")},
            "by_difficulty": {k: round(v["mAP"], 4) for k, v in table.items()},
        }

    report["lidar_only"] = score(dets_lidar)
    report["reference_max_rule_errorfree_control"] = score(dets_perfect)
    print("lidar_only", json.dumps(report["lidar_only"]))

    # class ids per config/kitti.py: 0=Pedestrian, 1=Car, 2=Cyclist
    lidar = report["lidar_only"]
    for name, seed_runs in per_seed.items():
        rows = [score(dets) for dets in seed_runs]
        row = dict(rows[0])  # the first draw's full table, for inspection
        row["per_seed_delta_mAP"] = [round(r["mAP"] - lidar["mAP"], 4) for r in rows]
        row["per_seed_delta_AP_car"] = [round(r["per_class"]["AP_1"] - lidar["per_class"]["AP_1"], 4)
                                        for r in rows]
        row["delta_mAP"] = round(float(np.mean(row["per_seed_delta_mAP"])), 4)
        row["delta_AP_car"] = round(float(np.mean(row["per_seed_delta_AP_car"])), 4)
        row["delta_per_class"] = {
            k: round(float(np.mean([r["per_class"][k] - lidar["per_class"][k] for r in rows])), 4)
            for k in lidar["per_class"]}
        row["delta_by_difficulty"] = {
            k: round(float(np.mean([r["by_difficulty"][k] - lidar["by_difficulty"][k] for r in rows])), 4)
            for k in lidar["by_difficulty"]}
        report[name] = row
        print(name, json.dumps(row))
    if dets_trained is not None:
        for key, name in (("max", "trained_camera_max_rule"), ("demote", "trained_camera_demote_rule")):
            row = score(dets_trained[key])
            row["delta_mAP"] = round(row["mAP"] - lidar["mAP"], 4)
            row["delta_AP_car"] = round(row["per_class"]["AP_1"] - lidar["per_class"]["AP_1"], 4)
            row["delta_per_class"] = {k: round(row["per_class"][k] - lidar["per_class"][k], 4)
                                      for k in lidar["per_class"]}
            report[name] = row
            print(name, json.dumps(row))
        report["trained_camera"] = {
            "yolo_weights": os.path.abspath(args.yolo_weights),
            "yolo_imgsz": args.yolo_imgsz, "yolo_conf": args.yolo_conf,
            "note": "camera detections from the port's own trained YOLOv8 (the yolo_train CLI), no "
                    "oracle involved; deterministic, so single rows instead of seed averages",
        }

    ref_car = report["reference_max_rule"]["delta_AP_car"]
    dem_map = report["monotone_demote_rule"]["delta_mAP"]
    report["reference_claim"] = (
        "README.md:223-226: Bayesian fusion raises KITTI Car 3D AP (88.61 -> 92.15 Easy; SFA3D's "
        "published table is Car AP). Measured on the reference's max-confidence rule: delta_AP_car "
        f"{ref_car:+.4f}. The gate is the monotone demote rule: delta_mAP > 0."
    )
    report["device"] = common.device_record(device)
    after = common.launches()
    report["launches"] = {k: after[k] - launches0[k] for k in after}
    if args.merge_into:
        with open(args.merge_into) as f:
            parent = json.load(f)
        parent[args.block_name] = report
        with open(args.merge_into, "w") as f:
            json.dump(parent, f, indent=2)
        print(f"merged into {args.merge_into} as '{args.block_name}'")
    else:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
        print(f"wrote {args.out}", end=": ")
    print(f"reference max-rule delta_AP_car {ref_car:+.4f} | monotone demote delta_mAP {dem_map:+.4f}")
    if dets_trained is not None:
        t_dem = report["trained_camera_demote_rule"]["delta_mAP"]
        print(f"trained-camera demote delta_mAP {t_dem:+.4f}")
        if t_dem <= 0 and not args.smoke:
            print("FAIL: trained-camera monotone fusion did not improve mAP")
            return 1
    if dem_map <= 0 and not args.smoke:
        print("FAIL: monotone fusion did not improve mAP")
        return 1
    print("FUSION CHECK OK" if dem_map > 0 else "FUSION SMOKE OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
