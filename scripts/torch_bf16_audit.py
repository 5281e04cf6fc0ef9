"""bfloat16 end-to-end deviation audit of the port on trained weights, the
port of `scripts/bf16_audit.py`.

The same frames and the same checkpoint go through the float32 and the
bfloat16 `Detector` (`dtype="bfloat16"`: bfloat16 convolution weights,
float32 BatchNorm, the raster and the decode in float32). It reports:

- the detection match rate (greedy nearest BEV centre, same class, within
  1 m),
- per-field deviation percentiles (p50 / p95 / max) over the matched pairs
  (x, y, z, h, w, l in metres, yaw in radians, the confidence),
- the mAP of the split in both dtypes,
- the verdict: whether bfloat16 stays inside the 1e-3 detection tolerance
  (not expected: bfloat16 carries about 3 significant digits), else the
  envelope and the mAP change are the record.

    python3 scripts/torch_bf16_audit.py --dataset_dir <kitti> \\
        --pretrained_path <checkpoint.pth> [--use_ema] [--platform cpu] [--out report.json]

It runs on cuda unless --platform cpu is given, and writes the report to
--out (default build/torch_bf16_audit.json under the repo).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

FIELDS = ["x_m", "y_m", "z_m", "h_m", "w_m", "l_m", "yaw_rad", "conf"]


def match_and_diff(real_a, scores_a, mask_a, real_b, scores_b, mask_b, max_dist=1.0):
    """Greedy nearest-centre matching between two detection sets of one
    frame (same class required, within max_dist metres). Returns the rows
    of per-field |delta| of the matched pairs and the counts (n_a, n_b,
    n_matched)."""
    import numpy as np

    A, B = real_a[mask_a], real_b[mask_b]
    sa, sb = scores_a[mask_a], scores_b[mask_b]
    used = np.zeros(len(B), bool)
    rows = []
    for i in range(len(A)):
        if not len(B):
            break
        d = np.linalg.norm(B[:, 1:3] - A[i, 1:3], axis=1)
        d = np.where(used | (B[:, 0] != A[i, 0]), np.inf, d)
        j = int(np.argmin(d))
        if d[j] > max_dist:
            continue
        used[j] = True
        dyaw = np.abs(np.mod(A[i, 7] - B[j, 7] + np.pi, 2 * np.pi) - np.pi)
        rows.append(np.abs(np.concatenate([A[i, 1:7] - B[j, 1:7], [dyaw], [sa[i] - sb[j]]])))
    return rows, (len(A), len(B), len(rows))


def deviation_stats(rows):
    """Per-field p50 / p95 / max of match_and_diff rows ({} when none)."""
    import numpy as np

    if not rows:
        return {}
    D = np.asarray(rows)
    return {f: {"p50": float(np.percentile(D[:, i], 50)), "p95": float(np.percentile(D[:, i], 95)),
                "max": float(D[:, i].max())} for i, f in enumerate(FIELDS)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset_dir", required=True)
    ap.add_argument("--pretrained_path", required=True)
    ap.add_argument("--arch", default="fpn_resnet_18")
    ap.add_argument("--split", default="val")
    ap.add_argument("--num_samples", type=int, default=None)
    ap.add_argument("--K", type=int, default=50)
    ap.add_argument("--peak_thresh", type=float, default=0.2)
    ap.add_argument("--use_ema", action="store_true")
    ap.add_argument("--platform", default=None, choices=["cpu", "cuda"],
                    help="'cpu' runs on the CPU; the default is cuda")
    ap.add_argument("--out", default=os.path.join(_ROOT, "build", "torch_bf16_audit.json"))
    args = ap.parse_args(argv)

    import torch

    # float32 is strict float32, the port's parity mode: PyTorch's default
    # runs cuDNN's float32 convolutions in TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    import numpy as np

    from sfa3d_tpu_torch.data.kitti import KittiDataset
    from sfa3d_tpu_torch.detector import Detector
    from sfa3d_tpu_torch.eval import evaluate_kitti_ap

    device = "cpu" if args.platform == "cpu" else None
    detectors = {name: Detector(arch=args.arch, checkpoint=args.pretrained_path, K=args.K,
                                peak_thresh=args.peak_thresh, dtype=dtype, device=device, use_ema=args.use_ema)
                 for name, dtype in (("f32", "float32"), ("bf16", "bfloat16"))}
    dataset = KittiDataset(args.dataset_dir, mode=args.split, hflip_prob=0.0, num_samples=args.num_samples)

    diffs, gts = [], []
    dets = {"f32": [], "bf16": []}
    counts = np.zeros(3, np.int64)
    for idx in range(len(dataset)):
        sample = dataset[idx]
        per_mode = {}
        for name, det in detectors.items():
            out = det.detect_batch(sample.points[None], sample.valid[None])
            real, scores, mask = out["boxes_real"][0], out["detections"][0, :, 0], out["mask"][0]
            per_mode[name] = (real, scores, mask)
            dets[name].append({"boxes": real[mask][:, 1:8], "scores": scores[mask],
                               "classes": real[mask][:, 0].astype(int)})
        rows, c = match_and_diff(*per_mode["f32"], *per_mode["bf16"])
        diffs.extend(rows)
        counts += c
        lab = sample.labels[: int(sample.n_labels)]
        gt = {"boxes": lab[:, 1:8], "classes": lab[:, 0].astype(int)}
        if sample.levels is not None:
            gt["difficulty"] = sample.levels[: int(sample.n_labels)]
        gts.append(gt)
        if (idx + 1) % 16 == 0:
            print(f"{idx + 1}/{len(dataset)} frames")

    stats = deviation_stats(diffs)
    eval_device = detectors["f32"].device
    ap32 = evaluate_kitti_ap(dets["f32"], gts, metric="3d", device=eval_device)
    ap16 = evaluate_kitti_ap(dets["bf16"], gts, metric="3d", device=eval_device)
    worst = max((s["max"] for s in stats.values()), default=float("inf"))
    within = bool(diffs) and worst <= 1e-3 and counts[0] == counts[2] == counts[1]
    report = {
        "cmd": " ".join(["python3", os.path.relpath(os.path.abspath(sys.argv[0]), _ROOT)]
                        + (sys.argv[1:] if argv is None else list(argv))),
        "platform": args.platform or "cuda",
        "frames": len(dataset),
        "detections_f32": int(counts[0]),
        "detections_bf16": int(counts[1]),
        "matched_pairs": int(counts[2]),
        "match_rate": float(counts[2] / max(1, max(counts[0], counts[1]))),
        "per_field_abs_deviation": stats,
        "mAP_f32": ap32["mAP"],
        "mAP_bf16": ap16["mAP"],
        "delta_mAP": ap16["mAP"] - ap32["mAP"],
        "within_1e3_tolerance": within,
        "verdict": (
            "bf16 matches f32 within the 1e-3 detection tolerance" if within else
            "bf16 deviates beyond the 1e-3 detection tolerance (bf16 carries about 3 significant "
            "digits through the conv stack); float32 stays the parity mode, bf16 the fast mode with "
            "the deviation envelope and mAP change recorded here"
        ),
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps({k: report[k] for k in ("matched_pairs", "match_rate", "mAP_f32", "mAP_bf16",
                                             "within_1e3_tolerance")}))
    print(f"wrote {args.out}")
    return report


if __name__ == "__main__":
    main()
