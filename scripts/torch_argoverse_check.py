"""Argoverse training check of the port: the `--dataset argoverse` recipe
must learn on held-out Argoverse-layout scenes. The port of
`scripts/argoverse_check.py`.

Trains fpn_resnet_18 through the port's Argoverse path (sweeps ->
`argoverse_points_to_bev` 1000 x 1000 raster -> centre 608 x 608 crop ->
targets in the crop's frame, `data/argoverse.py`) on a synthetic
mini-Argoverse population (`write_mini_argoverse`) with the port's
training CLI, then evaluates every kept checkpoint on a disjoint held-out
root (`eval_ckpt`: `ArgoverseDataset`, one `argoverse_raster_reduce` launch
a sweep, the crop, `detect_bev`): detections decoded in the crop's frame,
scored with rotated-BEV AP (`evaluate_kitti_ap`) against the ground truth
mapped through the same mirror (x' = 30.4 - x, yaw' = pi - yaw; BEV IoU is
invariant under it).

    python3 scripts/torch_argoverse_check.py --epochs 80
    CPU smoke: python3 scripts/torch_argoverse_check.py --platform cpu --smoke \\
        --frames_train 8 --frames_val 2 --epochs 1 --checkpoint_freq 1 --batch_size 4

Training runs in the trainer's default dtype, as the JAX script's does;
evaluation in strict float32. It runs on cuda unless `--platform cpu` is
given (raising without a GPU) and writes TORCH_ARGOVERSE_CHECK.json (--out).
`--overfit` evaluates on the training frames (the geometry pin). Exit code 1
when the best held-out BEV mAP is under --min_final_map or the curve did not
climb (not with --smoke).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
sys.path.insert(0, os.path.join(_ROOT, "scripts"))

HALF = 30.4  # crop half-extent, metres (608 px * 0.1 m/px / 2)


def eval_ckpt(ckpt, val_root, n_val, peak_thresh, use_ema, device=None):
    """Rotated-BEV AP of a checkpoint on an Argoverse root, in the crop's
    frame (Argoverse class ids 0 vehicle, 1 pedestrian, 2 bicycle, at IoU
    0.7 / 0.5 / 0.5). Runs on `device` (default cuda)."""
    import numpy as np
    import torch

    from sfa3d_tpu_torch.cli.eval import load_model
    from sfa3d_tpu_torch.config import kitti as cnf
    from sfa3d_tpu_torch.data.argoverse import ArgoverseDataset, crop_raster
    from sfa3d_tpu_torch.device import resolve_device
    from sfa3d_tpu_torch.eval import evaluate_kitti_ap
    from sfa3d_tpu_torch.ops.bev import argoverse_points_to_bev_nchw
    from sfa3d_tpu_torch.pipeline import detect_bev

    device = resolve_device(device)
    model = load_model("fpn_resnet_18", ckpt, use_ema, device)
    ds = ArgoverseDataset(val_root, mode="test", num_samples=n_val)
    dets, gts = [], []
    for idx in range(len(ds)):
        s = ds[idx]
        with torch.inference_mode():
            bev = argoverse_points_to_bev_nchw(torch.from_numpy(s.points)[None].to(device),
                                               torch.from_numpy(s.valid)[None].to(device))
            crop = crop_raster(bev).permute(0, 2, 3, 1)
        _, bev_boxes, _, mask = detect_bev(model, crop, K=50, peak_thresh=peak_thresh)
        bb = bev_boxes[0].cpu().numpy()
        m = mask[0].cpu().numpy()
        # crop-frame metric boxes [x', y', z, h, w, l, yaw]: the axes the
        # targets were built in. Positions are crop-raster pixels (0.1 m / px);
        # post_processing converted the metric dims with the KITTI factor
        # (ops/decode.py), so they are converted back with that factor
        scale = 2 * HALF / 608.0
        dim_w = cnf.bound_size_y / cnf.BEV_WIDTH
        dim_l = cnf.bound_size_x / cnf.BEV_HEIGHT
        det_rows = np.stack([
            bb[:, 3] * scale,            # x' (row axis, 0..60.8)
            bb[:, 2] * scale - HALF,     # y'
            bb[:, 4],                    # z - minZ (unused by the BEV metric)
            bb[:, 5],                    # h
            bb[:, 6] * dim_w,            # w (back to metres)
            bb[:, 7] * dim_l,            # l (back to metres)
            -bb[:, 8],                   # yaw (the decode negates it, as for KITTI)
        ], axis=-1)
        dets.append({"boxes": det_rows[m], "scores": bb[m, 1], "classes": bb[m, 0].astype(int)})
        lab = s.labels[: int(s.n_labels)]
        gt_rows = np.stack([
            HALF - lab[:, 1],            # x' = 30.4 - x
            lab[:, 2],                   # y' = y
            lab[:, 3],
            lab[:, 4], lab[:, 5], lab[:, 6],
            np.pi - lab[:, 7],           # heading reflected by the x mirror
        ], axis=-1)
        keep = (np.abs(gt_rows[:, 0] - HALF) < HALF) & (np.abs(gt_rows[:, 1]) < HALF)
        gts.append({"boxes": gt_rows[keep], "classes": lab[keep, 0].astype(int)})
    # the evaluator's default gates are KITTI-indexed; map them to the
    # Argoverse ids (config/argoverse.py)
    return evaluate_kitti_ap(dets, gts, metric="bev", iou_thresholds={0: 0.7, 1: 0.5, 2: 0.5}, device=device)


def train_cmd(args, train_root, tmp):
    """The port's training CLI over the mini-Argoverse root, the JAX
    script's flags less XLA's cache, in the trainer's default dtype."""
    cmd = [
        sys.executable, "-m", "sfa3d_tpu_torch.cli", "train",
        "--dataset", "argoverse",
        "--dataset_dir", train_root,
        "--batch_size", str(args.batch_size),
        "--effective_batch", str(args.batch_size),
        "--mesh_shape", "1",
        "--num_epochs", str(args.epochs),
        "--checkpoint_freq", str(args.checkpoint_freq),
        "--keep_checkpoints", "0",
        "--print_freq", "8",
        "--num_workers", "2",
        "--lr", str(args.lr), "--lr_type", "cosin",
        "--root-dir", tmp, "--saved_fn", "argo",
        "--auto_resume",  # a relaunch over --resume_tmp goes on from its newest checkpoint
    ]
    if args.ema_decay:
        cmd += ["--ema_decay", str(args.ema_decay), "--ema_tau", str(args.ema_tau)]
    if args.train_seed is not None:
        cmd += ["--seed", str(args.train_seed)]
    if args.pretrained_path:
        cmd += ["--pretrained_path", args.pretrained_path]
    if args.platform == "cpu":
        cmd += ["--platform", "cpu"]
    return cmd


def _epoch(path: str) -> int:
    return int(os.path.splitext(path)[0].rsplit("_", 1)[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames_train", type=int, default=96)
    ap.add_argument("--frames_val", type=int, default=24)
    ap.add_argument("--epochs", type=int, default=120)
    ap.add_argument("--checkpoint_freq", type=int, default=20)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--lr", type=float, default=2.5e-4)
    ap.add_argument("--ema_decay", type=float, default=0.998)
    ap.add_argument("--ema_tau", type=float, default=200.0)
    ap.add_argument("--peak_thresh", type=float, default=0.2)
    ap.add_argument("--min_final_map", type=float, default=0.2,
                    help="gate on the best held-out BEV mAP (lower than the KITTI gate: 96 scenes; "
                         "the claim is that it learns, at small scale)")
    ap.add_argument("--platform", default=None, choices=["cpu", "cuda"],
                    help="'cpu' runs on the CPU; the default is cuda")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--keep_tmp", action="store_true")
    ap.add_argument("--data_seed", type=int, default=0,
                    help="population seed; the held-out root draws from data_seed + 700000")
    ap.add_argument("--train_seed", type=int, default=None, help="forwarded to the CLI's --seed when set")
    ap.add_argument("--pretrained_path", default=None,
                    help="start training from these weights (a .pth) instead of the seed's init")
    ap.add_argument("--overfit", action="store_true",
                    help="geometry pin: evaluate on the TRAINING frames (val_root = train_root); use with "
                         "a small --frames_train and a high --min_final_map (e.g. 8 frames, gate 0.9)")
    ap.add_argument("--resume_tmp", type=str, default=None,
                    help="a previous run's directory: reuse its data roots and resume training from its "
                         "newest checkpoint (same flags required)")
    ap.add_argument("--out", default=os.path.join(_ROOT, "TORCH_ARGOVERSE_CHECK.json"))
    args = ap.parse_args(argv)

    import tempfile

    import torch_check_common as common

    from sfa3d_tpu_torch.data.argoverse import write_mini_argoverse

    device = common.resolve(args.platform)
    tmp = args.resume_tmp or tempfile.mkdtemp(prefix="torch_argocheck_")
    train_root = write_mini_argoverse(os.path.join(tmp, "train"), n_frames=args.frames_train,
                                      seed=args.data_seed)
    if args.overfit:
        val_root = train_root
        args.frames_val = args.frames_train
    else:
        val_root = write_mini_argoverse(os.path.join(tmp, "val"), n_frames=args.frames_val,
                                        seed=args.data_seed + 700000)

    cmd = train_cmd(args, train_root, tmp)
    env = dict(os.environ)
    env["PYTHONPATH"] = _ROOT + os.pathsep + env.get("PYTHONPATH", "")
    print("train:", " ".join(cmd), flush=True)
    rc = subprocess.run(cmd, cwd=_ROOT, env=env).returncode
    if rc != 0:
        raise RuntimeError(f"training failed rc={rc}")

    ckpts = sorted(glob.glob(os.path.join(tmp, "checkpoints", "argo", "Model_argo_epoch_*.pth")), key=_epoch)
    if not ckpts:
        raise RuntimeError("no checkpoints")
    launches0 = common.launches()
    curve = []
    for ckpt in ckpts:
        res = eval_ckpt(ckpt, val_root, args.frames_val, args.peak_thresh, use_ema=bool(args.ema_decay),
                        device=device)
        row = {"epoch": _epoch(ckpt), "val_bev_mAP": round(res["mAP"], 4),
               "per_class": {k: round(v, 4) for k, v in res.items() if k.startswith("AP_")}}
        curve.append(row)
        print(json.dumps(row), flush=True)
    after = common.launches()

    best = max(curve, key=lambda r: r["val_bev_mAP"])
    report = {
        "cmd": " ".join(["python", "scripts/torch_argoverse_check.py"] + (sys.argv[1:] if argv is None else argv)),
        "config": {k: getattr(args, k) for k in
                   ("frames_train", "frames_val", "epochs", "batch_size", "lr", "ema_decay", "ema_tau",
                    "data_seed", "train_seed", "overfit")},
        "metric": ("TRAIN-set rotated-BEV mAP (overfit geometry pin)" if args.overfit else
                   "held-out rotated-BEV mAP in the Argoverse crop frame"),
        "val_curve": curve,
        "best": best,
        "final": curve[-1],
        "climbed": best["val_bev_mAP"] > curve[0]["val_bev_mAP"],
        "device": common.device_record(device),
        "launches": {k: after[k] - launches0[k] for k in after},
    }
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    print(f"wrote {args.out}")

    if not args.keep_tmp:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)

    failures = []
    if best["val_bev_mAP"] < args.min_final_map:
        failures.append(f"best held-out BEV mAP {best['val_bev_mAP']} < {args.min_final_map}")
    if not report["climbed"]:
        failures.append("val mAP did not climb")
    if failures and args.smoke:
        for f_ in failures:
            print(f"smoke mode: gate not enforced: {f_}")
        print("ARGOVERSE SMOKE OK")
    elif failures:
        for f_ in failures:
            print(f"FAIL: {f_}")
        return 1
    else:
        print("ARGOVERSE CHECK OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
