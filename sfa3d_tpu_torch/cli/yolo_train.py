"""Train the port's YOLOv8 camera detector on KITTI-layout 2D boxes, the
counterpart of `sfa3d_tpu/cli/yolo_train.py`:

    python -m sfa3d_tpu_torch.cli.yolo_train --dataset_dir DIR \
        --epochs 200 --imgsz 192x640 --val_frac 0.2

The split loads once and goes to the device as uint8 (`data/yolo2d.py`);
an epoch is one `make_yolo_epoch_fn` call (`parallel/yolo_step.py`: AdamW
with a warmup and cosine decay, hflip, parameter EMA); every `--eval_every`
epochs the EMA weights (the live weights without EMA) run the eval pass
(decode + class-offset NMS on the device) and the val split is scored by 2D
mAP on the host (`eval/map2d.py`). The best and last weights are written in
the ultralytics `.pt` layout (`models/yolov8.py::save_ultralytics_checkpoint`),
which `YOLOv8Detector.from_weights` and `FusedDetector(yolo_checkpoint=...)`
load. The flags and the report JSON are the JAX CLI's. It runs on cuda
(raising without a GPU) unless `--platform cpu` is given;
`--compilation_cache` (XLA's) raises.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch


def parse_imgsz(s: str):
    """'640' -> 640 (square), '192x640' -> (192, 640)."""
    if "x" in s:
        h, w = s.lower().split("x")
        return (int(h), int(w))
    return int(s)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="sfa3d_tpu_torch YOLOv8 2D training")
    p.add_argument("--dataset_dir", type=str, required=True,
                   help="KITTI layout root (training/{image_2,label_2})")
    p.add_argument("--imgsz", type=str, default="192x640",
                   help="'HxW' or a square int, multiples of 32")
    p.add_argument("--scale", type=str, default="n", choices=["n", "s", "m", "l", "x"])
    p.add_argument("--num_classes", type=int, default=3,
                   help="3 = the KITTI ids (0=Ped 1=Car 2=Cyc)")
    p.add_argument("--max_boxes", type=int, default=32)
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--weight_decay", type=float, default=5e-4)
    p.add_argument("--warmup_epochs", type=float, default=3.0)
    p.add_argument("--ema_decay", type=float, default=0.999)
    p.add_argument("--ema_tau", type=float, default=500.0,
                   help="EMA ramp steps; about a sixth of the run")
    p.add_argument("--hflip_prob", type=float, default=0.5)
    p.add_argument("--val_frac", type=float, default=0.2,
                   help="tail fraction of the sample ids held out for eval "
                        "(ignored when --val_dataset_dir is given)")
    p.add_argument("--val_dataset_dir", type=str, default=None,
                   help="a separate KITTI root for the held-out eval split")
    p.add_argument("--eval_every", type=int, default=20)
    p.add_argument("--eval_batch", type=int, default=8)
    p.add_argument("--eval_conf", type=float, default=0.001)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--checkpoints_dir", type=str, default="./checkpoints/yolo")
    p.add_argument("--out", type=str, default=None, help="write the training report JSON here")
    p.add_argument("--platform", type=str, default=None, choices=["cpu", "cuda"],
                   help="'cpu' runs on the CPU; the default is cuda")
    p.add_argument("--compilation_cache", type=str, default=None)
    return p.parse_args(argv)


def evaluate(eval_fn, val, batch: int, n_classes: int, params=None, conf_floor: float = 0.0):
    """The eval pass over the val split in batches of `batch` (the tail
    padded by repeating its last frame) and its 2D mAP. `val` holds the
    images on the device and the boxes, labels and mask on the host."""
    from sfa3d_tpu_torch.eval.map2d import evaluate_map2d

    images = val["images"]
    n = images.shape[0]
    dets = []
    for i0 in range(0, n, batch):
        imgs = images[i0:i0 + batch]
        pad = batch - imgs.shape[0]
        if pad:
            imgs = torch.cat([imgs, imgs[-1:].expand(pad, *imgs.shape[1:])], 0)
        b, s, c, v = (t.cpu().numpy() for t in eval_fn(imgs, params))
        for j in range(min(batch, n - i0)):
            keep = v[j] & (s[j] > conf_floor)
            dets.append({"boxes": b[j][keep], "scores": s[j][keep], "classes": c[j][keep]})
    gts = [{"boxes": val["boxes"][i][val["mask"][i]], "classes": val["labels"][i][val["mask"][i]]}
           for i in range(n)]
    return evaluate_map2d(dets, gts, num_classes=n_classes)


def main(argv=None):
    from sfa3d_tpu_torch.data.yolo2d import as_hw, list_sample_ids, load_yolo2d_split
    from sfa3d_tpu_torch.device import resolve_device
    from sfa3d_tpu_torch.models.yolov8 import YOLOv8, save_ultralytics_checkpoint
    from sfa3d_tpu_torch.parallel.yolo_step import create_train_state, make_yolo_epoch_fn, make_yolo_eval_fn
    from sfa3d_tpu_torch.runtime.schedules import yolo_adamw

    args = parse_args(argv)
    if args.compilation_cache:
        raise NotImplementedError("--compilation_cache: the XLA compilation cache has no counterpart in the port")
    device = resolve_device("cpu" if args.platform == "cpu" else None)
    hw = as_hw(parse_imgsz(args.imgsz))
    os.makedirs(args.checkpoints_dir, exist_ok=True)

    # data: read once, to the device once
    all_ids = list_sample_ids(args.dataset_dir)
    if args.val_dataset_dir:
        train_ids, val_root, val_ids = all_ids, args.val_dataset_dir, None
    else:
        n_val = max(1, int(round(len(all_ids) * args.val_frac)))
        train_ids, val_ids = all_ids[:-n_val], all_ids[-n_val:]
        val_root = args.dataset_dir
    train = load_yolo2d_split(args.dataset_dir, imgsz=hw, max_boxes=args.max_boxes, sample_ids=train_ids)
    val = load_yolo2d_split(val_root, imgsz=hw, max_boxes=args.max_boxes, sample_ids=val_ids)
    n_train = train["images"].shape[0]
    print(f"train {n_train} frames / val {val['images'].shape[0]} frames @ {hw[0]}x{hw[1]} on {device}",
          flush=True)
    data = {k: torch.from_numpy(v).to(device) for k, v in train.items() if k != "ids"}
    val_dev = {**val, "images": torch.from_numpy(val["images"]).to(device)}

    # model and optimizer
    model = YOLOv8(scale=args.scale, num_classes=args.num_classes)
    model = model.init_weights(torch.Generator().manual_seed(args.seed)).to(device)
    steps_per_epoch = max(1, n_train // args.batch_size)
    tx = yolo_adamw(args.lr, args.weight_decay, args.warmup_epochs, args.epochs, steps_per_epoch)
    state = create_train_state(model, tx, ema=args.ema_decay > 0)
    epoch_fn = make_yolo_epoch_fn(model, tx, hw, ema_decay=args.ema_decay, ema_tau=args.ema_tau,
                                  hflip_prob=args.hflip_prob, device=device)
    eval_fn = make_yolo_eval_fn(model, conf_thresh=args.eval_conf, device=device)

    host_rng = np.random.default_rng(args.seed)
    history, best = [], {"mAP50": -1.0, "epoch": -1}
    t_start = time.time()
    for epoch in range(1, args.epochs + 1):
        perm = host_rng.permutation(n_train)
        if n_train < args.batch_size:
            perm = np.tile(perm, (args.batch_size // n_train) + 1)
        idx = perm[: steps_per_epoch * args.batch_size].reshape(steps_per_epoch, args.batch_size)
        gen = torch.Generator().manual_seed(args.seed * 100003 + epoch)
        state, metrics = epoch_fn(state, data, torch.from_numpy(idx.astype(np.int64)), generator=gen)

        if epoch % args.eval_every == 0 or epoch == args.epochs:
            m = {k: round(float(v), 4) for k, v in metrics.items()}
            ev = evaluate(eval_fn, val_dev, args.eval_batch, args.num_classes, params=state.ema_params)
            row = {"epoch": epoch, "loss": m, **{k: round(v, 4) for k, v in ev.items() if not np.isnan(v)}}
            history.append(row)
            print(json.dumps(row), flush=True)
            if ev["mAP50"] > best["mAP50"]:
                best = {"mAP50": ev["mAP50"], "epoch": epoch, "mAP50_95": ev["mAP50_95"]}
                save_ultralytics_checkpoint(model, os.path.join(args.checkpoints_dir, "best.pt"),
                                            params=state.ema_params)

    save_ultralytics_checkpoint(model, os.path.join(args.checkpoints_dir, "last.pt"), params=state.ema_params)
    report = {
        "imgsz": list(hw), "scale": args.scale, "num_classes": args.num_classes,
        "train_frames": n_train, "val_frames": int(val["images"].shape[0]),
        "epochs": args.epochs, "batch_size": args.batch_size,
        "lr": args.lr, "ema_decay": args.ema_decay, "ema_tau": args.ema_tau,
        "seed": args.seed,
        "wall_seconds": round(time.time() - t_start, 1),
        "history": history, "best": best,
        "checkpoints_dir": os.path.abspath(args.checkpoints_dir),
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    print(f"best mAP50 {best['mAP50']:.4f} @ epoch {best['epoch']} -> {args.checkpoints_dir}/best.pt", flush=True)
    return report


if __name__ == "__main__":
    main()
