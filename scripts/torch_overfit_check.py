"""Close the port's training story end to end: cli.train -> checkpoint ->
cli.eval, the port of `scripts/overfit_check.py`.

Overfits fpn_resnet_18 on a few synthetic mini-KITTI frames (the port's
`write_mini_kitti`) through the port's training CLI, with augmentation off
and float32 compute, then evaluates the saved checkpoint on the same frames
with the port's eval CLI and checks the mAP: training, checkpointing,
checkpoint loading, decoding and the AP evaluator agree end to end.

On the card (a few minutes):  python3 scripts/torch_overfit_check.py
On the CPU (slow; a smoke):   python3 scripts/torch_overfit_check.py --platform cpu --epochs 2

Prints the JAX script's JSON line (overfit_mAP, per_class, epochs, frames)
with the wall seconds of training and evaluation, the checkpoint's path,
the platform and the start (--seed, --pretrained_path: the outcome of 8
frames depends on the initialisation) added, then `OVERFIT CHECK OK`, or
`FAIL: ...` and exit
code 1 when the mAP is under --min_map. The run's directory (mini-KITTI,
checkpoint, logs) is --work_dir, a new temporary directory by default,
and is kept, so that `scripts/torch_bf16_audit.py` can read the
checkpoint.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default=None, choices=["cpu", "cuda"],
                    help="'cpu' runs on the CPU; the default is cuda")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--epochs", type=int, default=1000)
    ap.add_argument("--batch_size", type=int, default=8)
    # the JAX run found lr 1e-3 at batch 8 oscillating; 5e-4 converges
    ap.add_argument("--lr", type=float, default=5e-4)
    ap.add_argument("--min_map", type=float, default=0.5,
                    help="hard-failure floor; the expected overfit mAP is about 1.0")
    ap.add_argument("--work_dir", default=None, help="where the run writes (default: a new temp dir)")
    ap.add_argument("--seed", type=int, default=None, help="the training seed (default: the CLI's, 2020)")
    ap.add_argument("--pretrained_path", default=None,
                    help="start from these weights (a .pth) instead of the seed's init")
    args = ap.parse_args(argv)

    import torch

    # float32 is strict float32, the port's parity mode: PyTorch's default
    # runs cuDNN's float32 convolutions in TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    from sfa3d_tpu_torch.cli.eval import main as eval_main
    from sfa3d_tpu_torch.cli.train import main as train_main
    from sfa3d_tpu_torch.data.synthetic import write_mini_kitti

    tmp = args.work_dir or tempfile.mkdtemp(prefix="torch_overfit_")
    root = write_mini_kitti(os.path.join(tmp, "kitti"), n_frames=args.frames)
    platform = ["--platform", args.platform] if args.platform else []
    start = (["--seed", str(args.seed)] if args.seed is not None else []) + \
        (["--pretrained_path", args.pretrained_path] if args.pretrained_path else [])

    t0 = time.perf_counter()
    train_main([
        "--dataset_dir", root,
        "--num_samples", str(args.frames),
        "--batch_size", str(args.batch_size),
        "--effective_batch", str(args.batch_size),
        "--mesh_shape", "1",
        "--num_epochs", str(args.epochs),
        "--checkpoint_freq", str(args.epochs),  # one checkpoint, at the end
        "--print_freq", "10",
        "--num_workers", "2",
        "--no-val",
        "--lr", str(args.lr),
        "--lr_type", "cosin",
        "--root-dir", tmp,
        "--saved_fn", "overfit",
        "--compute_dtype", "float32",
        "--hflip_prob", "0.0",
        "--aug_prob", "0.0",  # memorisation: no rotation or scaling
    ] + platform + start)
    train_s = time.perf_counter() - t0

    ckpts = sorted(glob.glob(os.path.join(tmp, "checkpoints", "overfit", "*.pth")))
    if not ckpts:
        raise AssertionError(f"no checkpoint written under {tmp}")
    ckpt = ckpts[-1]
    print(f"evaluating checkpoint {ckpt}")

    t0 = time.perf_counter()
    results = eval_main([
        "--dataset_dir", root,
        "--split", "val",  # the mini fixture's val split holds the training frames
        "--num_samples", str(args.frames),
        "--pretrained_path", ckpt,
        "--peak_thresh", "0.2",
    ] + platform)
    eval_s = time.perf_counter() - t0
    print(json.dumps({
        "overfit_mAP": results["mAP"],
        "per_class": {k: v for k, v in results.items() if k.startswith("AP_") and not isinstance(v, dict)},
        "epochs": args.epochs,
        "frames": args.frames,
        "train_seconds": train_s,
        "eval_seconds": eval_s,
        "checkpoint": ckpt,
        "dataset_dir": root,
        "platform": args.platform or "cuda",
        "seed": args.seed,
        "pretrained_path": args.pretrained_path,
    }))
    if results["mAP"] < args.min_map:
        print(f"FAIL: overfit mAP {results['mAP']:.3f} < {args.min_map}")
        return 1
    print("OVERFIT CHECK OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
