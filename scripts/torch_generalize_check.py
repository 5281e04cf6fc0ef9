"""Generalization check of the port: the training recipe must learn, not
memorise. The port of `scripts/generalize_check.py`.

Trains fpn_resnet_18 through the port's training CLI on distinct synthetic
scenes (`write_mini_kitti`, --range_falloff, --data_seed) with the
reference recipe's shape (cosine LR, batch 16 x subdivisions -> effective
batch 64, rotation / scaling augmentation and hflip on), holds out a
disjoint val split, KILLS the trainer (SIGKILL, by its own PID) once the
epoch --kill_after_epoch checkpoint (`Model_gen_epoch_{N}.pth`) lands,
relaunches it with --auto_resume, then evaluates every kept checkpoint on
the held-out frames with `sfa3d_tpu_torch.cli.eval.main` (one
`bev_raster_reduce` launch a frame; the EMA weights when EMA is on) for the
val mAP curve. The resume evidence is the trainer's log line `resumed from
... at epoch N`; relaunches that find training already complete are kept
apart (`relaunches_found_complete_at_epoch`).

    python3 scripts/torch_generalize_check.py --epochs 200 --ema_decay 0.998 \\
        --ema_tau 200 --range_falloff 20 --data_seed 0 --keep_tmp
    CPU smoke (plumbing only: --smoke reports the gates without enforcing them):
    python3 scripts/torch_generalize_check.py --platform cpu --smoke --frames_train 8 \\
        --frames_val 2 --epochs 2 --checkpoint_freq 1 --batch_size 4 --effective_batch 4 \\
        --kill_after_epoch 1 --kill_delay 0

The trainer runs in strict float32 (--dtype float32, TF32 off) unless --dtype
says otherwise; it and the evaluation run on cuda unless `--platform cpu`
is given (raising without a GPU). The run's directory (--work_dir, else a
new temporary one) holds the scenes, checkpoints and logs; --keep_tmp keeps
it and `--resume_tmp DIR` relaunches training over a previous run's
directory (the scenes are written again, from the same flags, when the
directory holds none) and rebuilds the curve. It writes
TORCH_GENERALIZE_CHECK.json (--out). Exit code 1 when the best held-out
Easy AP is under --min_final_easy or the curve did not climb (not with
--smoke).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import subprocess
import sys
import tempfile
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
sys.path.insert(0, os.path.join(_ROOT, "scripts"))

# the trainer's process: the port's CLI dispatcher with TF32 off, so that
# --compute_dtype float32 is strict float32
STRICT_FP32_LAUNCH = ("import sys, torch; torch.backends.cudnn.allow_tf32 = False; "
                      "torch.backends.cuda.matmul.allow_tf32 = False; "
                      "from sfa3d_tpu_torch.cli.__main__ import main; main(sys.argv[1:])")
RESUMED = re.compile(r"resumed from .*epoch (\d+)")


def train_cmd(args, root, tmp):
    """The trainer's command line: `python -m sfa3d_tpu_torch.cli train`
    (launched with TF32 off) with the JAX script's flags less XLA's cache."""
    cmd = [
        sys.executable, "-c", STRICT_FP32_LAUNCH, "train",
        "--dataset_dir", root,
        "--batch_size", str(args.batch_size),
        "--effective_batch", str(args.effective_batch),
        "--mesh_shape", "1",
        "--num_epochs", str(args.epochs),
        "--checkpoint_freq", str(args.checkpoint_freq),
        "--keep_checkpoints", "0",  # keep every epoch: the eval curve needs them
        "--auto_resume",
        "--print_freq", "8",
        "--num_workers", "4",
        "--lr", str(args.lr),
        "--lr_type", "cosin",
        "--root-dir", tmp,
        "--saved_fn", "gen",
        "--compute_dtype", args.dtype,
        # augmentation on: the reference's train-time OneOf(rotation,
        # scaling) p=0.66 + BEV hflip, the CLI's defaults
    ]
    if args.ema_decay:
        cmd += ["--ema_decay", str(args.ema_decay), "--ema_tau", str(args.ema_tau)]
    if args.pretrained_path:
        cmd += ["--pretrained_path", args.pretrained_path]
    if args.platform == "cpu":
        cmd += ["--platform", "cpu"]
    return cmd


def _epoch(path: str) -> int:
    return int(os.path.splitext(path)[0].rsplit("_", 1)[-1])


def resume_epochs(tmp: str):
    """Every `resumed from ... at epoch N` of the trainer's log, in order."""
    found = []
    for logf in sorted(glob.glob(os.path.join(tmp, "logs", "**", "logger_gen.txt"), recursive=True)):
        with open(logf) as f:
            for line in f:
                m = RESUMED.search(line)
                if m:
                    found.append(int(m.group(1)))
    return found


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default=None, choices=["cpu", "cuda"],
                    help="'cpu' runs on the CPU; the default is cuda")
    ap.add_argument("--frames_train", type=int, default=512)
    ap.add_argument("--frames_val", type=int, default=64)
    # lr 2.5e-4: the accumulation SUMS micro-batch gradients, so 1e-3 at 4 slices oscillates
    ap.add_argument("--epochs", type=int, default=300)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--effective_batch", type=int, default=64)
    ap.add_argument("--checkpoint_freq", type=int, default=20)
    ap.add_argument("--lr", type=float, default=2.5e-4)
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--ema_decay", type=float, default=0.0,
                    help="train with a parameter EMA and evaluate the EMA weights")
    ap.add_argument("--ema_tau", type=float, default=2000.0,
                    help="EMA ramp time-constant in optimizer steps (about 200 suits this harness's "
                         "scale; at 2000 the ramp never completes)")
    ap.add_argument("--kill_after_epoch", type=int, default=None,
                    help="SIGKILL the trainer once this epoch's checkpoint lands (default: epochs // 3 "
                         "rounded to a checkpoint; 0 disables the kill)")
    ap.add_argument("--kill_delay", type=float, default=10.0,
                    help="seconds between the checkpoint landing and the kill (the next epoch gets "
                         "under way)")
    ap.add_argument("--min_final_easy", type=float, default=0.5)
    ap.add_argument("--range_falloff", type=float, default=0.0,
                    help="synthetic LiDAR 1/r^2 point-density falloff (full density within this "
                         "range, metres; 0 = uniform)")
    ap.add_argument("--data_seed", type=int, default=0, help="seed of the synthetic scene population")
    ap.add_argument("--pretrained_path", default=None,
                    help="start training from these weights (a .pth) instead of the seed's init")
    ap.add_argument("--smoke", action="store_true",
                    help="plumbing-only run: report the accuracy gates but exit 0 if they fail")
    ap.add_argument("--out", default=os.path.join(_ROOT, "TORCH_GENERALIZE_CHECK.json"))
    ap.add_argument("--work_dir", default=None, help="the run's directory (default: a new temp dir)")
    ap.add_argument("--keep_tmp", action="store_true")
    ap.add_argument("--resume_tmp", default=None,
                    help="a previous run's directory: skip the kill phase, relaunch the trainer with "
                         "--auto_resume on the surviving checkpoints and rebuild the whole curve; pass "
                         "the SAME config flags as that run")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch_check_common as common

    from sfa3d_tpu_torch.data.synthetic import write_mini_kitti

    device = common.resolve(args.platform)
    kill_epoch = args.kill_after_epoch
    if kill_epoch is None:
        kill_epoch = max(args.checkpoint_freq, (args.epochs // 3) // args.checkpoint_freq * args.checkpoint_freq)

    n = args.frames_train + args.frames_val
    tmp = args.resume_tmp or args.work_dir or tempfile.mkdtemp(prefix="torch_generalize_")
    root = os.path.join(tmp, "kitti")
    velodyne = os.path.join(root, "training", "velodyne")
    if args.resume_tmp:
        kill_epoch = 0  # the failure that ended the earlier run was the kill
        print(f"resuming the run under {tmp}")
    if args.resume_tmp and os.path.isdir(velodyne):
        n_found = len(os.listdir(velodyne))
        if n_found != n:
            raise ValueError(f"--resume_tmp {tmp} holds {n_found} scenes but the flags say {n}; pass the "
                             "original run's --frames_train / --frames_val / --data_seed")
    else:
        print(f"writing {n} synthetic scenes ({args.frames_train} train / {args.frames_val} HELD-OUT val) "
              f"under {root}", flush=True)
        write_mini_kitti(root, n_frames=n, seed=args.data_seed, cameras=False, range_falloff=args.range_falloff,
                         splits={"train": range(args.frames_train), "val": range(args.frames_train, n),
                                 "test": range(args.frames_train, n)})

    cmd = train_cmd(args, root, tmp)
    ckpt_dir = os.path.join(tmp, "checkpoints", "gen")
    env = dict(os.environ)
    env["PYTHONPATH"] = _ROOT + os.pathsep + env.get("PYTHONPATH", "")

    t_start = time.time()
    killed_at = None
    if kill_epoch:
        # phase 1: launch, wait for the kill_epoch checkpoint, SIGKILL the
        # trainer's own PID once the next epoch is under way
        print(f"phase 1: {' '.join(cmd)}", flush=True)
        proc = subprocess.Popen(cmd, cwd=_ROOT, env=env)
        target = os.path.join(ckpt_dir, f"Model_gen_epoch_{kill_epoch}.pth")
        deadline = time.time() + 7200
        while time.time() < deadline and proc.poll() is None:
            if os.path.exists(target):
                time.sleep(args.kill_delay)
                break
            time.sleep(0.2)
        if proc.poll() is None:
            proc.kill()
            proc.wait()
            killed_at = kill_epoch
            print(f"killed trainer after epoch-{kill_epoch} checkpoint landed", flush=True)
        else:
            print(f"trainer exited before the kill point (rc={proc.returncode}); continuing")

    # phase 2 (or the only phase): run to completion; --auto_resume picks up
    print("phase 2: relaunch to completion (auto_resume)", flush=True)
    rc = subprocess.run(cmd, cwd=_ROOT, env=env).returncode
    if rc != 0:
        raise RuntimeError(f"training failed rc={rc}")
    train_s = time.time() - t_start

    # a relaunch that finds training already complete logs a resume from the
    # last epoch too: bookkeeping, not a recovery, so it is kept apart
    resume_history = resume_epochs(tmp)
    relaunches_found_complete = [e for e in resume_history if e >= args.epochs]
    resume_history = [e for e in resume_history if e < args.epochs]
    resumed_from = resume_history[-1] if resume_history else None
    if killed_at is not None and (resumed_from is None or resumed_from < killed_at):
        raise RuntimeError(f"expected auto-resume from >= epoch {killed_at}, log says {resumed_from}")

    # held-out eval of every kept checkpoint -> the mAP curve
    from sfa3d_tpu_torch.cli import eval as eval_cli

    ckpts = sorted(glob.glob(os.path.join(ckpt_dir, "Model_gen_epoch_*.pth")), key=_epoch)
    if not ckpts:
        raise RuntimeError(f"no checkpoints under {ckpt_dir}")
    launches0 = common.launches()
    t0 = time.time()
    curve = []
    for ckpt in ckpts:
        res = eval_cli.main([
            "--dataset_dir", root,
            "--split", "val",
            "--num_samples", str(args.frames_val),
            "--pretrained_path", ckpt,
            "--peak_thresh", "0.2",
        ] + (["--use_ema"] if args.ema_decay else []) + (["--platform", "cpu"] if device.type == "cpu" else []))
        row = {
            "epoch": _epoch(ckpt),
            "val_mAP": round(res["mAP"], 4),
            # orientation quality (KITTI AOS): catches a direction-head
            # collapse that box-IoU AP alone can miss
            "val_mAOS": round(res.get("mAOS", 0.0), 4),
            "by_difficulty": {k: round(v["mAP"], 4) for k, v in res.get("by_difficulty", {}).items()},
            "per_class": {k: round(v, 4) for k, v in res.items() if k.startswith("AP_") and not isinstance(v, dict)},
        }
        curve.append(row)
        print(json.dumps(row), flush=True)
    eval_s = time.time() - t0
    after = common.launches()

    final = curve[-1]
    early = curve[0]
    # model selection on the held-out split: the deliverable checkpoint is
    # the best-val one, not the last epoch
    best = max(curve, key=lambda r: r["val_mAP"])
    climbed = best["val_mAP"] > early["val_mAP"]
    failures = []
    if best["by_difficulty"].get("Easy", best["val_mAP"]) < args.min_final_easy:
        failures.append(f"best held-out Easy AP {best['by_difficulty'].get('Easy')} < {args.min_final_easy}")
    if not climbed:
        failures.append("val mAP did not climb across the curve")
    report = {
        "cmd": " ".join(["python", "scripts/torch_generalize_check.py"] + (sys.argv[1:] if argv is None else argv)),
        "config": {
            "frames_train": args.frames_train,
            "frames_val": args.frames_val,
            "epochs": args.epochs,
            "batch_size": args.batch_size,
            "effective_batch": args.effective_batch,
            "lr": args.lr, "lr_type": "cosin",
            "ema_decay": args.ema_decay or None,
            "ema_tau": args.ema_tau if args.ema_decay else None,
            "range_falloff": args.range_falloff or None,
            "data_seed": args.data_seed,
            "augmentation": "ON (reference defaults: OneOf(rotation, scaling) p=0.66 + hflip)",
            "dtype": args.dtype,
        },
        "killed_after_epoch": killed_at,
        "auto_resumed_from_epoch": resumed_from,
        "resume_history": resume_history,
        # relaunches that found training already finished (no steps run);
        # non-empty here does NOT mean the curve came from a resume
        "relaunches_found_complete_at_epoch": relaunches_found_complete,
        "val_map_curve": curve,
        "best": best,
        "final": final,
        "climbed": climbed,
        "gate": {
            "min_best_easy": args.min_final_easy,
            "must_climb": True,
            "pass": not failures,
            "failures": failures,
        },
        "train_seconds": train_s,
        "eval_seconds": eval_s,
        "work_dir": tmp if args.keep_tmp else None,
        "device": common.device_record(device),
        "launches": {k: after[k] - launches0[k] for k in after},
    }
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    print(f"wrote {args.out}")

    if not args.keep_tmp:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)

    if failures and args.smoke:
        for f_ in failures:
            print(f"smoke mode: gate not enforced: {f_}")
        print("GENERALIZE SMOKE OK (plumbing only)")
    elif failures:
        for f_ in failures:
            print(f"FAIL: {f_}")
        return 1
    else:
        print("GENERALIZE CHECK OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
