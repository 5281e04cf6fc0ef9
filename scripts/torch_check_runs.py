"""Run the five ports of the JAX check scripts at the configurations of the
JAX package's recorded artefacts, in the order their data flows, on one
NVIDIA GPU:

1. generalize (GENERALIZE_CHECK.json's run: 512 / 64 frames, 200 epochs,
   batch 16, effective batch 64, lr 2.5e-4 cosine, EMA 0.998 with tau 200,
   --range_falloff 20, --data_seed 0, float32), killed after the epoch-140
   checkpoint and resumed;
2. trained parity, card against CPU, on 64 held-out frames of that run, at
   its best-val checkpoint's EMA weights;
3. tracking in detector mode (4 x 24 frames, 6 objects, seed 777000) on that
   checkpoint's raw weights, as TRACKING_CHECK.json's run loaded its;
4. fusion on the 64 held-out frames, 4 oracle draws, EMA weights;
5. Argoverse (96 / 24 frames, 80 epochs: ARGOVERSE_CHECK.json's run).

    python3 scripts/torch_check_runs.py --out_dir checks_out

Each check writes TORCH_<NAME>.json and its log into --out_dir; a check
whose gate fails does not stop the later ones. summary.json there lists
every command, its exit code and its wall seconds, and the card's name and
power limit. `--pretrained_path` starts the two training runs from given
weights (e.g. the JAX package's init carried over by
`models.port.state_dict_from_jax`) in place of the seed's. `--checks`
runs only the named checks (trained parity, tracking and fusion need
generalize's checkpoint); `--parity_epochs 60,200` holds those checkpoints
of the generalize run card against CPU too, into
TORCH_TRAINED_PARITY_EPOCH_<N>.json. The runs' data and checkpoints go to
a new temporary directory, which is kept.
Exits 1 when any check exited non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(_ROOT, "scripts")
CHECKS = ("generalize", "trained_parity", "tracking", "fusion", "argoverse")


def _run(name, args, out_dir, summary, log_name=None):
    log_name = log_name or name
    cmd = [sys.executable, os.path.join(SCRIPTS, f"torch_{name}_check.py"), *args]
    print(f"== {name}: {' '.join(cmd[1:])}", flush=True)
    t0 = time.perf_counter()
    with open(os.path.join(out_dir, f"{log_name}.log"), "w") as log:
        rc = subprocess.run(cmd, cwd=_ROOT, stdout=log, stderr=subprocess.STDOUT).returncode
    seconds = time.perf_counter() - t0
    summary["runs"].append({"check": name, "cmd": " ".join(cmd[1:]), "rc": rc, "seconds": seconds})
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    with open(os.path.join(out_dir, f"{log_name}.log")) as f:
        tail = f.read().splitlines()[-3:]
    print(f"   rc {rc}, {seconds:.1f} s: {' | '.join(tail)}", flush=True)
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--pretrained_path", default=None,
                    help="the generalize and Argoverse runs start from these weights, not the seed's init")
    ap.add_argument("--checks", default=",".join(CHECKS), help=f"a comma list of {CHECKS}")
    ap.add_argument("--parity_epochs", default="",
                    help="a comma list of further generalize checkpoints (epochs) for trained parity")
    args = ap.parse_args(argv)
    checks = args.checks.split(",")
    if not set(checks) <= set(CHECKS) or ("generalize" not in checks and set(checks) & set(CHECKS[1:4])):
        ap.error(f"--checks: names from {CHECKS}; trained parity, tracking and fusion need generalize")

    import tempfile

    out_dir = os.path.abspath(args.out_dir)
    os.makedirs(out_dir, exist_ok=True)
    work = tempfile.mkdtemp(prefix="torch_check_runs_")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    summary = {"nvidia_smi": smi, "runs": []}
    out = {name: os.path.join(out_dir, f"TORCH_{name.upper()}_CHECK.json")
           for name in ("generalize", "tracking", "fusion", "argoverse")}
    out["trained_parity"] = os.path.join(out_dir, "TORCH_TRAINED_PARITY.json")
    gen_dir = os.path.join(work, "generalize")
    start = ["--pretrained_path", args.pretrained_path] if args.pretrained_path else []
    rcs = []

    if "generalize" in checks:
        rcs.append(_run("generalize", [
            "--epochs", "200", "--ema_decay", "0.998", "--ema_tau", "200", "--range_falloff", "20",
            "--data_seed", "0", "--kill_after_epoch", "140", "--work_dir", gen_dir, "--keep_tmp",
            "--out", out["generalize"]] + start, out_dir, summary))
    if "generalize" in checks and os.path.isfile(out["generalize"]):
        with open(out["generalize"]) as f:
            epoch = json.load(f)["best"]["epoch"]

        def ckpt(e):
            return os.path.join(gen_dir, "checkpoints", "gen", f"Model_gen_epoch_{e}.pth")

        best = summary["checkpoint"] = ckpt(epoch)
        kitti = os.path.join(gen_dir, "kitti")
        parity = [(best, out["trained_parity"], "trained_parity")] + [
            (ckpt(int(e)), os.path.join(out_dir, f"TORCH_TRAINED_PARITY_EPOCH_{int(e)}.json"),
             f"trained_parity_epoch_{int(e)}") for e in args.parity_epochs.split(",") if e]
        for path, report, log_name in parity if "trained_parity" in checks else []:
            rcs.append(_run("trained_parity", ["--dataset_dir", kitti, "--pretrained_path", path, "--use_ema",
                                               "--num_samples", "64", "--out", report], out_dir, summary, log_name))
        if "tracking" in checks:
            rcs.append(_run("tracking", ["--pretrained_path", best, "--out", out["tracking"]], out_dir, summary))
        if "fusion" in checks:
            rcs.append(_run("fusion", ["--dataset_dir", kitti, "--pretrained_path", best, "--use_ema",
                                       "--out", out["fusion"]], out_dir, summary))
    if "argoverse" in checks:
        rcs.append(_run("argoverse", ["--epochs", "80", "--out", out["argoverse"]] + start, out_dir, summary))
    generalized = "generalize" not in checks or os.path.isfile(out["generalize"])
    return 0 if all(rc == 0 for rc in rcs) and generalized else 1


if __name__ == "__main__":
    sys.exit(main())
