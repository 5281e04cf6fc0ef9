"""Tracking check of the port: detector + Kalman tracker, scored with
CLEAR-MOT. The port of `scripts/tracking_check.py`.

Runs the port's detection path (one `bev_raster_reduce` launch and one
`detect_bev` a frame) with a trained checkpoint over held-out moving scenes
(`moving_scene_sequence`: the same objects moving at constant per-object
velocities), feeds the metric boxes through `tracking.track_sequence` (one
`track_associate` launch a frame) and scores the result against the
generator's identities with `tracking.metrics.clear_mot` (MOTA, MOTP, IDF1,
ID switches, MT / ML).

    python3 scripts/torch_tracking_check.py --pretrained_path CKPT.pth
    python3 scripts/torch_tracking_check.py --oracle --platform cpu --n_seqs 1 --n_frames 6 --n_objects 4

`--oracle` replaces the detector with ground-truth boxes and Gaussian
centre noise: the tracker-only upper bound. It runs on cuda unless
`--platform cpu` is given (raising without a GPU), in strict float32. It
writes TORCH_TRACKING_CHECK.json (--out): the JAX artefact's keys, the card
under `device`, the kernels' launches, and each sequence's track ids a
frame. Exit code 1 when the Car IDF1 is under --min_idf1 (not with
--smoke).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
sys.path.insert(0, os.path.join(_ROOT, "scripts"))


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pretrained_path", default=None)
    ap.add_argument("--arch", default="fpn_resnet_18")
    ap.add_argument("--platform", default=None, choices=["cpu", "cuda"],
                    help="'cpu' runs on the CPU; the default is cuda")
    ap.add_argument("--n_seqs", type=int, default=4)
    ap.add_argument("--n_frames", type=int, default=24)
    ap.add_argument("--n_objects", type=int, default=6)
    ap.add_argument("--seq_seed", type=int, default=777000,
                    help="base scene seed; keep clear of every training population "
                         "(0.. and 100000.. are used by the generalization runs)")
    ap.add_argument("--K", type=int, default=50)
    ap.add_argument("--peak_thresh", type=float, default=0.3)
    ap.add_argument("--min_hits", type=int, default=2)
    ap.add_argument("--max_age", type=int, default=3)
    ap.add_argument("--dist_gate", type=float, default=2.0)
    ap.add_argument("--oracle", action="store_true",
                    help="GT boxes + noise instead of the detector (tracker-only upper bound)")
    ap.add_argument("--oracle_noise", type=float, default=0.15)
    ap.add_argument("--out", default=os.path.join(_ROOT, "TORCH_TRACKING_CHECK.json"))
    ap.add_argument("--min_idf1", type=float, default=0.5, help="gate on the Car-class IDF1")
    ap.add_argument("--smoke", action="store_true", help="report the gate but always exit 0")
    return ap.parse_args(argv)


def detect_sequence(model, device, frames, args):
    """Run the detector frame by frame -> tracker-input arrays (F, K, 8),
    (F, K), (F, K). `model` lies on `device` (the JAX twin's `variables`
    argument: a torch model carries its weights)."""
    import torch

    from sfa3d_tpu_torch.ops.bev import _pad_raw, points_to_bev
    from sfa3d_tpu_torch.pipeline import detect_bev

    F = len(frames)
    boxes = np.zeros((F, args.K, 8), np.float32)
    scores = np.zeros((F, args.K), np.float32)
    valid = np.zeros((F, args.K), bool)
    for f, (pts_raw, _labels, _ids) in enumerate(frames):
        pts, ok = _pad_raw(pts_raw)
        with torch.inference_mode():
            bev = points_to_bev(torch.from_numpy(pts).to(device), torch.from_numpy(ok).to(device))
        dets, _, boxes_real, mask = detect_bev(model, bev[None], K=args.K, peak_thresh=args.peak_thresh)
        boxes[f] = boxes_real[0].cpu().numpy()
        scores[f] = dets[0, :, 0].cpu().numpy()
        valid[f] = mask[0].cpu().numpy()
    return boxes, scores, valid


def oracle_sequence(frames, args, rng):
    """GT boxes with centre noise in the detector's output layout."""
    F = len(frames)
    boxes = np.zeros((F, args.K, 8), np.float32)
    scores = np.zeros((F, args.K), np.float32)
    valid = np.zeros((F, args.K), bool)
    for f, (_pts, labels, _ids) in enumerate(frames):
        n = len(labels)
        boxes[f, :n] = labels
        boxes[f, :n, 1:3] += rng.normal(0, args.oracle_noise, (n, 2))
        scores[f, :n] = 0.9
        valid[f, :n] = True
    return boxes, scores, valid


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch_check_common as common

    from sfa3d_tpu_torch.data.synthetic import moving_scene_sequence
    from sfa3d_tpu_torch.tracking import track_sequence
    from sfa3d_tpu_torch.tracking.metrics import clear_mot, tracker_output_to_frames

    device = common.resolve(args.platform)
    model = None
    if not args.oracle:
        from sfa3d_tpu_torch.cli.eval import load_model

        model = load_model(args.arch, args.pretrained_path, False, device)

    launches0 = common.launches()
    rng = np.random.default_rng(args.seq_seed)
    per_seq = []
    agg = {"overall": [], "car": []}
    t0 = time.time()
    for s in range(args.n_seqs):
        seed = args.seq_seed + s
        frames = moving_scene_sequence(args.n_frames, seed=seed, n_objects=args.n_objects)
        if args.oracle:
            boxes, scores, valid = oracle_sequence(frames, args, rng)
        else:
            boxes, scores, valid = detect_sequence(model, device, frames, args)
        outs = track_sequence(boxes, scores, valid, max_tracks=64, min_hits=args.min_hits,
                              max_age=args.max_age, device=device)
        outs = {k: v.cpu().numpy() for k, v in outs.items()}

        tracked = tracker_output_to_frames(outs)
        gt_all = [(ids, labels[:, 1:3]) for _p, labels, ids in frames]
        m_all = clear_mot(gt_all, tracked, dist_gate=args.dist_gate)
        gt_car = [(ids[labels[:, 0] == 1], labels[labels[:, 0] == 1, 1:3]) for _p, labels, ids in frames]
        m_car = clear_mot(gt_car, tracker_output_to_frames(outs, cls=1), dist_gate=args.dist_gate)
        per_seq.append({"seed": seed, "overall": m_all, "car": m_car,
                        "track_ids": [[int(i) for i in ids] for ids, _ in tracked]})
        agg["overall"].append(m_all)
        agg["car"].append(m_car)
        print(f"seq {s} (seed {seed}): MOTA {m_all['mota']:.3f} IDF1 {m_all['idf1']:.3f} "
              f"IDSW {m_all['id_switches']} | Car MOTA {m_car['mota']:.3f} IDF1 {m_car['idf1']:.3f}")

    def mean(key, which):
        rows = [m for m in agg[which] if m["n_gt"] > 0]
        return round(float(np.mean([m[key] for m in rows])), 4) if rows else None

    summary = {w: {k: mean(k, w) for k in ("mota", "motp", "idf1", "idp", "idr")}
               | {k: int(np.sum([m[k] for m in agg[w]])) for k in
                  ("id_switches", "false_positives", "misses", "matches", "n_gt", "mostly_tracked",
                   "mostly_lost", "n_gt_trajectories")}
               for w in ("overall", "car")}
    after = common.launches()
    record = {
        "cmd": "python scripts/torch_tracking_check.py " + " ".join(sys.argv[1:] if argv is None else argv),
        "mode": "oracle(gt+noise)" if args.oracle else "detector",
        "checkpoint": args.pretrained_path,
        "config": {k: getattr(args, k) for k in
                   ("n_seqs", "n_frames", "n_objects", "seq_seed", "K", "peak_thresh", "min_hits",
                    "max_age", "dist_gate")},
        "summary": summary,
        "per_seq": per_seq,
        "wall_s": round(time.time() - t0, 1),
        "device": common.device_record(device),
        "launches": {k: after[k] - launches0[k] for k in after},
        "notes": "held-out moving scenes (constant-velocity objects); GT identities from the "
                 f"generator; CLEAR-MOT gate {args.dist_gate} m BEV-center distance",
    }
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    print("wrote", args.out)

    car_idf1 = summary["car"]["idf1"]
    ok = car_idf1 is not None and car_idf1 >= args.min_idf1
    print(("PASS" if ok else "FAIL") + f": Car IDF1 {car_idf1} (gate {args.min_idf1})")
    return 0 if ok or args.smoke else 1


if __name__ == "__main__":
    sys.exit(main())
