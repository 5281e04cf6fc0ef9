"""Trained-operating-point parity of the port, card against CPU: the
port's own form of `scripts/trained_parity_check.py`.

The tier-1 tests pin the port against the JAX package at random init with
the heatmap bias raised; the converged operating point (sharp peaks,
saturated clamped sigmoids, top-K ties) is where a device difference would
show. This check loads a trained checkpoint (the generalize run's, its EMA
weights with --use_ema) and, for each held-out frame:

1. makes ONE BEV on the device with the port's raster (one
   `bev_raster_reduce` launch) and the same BEV on the CPU (the plain
   version): height and intensity must be bit-exact, the density within
   DENSITY_TOL (the log of a count may differ by an ulp between the card's
   libm and the CPU's, as chip_smoke.py's raster phase allows);
2. runs KFPN -> `ops/decode.py` -> `detections_to_real` on that BEV twice,
   on the device and on the CPU in strict float32, on a copy of the same
   BEV;
3. holds every detection within --atol (1e-3): rows [cls, x, y, z, h, w, l,
   yaw] compared after a lexicographic sort, yaw mod 2 pi (atan2's branch
   cut makes +-pi the same angle); a count mismatch fails, and is recorded
   with both sides' scores nearest the threshold (the JAX script stops
   there; this one goes on to the next frame). The largest difference of
   the K decoded scores, threshold or not, is reported beside, and the
   decoded peaks whose score is the clamped sigmoid's ceiling (1 - 1e-4),
   by class: a plateau of such cells makes each of them a peak.

Two witnesses tell a tie that float noise flips from a fault of the card:

- heatmap card vs CPU: the largest gap of the clamped-sigmoid heatmap
  between the sides over every cell, and each heatmap peak (a cell equal to
  its 3 x 3 maximum, as `ops/decode.py::heat_nms` keeps it) above the
  threshold on one side only, with its value and its margin over its 8
  neighbours on both sides. A flip needs margins of opposite sign, so both
  lie within twice the gap: a gap of float noise (1e-6) makes every flip a
  tie of that size, a fault shows as a large gap;
- CPU vs CPU, one ulp: the CPU side again on the same BEV with every
  nonzero cell moved up by one float32 ulp (`torch.nextafter`), compared as
  the card is. Where the checkpoint's peaks are as fragile on the CPU alone,
  the card's count mismatches are not the card's.

Neither enters the gate: `pass` is the card-vs-CPU comparison alone.

    python3 scripts/torch_trained_parity_check.py --dataset_dir RUN/kitti \\
        --pretrained_path RUN/checkpoints/gen/Model_gen_epoch_N.pth --use_ema --num_samples 64

The JAX script's other half (the weights loaded into the reference's own
PoseResNet) needs the reference source tree, which the port does not carry;
port against JAX at a sharpened operating point is a tier-1 test
(tests/test_torch_trained_parity_check.py). It runs on cuda unless
`--platform cpu` is given (then both sides run on the CPU: a smoke), and
writes TORCH_TRAINED_PARITY.json (--out): frames, detections compared, worst
difference, worst frames, pass. Exit code 1 on a failed comparison or no
detection.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict

import numpy as np
import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
sys.path.insert(0, os.path.join(_ROOT, "scripts"))

FIELDS = "[cls, x, y, z_bottom, h, w, l, yaw (mod 2pi)]"
DENSITY_TOL = 1.2e-7  # the density channel, card vs CPU: one float32 ulp of log between two libms
CEILING = np.float32(1.0 - 1e-4)  # models.clamped_sigmoid's upper clamp in float32


def sorted_rows(rows: np.ndarray) -> np.ndarray:
    """Detection rows [cls, x, y, ...] in lexicographic (cls, x, y) order."""
    return rows[np.lexsort((rows[:, 2], rows[:, 1], rows[:, 0]))]


def _row_gaps(o: np.ndarray, r: np.ndarray) -> np.ndarray:
    """|o - r| per field, yaw (column 7) on the circle."""
    diff = np.abs(o - r)
    diff[..., 7] = np.abs((o[..., 7] - r[..., 7] + np.pi) % (2 * np.pi) - np.pi)
    return diff


def compare_detections(ours: np.ndarray, ref: np.ndarray):
    """Two frames' (N, 8) metric rows -> (max abs difference, None), or
    (None, {"ours": n, "ref": m}) when the counts differ. Yaw is compared on
    the circle. Rows are paired after a lexicographic sort, or by an optimal
    assignment on their largest field difference (within a class) where
    that pairs them closer: detections of one class in one heatmap row share
    x to within float noise, so their sort order is noise."""
    from scipy.optimize import linear_sum_assignment

    if len(ours) != len(ref):
        return None, {"ours": int(len(ours)), "ref": int(len(ref))}
    if not len(ours):
        return 0.0, None
    o, r = sorted_rows(np.asarray(ours, np.float64)), sorted_rows(np.asarray(ref, np.float64))
    cost = _row_gaps(o[:, None, :], r[None, :, :]).max(-1)
    cost[o[:, None, 0] != r[None, :, 0]] = 1e30  # never across classes
    i, j = linear_sum_assignment(cost)
    return min(float(_row_gaps(o, r).max()), float(cost[i, j].max())), None


def detect_rows(model, bev, K: int, peak_thresh: float):
    """(H, W, 3) BEV on the model's device -> the frame's masked metric
    rows (N, 8) [cls, x, y, z, h, w, l, yaw] (KFPN -> decode ->
    detections_to_real), all K decoded peaks (K, 10) [score, ..., cls] in
    descending score order, and the clamped-sigmoid heatmap (H/4, W/4, C)
    that decode read."""
    from sfa3d_tpu_torch.models import clamped_sigmoid
    from sfa3d_tpu_torch.pipeline import _decode_heads, forward_heads

    with torch.inference_mode():
        heads = forward_heads(model, bev[None])
        dets, _, boxes_real, mask = _decode_heads(heads, K, peak_thresh)
        heat = clamped_sigmoid(heads["hm_cen"])[0].float().cpu().numpy()
    dets = dets[0].cpu().numpy()
    return boxes_real[0][mask[0]].cpu().numpy(), dets[np.argsort(-dets[:, 0], kind="stable")], heat


def neighbour_max(heat: np.ndarray) -> np.ndarray:
    """(H, W, C) -> the largest of each cell's 8 neighbours (-inf outside),
    per class."""
    h, w, _ = heat.shape
    p = np.pad(heat, ((1, 1), (1, 1), (0, 0)), constant_values=-np.inf)
    return np.max([p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
                   for dy in (-1, 0, 1) for dx in (-1, 0, 1) if dy or dx], axis=0)


def peak_flips(ours: np.ndarray, ref: np.ndarray, thresh: float) -> Dict[str, object]:
    """Two sides' (H, W, C) heatmaps -> their largest gap, the peaks above
    `thresh` on one side only (cells equal to their 3 x 3 maximum), each
    with its value and its margin over its 8 neighbours on both sides, and
    the margins of `ref`'s peaks above `thresh`."""
    m_ours, m_ref = ours - neighbour_max(ours), ref - neighbour_max(ref)
    peak_ours, peak_ref = m_ours >= 0, m_ref >= 0
    flips = np.argwhere((peak_ours != peak_ref) & (np.maximum(ours, ref) > thresh))
    return {
        "gap": float(np.abs(ours - ref).max()),
        "flips": [{"y": int(y), "x": int(x), "cls": int(c), "ours": float(ours[y, x, c]),
                   "ref": float(ref[y, x, c]), "ours_margin": float(m_ours[y, x, c]),
                   "ref_margin": float(m_ref[y, x, c])} for y, x, c in flips],
        "ref_peak_margins": m_ref[peak_ref & (ref > thresh)].astype(np.float64),
    }


def one_ulp_up(bev):
    """Every nonzero cell of a BEV moved up by one float32 ulp."""
    return torch.where(bev != 0, torch.nextafter(bev, torch.full_like(bev, float("inf"))), bev)


class Witness:
    """Accumulates `peak_flips` and the detection comparison of one pair of
    sides over the frames."""

    def __init__(self, keep: int = 16):
        self.keep = keep
        self.gap, self.n_flips, self.flip_frames, self.flip_margin, self.flips = 0.0, 0, [], 0.0, []
        self.mismatches, self.differing, self.worst, self.margins = [], [], 0.0, []

    def add(self, frame: int, flips, d, count, atol: float) -> None:
        self.gap = max(self.gap, flips["gap"])
        self.margins.append(flips["ref_peak_margins"])
        if flips["flips"]:
            self.n_flips += len(flips["flips"])
            self.flip_frames.append(frame)
            self.flip_margin = max(self.flip_margin, *(max(abs(f["ours_margin"]), abs(f["ref_margin"]))
                                                       for f in flips["flips"]))
            self.flips += [{"frame": frame, **f} for f in flips["flips"]][:max(0, self.keep - len(self.flips))]
        if count is not None:
            self.mismatches.append(frame)
        elif d > atol:
            self.differing.append(frame)
        else:
            self.worst = max(self.worst, d)

    def report(self, thresh: float) -> Dict[str, object]:
        margins = np.concatenate(self.margins) if self.margins else np.zeros(0)
        return {
            "heatmap_worst_gap": self.gap,
            "peak_flips_above_threshold": self.n_flips,
            "frames_with_flips": len(self.flip_frames),
            # the largest |margin over the 8 neighbours| of a flipped peak, on either side
            "flipped_peaks_worst_margin": self.flip_margin,
            "frames_with_count_mismatch": len(self.mismatches),
            "frames_beyond_atol": len(self.differing),
            "worst_abs_diff_within_atol": self.worst,
            # the reference side's peaks above the threshold, and how many of them lie within
            # twice the heatmap's worst gap of a neighbour: the ties the gap can flip
            "ref_peaks_above_threshold": int(margins.size),
            "ref_peaks_within_two_gaps": int((margins <= 2 * self.gap).sum()),
            "ref_peak_margin_quantiles": {str(q): float(np.quantile(margins, q)) if margins.size else None
                                          for q in (0.0, 0.01, 0.05, 0.5)},
            "threshold": thresh,
            "flips": self.flips,
        }


def saturated(peaks: np.ndarray) -> np.ndarray:
    """The decoded peaks whose score is the clamped sigmoid's ceiling: a
    plateau of such cells makes every one of them a 3 x 3 peak."""
    return peaks[peaks[:, 0] == CEILING]


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset_dir", required=True)
    ap.add_argument("--pretrained_path", required=True)
    ap.add_argument("--arch", default="fpn_resnet_18")
    ap.add_argument("--split", default="val")
    ap.add_argument("--num_samples", type=int, default=64)
    ap.add_argument("--K", type=int, default=50)
    ap.add_argument("--peak_thresh", type=float, default=0.2)
    ap.add_argument("--use_ema", action="store_true")
    ap.add_argument("--atol", type=float, default=1e-3)
    ap.add_argument("--platform", default=None, choices=["cpu", "cuda"],
                    help="'cpu' runs both sides on the CPU (a smoke); the default is cuda")
    ap.add_argument("--out", default=os.path.join(_ROOT, "TORCH_TRAINED_PARITY.json"))
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch_check_common as common

    from sfa3d_tpu_torch.cli.eval import load_model
    from sfa3d_tpu_torch.data.kitti import KittiDataset
    from sfa3d_tpu_torch.ops.bev import points_to_bev

    device = common.resolve(args.platform)
    cpu = torch.device("cpu")
    model = load_model(args.arch, args.pretrained_path, args.use_ema, device)
    model_cpu = load_model(args.arch, args.pretrained_path, args.use_ema, cpu)
    dataset = KittiDataset(args.dataset_dir, mode=args.split, hflip_prob=0.0, num_samples=args.num_samples)

    launches0 = common.launches()
    n_det_total, worst, raster_worst, density_worst, score_worst = 0, 0.0, 0.0, 0.0, 0.0
    per_frame, mismatches, ceiling_classes = [], [], []
    card_vs_cpu, one_ulp = Witness(), Witness()
    for idx in range(len(dataset)):
        sample = dataset[idx]
        pts, valid = torch.from_numpy(sample.points), torch.from_numpy(sample.valid)
        with torch.inference_mode():
            bev = points_to_bev(pts.to(device), valid.to(device))
            bev_host = bev.cpu()
            bev_cpu = points_to_bev(pts, valid)
        gap = (bev_host - bev_cpu).abs()
        raster_worst = max(raster_worst, float(gap[..., :2].max()))
        density_worst = max(density_worst, float(gap[..., 2].max()))
        ours, ours_peaks, ours_heat = detect_rows(model, bev, args.K, args.peak_thresh)
        ref, ref_peaks, ref_heat = detect_rows(model_cpu, bev_host.clone(), args.K, args.peak_thresh)
        ulp, _, ulp_heat = detect_rows(model_cpu, one_ulp_up(bev_host), args.K, args.peak_thresh)
        frame = int(sample.sample_id)
        card_vs_cpu.add(frame, peak_flips(ours_heat, ref_heat, args.peak_thresh), *compare_detections(ours, ref),
                        args.atol)
        one_ulp.add(frame, peak_flips(ulp_heat, ref_heat, args.peak_thresh), *compare_detections(ulp, ref),
                    args.atol)
        score_worst = max(score_worst, float(np.abs(ours_peaks[:, 0] - ref_peaks[:, 0]).max()))
        ceiling_classes += saturated(ours_peaks)[:, 9].astype(int).tolist()
        d, count = compare_detections(ours, ref)
        if count is not None:
            # record both sides' scores nearest the threshold and their peaks at the ceiling, and go on
            near = {f"{side}_scores_nearest_threshold": [float(v) for v in
                                                        pk[np.argsort(np.abs(pk[:, 0] - args.peak_thresh))[:2], 0]]
                    for side, pk in (("ours", ours_peaks), ("ref", ref_peaks))}
            near.update({f"{side}_peaks_at_ceiling": len(saturated(pk)) for side, pk in (("ours", ours_peaks),
                                                                                         ("ref", ref_peaks))})
            mismatches.append({"frame": int(sample.sample_id), **count, **near})
            print(f"frame {sample.sample_id}: DETECTION COUNT differs {count['ours']} vs {count['ref']} {near}")
            continue
        worst = max(worst, d)
        n_det_total += len(ours)
        if len(ours):
            per_frame.append({"frame": int(sample.sample_id), "n": int(len(ours)), "max_abs_diff": round(d, 9)})
        if (idx + 1) % 16 == 0:
            print(f"{idx + 1}/{len(dataset)} frames, worst {worst:.2e}", flush=True)
    after = common.launches()

    raster_exact = raster_worst == 0.0
    raster_ok = raster_exact and density_worst <= DENSITY_TOL
    ok = not mismatches and worst <= args.atol and n_det_total > 0 and raster_ok
    report = {
        "cmd": " ".join(["python", "scripts/torch_trained_parity_check.py"]
                        + (sys.argv[1:] if argv is None else argv)),
        "checkpoint": args.pretrained_path,
        "use_ema": args.use_ema,
        "frames": len(dataset),
        "total_detections_compared": n_det_total,
        "atol": args.atol,
        "worst_abs_diff": worst,
        "count_mismatch": mismatches[0] if mismatches else None,
        "count_mismatches": mismatches,
        "worst_topk_score_diff": score_worst,
        # decoded peaks (of K a frame, on the device) at the clamped sigmoid's ceiling, by class
        "peaks_at_ceiling": {"total": len(ceiling_classes),
                             "by_class": {str(c): ceiling_classes.count(c) for c in sorted(set(ceiling_classes))}},
        "pass": bool(ok),
        "heatmap_card_vs_cpu": card_vs_cpu.report(args.peak_thresh),
        "cpu_vs_cpu_one_ulp": one_ulp.report(args.peak_thresh),
        "raster_card_vs_cpu": {"height_intensity_bit_exact": raster_exact, "height_intensity_worst": raster_worst,
                               "density_worst": density_worst, "density_tol": DENSITY_TOL, "pass": raster_ok},
        "note": (
            "the port on the device against the port on the CPU in strict float32: one BEV a held-out "
            "frame from the port's raster on the device (held against the CPU raster), KFPN -> "
            "decode -> detections_to_real on it on both sides, at the TRAINED operating point. Fields "
            f"compared: {FIELDS} per detection after lexicographic sort."
        ),
        "worst_frames": sorted(per_frame, key=lambda r: -r["max_abs_diff"])[:5],
        "device": common.device_record(device),
        "launches": {k: after[k] - launches0[k] for k in after},
    }
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    print(f"wrote {args.out}: {n_det_total} detections over {len(dataset) - len(mismatches)} frames "
          f"({len(mismatches)} with a count mismatch), worst |diff| {worst:.2e}, top-K scores {score_worst:.2e}, "
          f"raster height / intensity {'bit-exact' if raster_exact else f'differ by {raster_worst}'}, density "
          f"within {density_worst:.2e} -> {'PASS' if ok else 'FAIL'}")
    for name, w in (("card vs CPU", card_vs_cpu), ("CPU vs CPU one ulp", one_ulp)):
        print(f"{name}: heatmap gap {w.gap:.2e}, {w.n_flips} peak flips over {len(w.flip_frames)} frames "
              f"(margins within {w.flip_margin:.2e}), {len(w.mismatches)} frames with a count mismatch")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
