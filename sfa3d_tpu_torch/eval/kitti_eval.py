"""KITTI-style 3D average precision, the port's copy of
`sfa3d_tpu/eval/kitti_eval.py`: per-class AP with the KITTI protocol's
shape (greedy score-ordered matching at class IoU thresholds, 0.7 car and
0.5 pedestrian / cyclist, 40-point interpolated AP (R40), Easy / Moderate /
Hard buckets from per-object difficulty levels, the devkit's minimum
detection height per bucket, and AOS). The pairwise rotated BEV / 3D IoU
matrices run on the evaluator's device (`ops/rotated_iou.py`; cuda unless
device="cpu" is given); the matching and the curves are numpy.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

import torch

from sfa3d_tpu_torch.device import Device, resolve_device
from sfa3d_tpu_torch.ops.rotated_iou import pairwise_iou_3d, pairwise_iou_bev_rotated

CLASS_IOU_THRESH = {0: 0.5, 1: 0.7, 2: 0.5}  # Pedestrian, Car, Cyclist


def _ap_r40(recall: np.ndarray, precision: np.ndarray) -> float:
    """40-point interpolated AP (KITTI R40)."""
    ap = 0.0
    for r in np.linspace(0.025, 1.0, 40):
        p = precision[recall >= r]
        ap += (p.max() if len(p) else 0.0) / 40.0
    return float(ap)


def _frame_iou(det_boxes, gt_boxes, metric, device: torch.device):
    """Pairwise (nd, ng) IoU of one frame's detections and ground truth on
    `device`, once per (frame, class); every difficulty bucket reuses it."""
    nd, ng = len(det_boxes), len(gt_boxes)
    if nd == 0 or ng == 0:
        return np.zeros((nd, ng), np.float32)
    d = torch.as_tensor(np.asarray(det_boxes, np.float32), device=device)
    g = torch.as_tensor(np.asarray(gt_boxes, np.float32), device=device)
    if metric == "3d":
        return pairwise_iou_3d(d, g).cpu().numpy()
    bev = [0, 1, 4, 5, 6]
    return pairwise_iou_bev_rotated(d[:, bev], g[:, bev]).cpu().numpy()


def _match_bucket(iou, det_scores, countable, iou_thresh):
    """Greedy per-bucket matching (KITTI devkit protocol): descending by
    score, each detection first claims its best unused COUNTABLE GT above
    threshold; only if none qualifies may it claim an ignored
    (out-of-bucket) GT, which removes it from the PR curve (not TP, not
    FP). Matching globally without this preference deflates easier-bucket
    recall whenever a detection's single best overlap is a harder GT.

    Returns (match_idx (nd,), matched_to_ignored (nd,) bool)."""
    nd, ng = iou.shape
    match = np.full(nd, -1, np.int64)
    to_ignored = np.zeros(nd, bool)
    if ng == 0:
        return match, to_ignored
    gt_used = np.zeros(ng, bool)
    for i in np.argsort(-det_scores):
        cand = np.where(gt_used, -1.0, iou[i])
        cc = np.where(countable, cand, -1.0)
        j = int(np.argmax(cc))
        if cc[j] >= iou_thresh:
            match[i] = j
            gt_used[j] = True
            continue
        ci = np.where(countable, -1.0, cand)
        j = int(np.argmax(ci))
        if ci[j] >= iou_thresh:
            match[i] = j
            gt_used[j] = True
            to_ignored[i] = True
    return match, to_ignored


DIFFICULTY_NAMES = {1: "Easy", 2: "Moderate", 3: "Hard"}

# Official devkit detection-side ignore (evaluate_object.cpp MIN_HEIGHT
# {40, 25, 25} px): a detection whose 2D bbox height is below the bucket's
# minimum is removed from that bucket's PR curve entirely — a far/small
# detection can never correspond to an Easy GT, and without this filter the
# full FP population penalizes every bucket equally, inverting the natural
# Easy >= Moderate >= Hard ordering whenever score and difficulty
# decorrelate. Applied only when per-detection heights are supplied.
MIN_DET_HEIGHT = {1: 40.0, 2: 25.0, 3: 25.0}


def evaluate_kitti_ap(
    detections: Sequence[Dict],
    ground_truths: Sequence[Dict],
    num_classes: int = 3,
    metric: str = "3d",
    iou_thresholds: Optional[Dict[int, float]] = None,
    difficulty: Optional[int] = None,
    with_aos: bool = False,
    device: Device = None,
) -> Dict[str, float]:
    """Compute per-class AP over a set of frames.

    Args:
      detections: per frame {'boxes': (N, 7) [x,y,z,h,w,l,yaw] velodyne,
        'scores': (N,), 'classes': (N,)} numpy arrays (masked rows removed).
      ground_truths: per frame {'boxes': (M, 7), 'classes': (M,),
        optional 'difficulty': (M,) int levels 1=Easy 2=Moderate 3=Hard
        4=unknown (Object3d.get_obj_level)}.
      metric: '3d' (volume IoU) or 'bev' (rotated BEV IoU).
      difficulty: KITTI bucket (1/2/3). When set, GT with level <= difficulty
        count toward recall; HARDER GT are "ignored" per the KITTI protocol —
        detections matched to them are neither TP nor FP (frames without a
        'difficulty' array treat every GT as countable). When a detection
        dict also carries 'heights' ((N,) projected 2D bbox heights, px),
        detections below MIN_DET_HEIGHT[difficulty] are ignored for that
        bucket (devkit MIN_HEIGHT rule).
      with_aos: also compute KITTI Average Orientation Similarity — the AP
        integral with per-detection precision replaced by cumulative
        (1+cos(yaw error))/2 over matched pairs (FPs contribute 0), so
        AOS <= AP with equality iff every matched yaw is exact (the
        official devkit's orientation metric).

      device: where the IoU matrices are computed (default cuda; raises
        without a GPU unless device="cpu").

    Returns {'AP_<cls>': ap, ..., 'mAP': mean} (+ 'AOS_<cls>'/'mAOS').
    """
    matches = _collect_matches(
        detections, ground_truths, num_classes, metric,
        iou_thresholds or CLASS_IOU_THRESH, resolve_device(device),
    )
    return _score_bucket(matches, num_classes, difficulty, with_aos=with_aos)


def _collect_matches(detections, ground_truths, num_classes, metric,
                     iou_thresholds, device):
    """Compute the (device) pairwise IoUs ONCE per (frame, class); the
    difficulty buckets each run their own cheap greedy matching over the
    cached matrix (countable-GT preference differs per bucket)."""
    assert len(detections) == len(ground_truths)
    per_class: Dict[int, List] = {cls: [] for cls in range(num_classes)}
    for det, gt in zip(detections, ground_truths):
        det_classes = np.asarray(det["classes"])
        gt_classes = np.asarray(gt["classes"])
        levels_all = np.asarray(gt["difficulty"]) if "difficulty" in gt else None
        heights_all = (np.asarray(det["heights"], np.float32)
                       if "heights" in det else None)
        for cls in range(num_classes):
            dm = det_classes == cls
            gm = gt_classes == cls
            det_scores = np.asarray(det["scores"], np.float32)[dm]
            det_boxes = np.asarray(det["boxes"], np.float32)[dm]
            gt_boxes = np.asarray(gt["boxes"], np.float32)[gm]
            iou = _frame_iou(det_boxes, gt_boxes, metric, device)
            levels = levels_all[gm] if levels_all is not None else None
            heights = heights_all[dm] if heights_all is not None else None
            # yaw column (index 6 of [x,y,z,h,w,l,yaw]) feeds the AOS
            # orientation-similarity curve for matched pairs
            per_class[cls].append(
                (det_scores, iou, iou_thresholds[cls], len(gt_boxes), levels,
                 det_boxes[:, 6] if det_boxes.size else np.zeros(0, np.float32),
                 gt_boxes[:, 6] if gt_boxes.size else np.zeros(0, np.float32),
                 heights)
            )
    return per_class


def _score_bucket(per_class, num_classes, difficulty, with_aos=False):
    results = {}
    aps = []
    aoss = []
    for cls in range(num_classes):
        scores_all: List[np.ndarray] = []
        tp_all: List[np.ndarray] = []
        sim_all: List[np.ndarray] = []
        n_gt = 0
        for det_scores, iou, thresh, ng, levels, dyaw, gyaw, heights in per_class[cls]:
            if difficulty is not None and levels is not None:
                countable = levels <= difficulty
            else:
                countable = np.ones(ng, bool)
            n_gt += int(countable.sum())
            if difficulty is not None and heights is not None:
                # devkit MIN_HEIGHT detection ignore: too-small detections
                # leave this bucket's PR curve before matching
                keep = heights >= MIN_DET_HEIGHT[difficulty]
                det_scores = det_scores[keep]
                iou = iou[keep]
                dyaw = dyaw[keep]
            match, ignored = _match_bucket(iou, det_scores, countable, thresh)
            # detections matched to an out-of-bucket GT are dropped from
            # the PR curve entirely (KITTI "ignored": not FP, not TP)
            scores_all.append(det_scores[~ignored])
            tp_all.append((match >= 0)[~ignored])
            if with_aos:
                # KITTI orientation similarity: (1 + cos(dyaw)) / 2 for
                # matched pairs, 0 for false positives (devkit AOS)
                matched_gt_yaw = gyaw[np.maximum(match, 0)] if ng else np.zeros_like(dyaw)
                sim = np.where(
                    match >= 0,
                    (1.0 + np.cos(dyaw - matched_gt_yaw)) / 2.0,
                    0.0,
                )
                sim_all.append(sim[~ignored])
        scores = np.concatenate(scores_all) if scores_all else np.zeros(0)
        tps = np.concatenate(tp_all) if tp_all else np.zeros(0, bool)
        if n_gt == 0:
            continue
        order = np.argsort(-scores)
        tps = tps[order]
        cum_tp = np.cumsum(tps)
        cum_fp = np.cumsum(~tps)
        recall = cum_tp / n_gt
        precision = cum_tp / np.maximum(cum_tp + cum_fp, 1)
        ap = _ap_r40(recall, precision) if len(recall) else 0.0
        results[f"AP_{cls}"] = ap
        aps.append(ap)
        if with_aos:
            sims = (np.concatenate(sim_all) if sim_all else np.zeros(0))[order]
            # orientation-similarity "precision": cumulative similarity over
            # ALL predictions so far (FPs contribute 0), on the same recall
            # grid — so AOS <= AP with equality iff every TP's yaw is exact
            sim_prec = np.cumsum(sims) / np.maximum(cum_tp + cum_fp, 1)
            aos = _ap_r40(recall, sim_prec) if len(recall) else 0.0
            results[f"AOS_{cls}"] = aos
            aoss.append(aos)
    results["mAP"] = float(np.mean(aps)) if aps else 0.0
    if with_aos:
        results["mAOS"] = float(np.mean(aoss)) if aoss else 0.0
    return results


def evaluate_kitti_ap_by_difficulty(
    detections: Sequence[Dict],
    ground_truths: Sequence[Dict],
    num_classes: int = 3,
    metric: str = "3d",
    iou_thresholds: Optional[Dict[int, float]] = None,
    with_aos: bool = False,
    device: Device = None,
) -> Dict[str, Dict[str, float]]:
    """The Easy / Moderate / Hard AP table. Pairwise IoUs are computed once
    (on `device`); each bucket runs its own greedy matching with
    countable-GT preference over the cached matrices."""
    matches = _collect_matches(
        detections, ground_truths, num_classes, metric,
        iou_thresholds or CLASS_IOU_THRESH, resolve_device(device),
    )
    return {
        name: _score_bucket(matches, num_classes, level, with_aos=with_aos)
        for level, name in DIFFICULTY_NAMES.items()
    }
