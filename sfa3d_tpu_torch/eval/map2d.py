"""Axis-aligned 2D detection mAP (VOC/COCO-style greedy matching), the
port's copy of `sfa3d_tpu/eval/map2d.py` (numpy only). It scores the YOLOv8
camera detector that `cli/yolo_train.py` trains.

Protocol: per class, detections sorted by score greedily match the unmatched
GT with highest IoU >= threshold in the same image; AP is the 101-point
interpolated area under the PR curve (COCO convention). mAP50 averages
classes at IoU 0.5; mAP50_95 averages over IoU 0.50:0.05:0.95.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def iou_matrix_xyxy(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, 4) x (M, 4) xyxy -> (N, M) IoU."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    tl = np.maximum(a[:, None, :2], b[None, :, :2])
    br = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.clip(br - tl, 0, None).prod(-1)
    area_a = np.clip(a[:, 2:] - a[:, :2], 0, None).prod(-1)
    area_b = np.clip(b[:, 2:] - b[:, :2], 0, None).prod(-1)
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter, 1e-9)


def _ap_101(recall: np.ndarray, precision: np.ndarray) -> float:
    """COCO 101-point interpolated AP."""
    if len(recall) == 0:
        return 0.0
    # precision envelope (monotone non-increasing from the right)
    mpre = np.maximum.accumulate(precision[::-1])[::-1]
    grid = np.linspace(0, 1, 101)
    idx = np.searchsorted(recall, grid, side="left")
    vals = np.where(idx < len(mpre), mpre[np.minimum(idx, len(mpre) - 1)], 0.0)
    return float(vals.mean())


def _class_ap(dets, gts, cls: int, iou_thr: float) -> float:
    """dets/gts: per-image lists of dicts {boxes (K,4), classes (K,),
    scores (K,) for dets}. -> AP for one class at one IoU threshold.
    Returns NaN when the class has no GT anywhere (excluded from the mean,
    COCO convention)."""
    records: List = []  # (score, is_tp)
    n_gt = 0
    for det, gt in zip(dets, gts):
        g_sel = gt["classes"] == cls
        g_boxes = np.asarray(gt["boxes"], np.float32)[g_sel]
        n_gt += len(g_boxes)
        d_sel = np.asarray(det["classes"]) == cls
        d_boxes = np.asarray(det["boxes"], np.float32)[d_sel]
        d_scores = np.asarray(det["scores"], np.float32)[d_sel]
        order = np.argsort(-d_scores)
        matched = np.zeros(len(g_boxes), bool)
        ious = iou_matrix_xyxy(d_boxes, g_boxes)
        for di in order:
            best, best_iou = -1, iou_thr
            for gi in range(len(g_boxes)):
                if not matched[gi] and ious[di, gi] >= best_iou:
                    best, best_iou = gi, ious[di, gi]
            if best >= 0:
                matched[best] = True
                records.append((d_scores[di], 1))
            else:
                records.append((d_scores[di], 0))
    if n_gt == 0:
        return float("nan")
    if not records:
        return 0.0
    records.sort(key=lambda r: -r[0])
    tps = np.asarray([r[1] for r in records], np.float32)
    tp_cum = np.cumsum(tps)
    fp_cum = np.cumsum(1.0 - tps)
    recall = tp_cum / n_gt
    precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-9)
    return _ap_101(recall, precision)


def evaluate_map2d(
    dets: Sequence[dict],
    gts: Sequence[dict],
    num_classes: int = 3,
    iou_thresholds: Sequence[float] = tuple(np.arange(0.5, 1.0, 0.05)),
) -> Dict[str, float]:
    """Per-image detection dicts -> {mAP50, mAP50_95, AP50_<c> per class}.

    dets[i]: {boxes (K, 4) xyxy, scores (K,), classes (K,)} — pre-filtered
    to valid rows. gts[i]: {boxes (M, 4) xyxy, classes (M,)}.
    Classes with zero GT across the split are excluded from the means."""
    per_thr = []
    ap50 = {}
    for t in iou_thresholds:
        aps = [_class_ap(dets, gts, c, float(t)) for c in range(num_classes)]
        if abs(t - 0.5) < 1e-6:
            ap50 = {f"AP50_{c}": aps[c] for c in range(num_classes)}
        per_thr.append(np.nanmean(aps) if not all(np.isnan(aps)) else 0.0)
    out = {
        "mAP50": float(per_thr[0]),
        "mAP50_95": float(np.mean(per_thr)),
    }
    out.update({k: (float(v) if not np.isnan(v) else float("nan"))
                for k, v in ap50.items()})
    return out
