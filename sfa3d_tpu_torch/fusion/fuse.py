"""Camera-LiDAR detection fusion: the three reference strategies as
fixed-K masked tensor programs, the port of `sfa3d_tpu/fusion/fuse.py`.

Detection sets are (B, K, 4) xywh boxes + (B, K) scores + (B, K) int32
class ids + (B, K) valid masks; a single frame (K, ...) works too. Fused
outputs keep Ky + Ks slots (a matched pair collapses into the YOLO slot,
unmatched ones pass through) plus a `source` code: 0 = YOLO pass-through,
1 = SFA3D pass-through, 2 = fused.

- greedy_match           YOLO rows scanned in input order; each claims the
                         unmatched SFA box of largest IoU if that IoU is >= the
                         threshold and > 0 (a CUDA loop kernel, ops/fusion_loops.py)
- fuse_weighted          confidence-weighted box average, fused conf = max
- fuse_bayesian          per-coordinate inverse-variance fusion, conf = max
- fuse_union_nms         union of both sets + hard NMS
- rescore_3d_from_camera 3D confidences rescored by their camera matches

Fused box coordinates are int-truncated like the reference (`int(x)`).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from sfa3d_tpu_torch.fusion.nms import hard_nms
from sfa3d_tpu_torch.ops import fusion_loops


class DetectionSet(NamedTuple):
    boxes: torch.Tensor  # (B, K, 4) xywh
    scores: torch.Tensor  # (B, K)
    classes: torch.Tensor  # (B, K) int32
    valid: torch.Tensor  # (B, K) bool


def _frames(fn):
    """Let `fn`, written for (B, K, ...) sets, take single-frame (K, ...)
    sets too: the first two arguments are DetectionSets, and every tensor
    that comes back loses the added batch axis."""
    @functools.wraps(fn)
    def wrapper(a: DetectionSet, b: DetectionSet, *args, **kwargs):
        if a.boxes.dim() == 3:
            return fn(a, b, *args, **kwargs)
        out = fn(DetectionSet(*(t[None] for t in a)), DetectionSet(*(t[None] for t in b)),
                 *[t[None] if isinstance(t, torch.Tensor) else t for t in args], **kwargs)
        return _squeeze(out)

    return wrapper


def _squeeze(out):
    if isinstance(out, torch.Tensor):
        return out[0]
    if isinstance(out, DetectionSet):
        return DetectionSet(*(t[0] for t in out))
    return tuple(_squeeze(o) for o in out)


def confidence_to_variance(confidence, max_variance_pixels: float = 100.0,
                           min_confidence_threshold: float = 0.1) -> torch.Tensor:
    """max_variance * 100 below the confidence floor, else
    max_variance * (1 - c) / (c + 0.01)."""
    confidence = torch.as_tensor(confidence, dtype=torch.float32)
    return torch.where(
        confidence < min_confidence_threshold,
        max_variance_pixels * 100.0,
        max_variance_pixels * (1.0 - confidence) / (confidence + 0.01),
    )


def fuse_gaussian_parameters(mean1, var1, mean2, var2):
    """Inverse-variance fusion of two values -> (fused mean, fused var)."""
    eps = 1e-6
    iv1 = 1.0 / torch.clamp_min(var1, eps)
    iv2 = 1.0 / torch.clamp_min(var2, eps)
    fused_mean = (mean1 * iv1 + mean2 * iv2) / (iv1 + iv2)
    return fused_mean, 1.0 / (iv1 + iv2)


@_frames
def greedy_match(yolo: DetectionSet, sfa: DetectionSet, fusion_iou_threshold: float):
    """Sequential best-IoU matching -> (match_idx (B, Ky) int32: index into
    sfa or -1, sfa_matched (B, Ks) bool)."""
    return fusion_loops.greedy_match(
        yolo.boxes.contiguous(), yolo.valid.contiguous(),
        sfa.boxes.contiguous(), sfa.valid.contiguous(), fusion_iou_threshold,
    )


def _matched_sfa(sfa: DetectionSet, match_idx: torch.Tensor):
    j = torch.clamp_min(match_idx, 0).long()
    sboxes = torch.gather(sfa.boxes, 1, j[..., None].expand(-1, -1, 4))
    sconf = torch.gather(sfa.scores, 1, j)
    return sboxes, sconf


def _assemble(yolo: DetectionSet, sfa: DetectionSet, fused_boxes, fused_conf,
              match_idx, sfa_matched):
    """Stack fused / pass-through YOLO slots with the unmatched SFA slots."""
    matched = match_idx >= 0
    out_boxes = torch.cat([torch.where(matched[..., None], fused_boxes, yolo.boxes), sfa.boxes], 1)
    out_scores = torch.cat([torch.where(matched, fused_conf, yolo.scores), sfa.scores], 1)
    out_classes = torch.cat([yolo.classes, sfa.classes], 1)
    out_valid = torch.cat([yolo.valid, sfa.valid & ~sfa_matched], 1)
    source = torch.cat(
        [torch.where(matched, 2, 0).to(torch.int32), torch.ones_like(sfa.classes, dtype=torch.int32)], 1
    )
    return DetectionSet(out_boxes, out_scores, out_classes, out_valid), source


@_frames
def fuse_weighted(yolo: DetectionSet, sfa: DetectionSet, fusion_iou_threshold: float = 0.8):
    """Confidence-weighted box averaging -> (fused set, source)."""
    match_idx, sfa_matched = greedy_match(yolo, sfa, fusion_iou_threshold)
    sboxes, sconf = _matched_sfa(sfa, match_idx)
    total = yolo.scores + sconf
    wy = torch.where(total == 0, 0.5, yolo.scores / torch.clamp_min(total, 1e-12))
    ws = torch.where(total == 0, 0.5, sconf / torch.clamp_min(total, 1e-12))
    fused_boxes = torch.trunc(wy[..., None] * yolo.boxes + ws[..., None] * sboxes)
    fused_conf = torch.maximum(yolo.scores, sconf)
    return _assemble(yolo, sfa, fused_boxes, fused_conf, match_idx, sfa_matched)


@_frames
def fuse_bayesian(yolo: DetectionSet, sfa: DetectionSet, fusion_iou_threshold: float = 0.7):
    """Inverse-variance ("Bayesian-inspired") fusion -> (fused set, source)."""
    match_idx, sfa_matched = greedy_match(yolo, sfa, fusion_iou_threshold)
    sboxes, sconf = _matched_sfa(sfa, match_idx)
    var_pos_y = confidence_to_variance(yolo.scores, 100.0)
    var_dim_y = confidence_to_variance(yolo.scores, 50.0)
    var_pos_s = confidence_to_variance(sconf, 100.0)
    var_dim_s = confidence_to_variance(sconf, 50.0)
    fused = [
        fuse_gaussian_parameters(yolo.boxes[..., c], vy, sboxes[..., c], vs)[0]
        for c, vy, vs in ((0, var_pos_y, var_pos_s), (1, var_pos_y, var_pos_s),
                          (2, var_dim_y, var_dim_s), (3, var_dim_y, var_dim_s))
    ]
    fused_boxes = torch.trunc(torch.stack(fused, dim=-1))
    fused_conf = torch.maximum(yolo.scores, sconf)
    return _assemble(yolo, sfa, fused_boxes, fused_conf, match_idx, sfa_matched)


@_frames
def fuse_union_nms(yolo: DetectionSet, sfa: DetectionSet, nms_threshold: float = 0.5):
    """Union of both detection sets + greedy hard NMS -> (set, source)."""
    boxes = torch.cat([yolo.boxes, sfa.boxes], 1)
    scores = torch.cat([yolo.scores, sfa.scores], 1)
    classes = torch.cat([yolo.classes, sfa.classes], 1)
    valid = torch.cat([yolo.valid, sfa.valid], 1)
    keep = hard_nms(boxes, scores, valid, nms_threshold)
    source = torch.cat(
        [torch.zeros_like(yolo.classes, dtype=torch.int32), torch.ones_like(sfa.classes, dtype=torch.int32)], 1
    )
    return DetectionSet(boxes, scores, classes, valid & keep), source


def filter_by_confidence(dets: DetectionSet, confidence_threshold: float) -> DetectionSet:
    """Pre-fusion confidence gate."""
    return dets._replace(valid=dets.valid & (dets.scores >= confidence_threshold))


@_frames
def rescore_3d_from_camera(camera: DetectionSet, sfa2d: DetectionSet, sfa_scores3d: torch.Tensor,
                           fusion_iou_threshold: float = 0.7, mode: str = "max",
                           demote: float = 0.9) -> torch.Tensor:
    """Late-fusion rescoring of the 3D detections by their camera matches
    (matching is `greedy_match`, the loop every fusion mode shares).

    mode="max": a camera-confirmed detection takes max(conf_3d, conf_2d).
    mode="demote": confirmed detections keep their own score; unconfirmed
    ones whose projection lies in the image (sfa2d.valid) are scaled by
    `demote`; out-of-frustum ones pass through.

    `camera` / `sfa2d` are image-plane sets, `sfa_scores3d` the (B, Ks) 3D
    confidences. Returns the rescored (B, Ks) confidences."""
    if mode not in ("max", "demote"):
        raise ValueError(f"unknown rescore mode: {mode!r}")
    match_idx, sfa_matched = greedy_match(camera, sfa2d, fusion_iou_threshold)
    if mode == "demote":
        keep = sfa_matched | ~sfa2d.valid
        return torch.where(keep, sfa_scores3d, sfa_scores3d * demote)
    j = torch.clamp_min(match_idx, 0).long()
    boost = torch.zeros_like(sfa_scores3d).scatter_reduce(
        1, j, torch.where(match_idx >= 0, camera.scores, 0.0), reduce="amax", include_self=True
    )
    return torch.where(sfa_matched, torch.maximum(sfa_scores3d, boost), sfa_scores3d)
