"""NMS over fixed-K masked detection sets, the port of
`sfa3d_tpu/fusion/nms.py`.

- `hard_nms`: greedy confidence-ordered suppression: a detection is dropped
  when its IoU with an already-KEPT higher-confidence detection exceeds the
  threshold (strictly '>'). Ties in confidence keep input order (a stable
  sort), and invalid slots go last.
- `soft_nms_gaussian`: Gaussian score decay (score *= exp(-iou^2 / sigma)).

Both take a batch (B, K, ...) or a single frame (K, ...). The sequential
loops are the CUDA kernels of `ops/fusion_loops.py` (one launch per batch);
the stable order and the scatter back to input order are PyTorch around
them, as JAX runs them outside its loop.
"""

from __future__ import annotations

import torch

from sfa3d_tpu_torch.ops import fusion_loops


def _stable_desc_order(scores: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(..., K) indices sorting valid detections by confidence, descending
    and stable; invalid slots go last."""
    key = torch.where(valid, -scores, torch.inf)
    return torch.sort(key, dim=-1, stable=True).indices


def hard_nms(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
             nms_threshold: float = 0.5) -> torch.Tensor:
    """(..., K, 4) xywh + (..., K) scores/valid -> keep mask (..., K) in
    INPUT order. One leading batch axis or none."""
    single = boxes.dim() == 2
    if single:
        boxes, scores, valid = boxes[None], scores[None], valid[None]
    order = _stable_desc_order(scores, valid)
    b = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4)).contiguous()
    v = torch.gather(valid, 1, order).contiguous()
    keep_sorted = fusion_loops.hard_nms_keep(b, v, nms_threshold)
    keep = torch.zeros_like(valid).scatter(1, order, keep_sorted)
    return keep[0] if single else keep


def soft_nms_gaussian(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
                      sigma: float = 0.5, score_thresh: float = 0.001):
    """Gaussian soft-NMS in slot order: returns decayed scores (..., K)
    (0 for invalid slots) and the surviving mask (decayed score >
    score_thresh). The decay is exp(-(iou * iou) * float32(1 / sigma)), the
    form XLA compiles for the constant sigma of the fused program (exact for
    sigma = 0.5)."""
    single = boxes.dim() == 2
    if single:
        boxes, scores, valid = boxes[None], scores[None], valid[None]
    out, surv = fusion_loops.soft_nms_gaussian(
        boxes.contiguous(), scores.contiguous(), valid.contiguous(), sigma, score_thresh
    )
    return (out[0], surv[0]) if single else (out, surv)
