"""YOLOv8 training loss, the port of `sfa3d_tpu/losses/yolo_loss.py`:
task-aligned assignment, CIoU box loss, distribution focal loss over the 16
DFL bins and BCE classification against the normalised align metric, with
the v8 gains (box 7.5, cls 0.5, dfl 1.5).

Ground truth is padded to G slots with a validity mask and every assigner
tensor is dense (B, G, A), as in the JAX package. The assignment is a
target: it runs under `torch.no_grad()` (JAX's `stop_gradient`). Ties keep
XLA's order: the top-k is a stable descending sort (lower anchor index
first) and each argmax takes the first maximum. The loss computes in
float32, as the JAX loss casts the head outputs to float32; float64 head
outputs stay float64. Under a data-parallel group
(`collectives.py::data_parallel`) the normalizer max(sum of the target
scores, 1) takes the global sum (one all-reduce), so each rank's loss is
its local share of the global loss.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch

from sfa3d_tpu_torch.models.yolov8 import REG_MAX, STRIDES, dfl_expectation
from sfa3d_tpu_torch.collectives import all_reduce_sum

BOX_GAIN = 7.5
CLS_GAIN = 0.5
DFL_GAIN = 1.5


def make_anchors(imgsz, strides: Sequence[int] = STRIDES, device=None,
                 dtype: torch.dtype = torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (anchor centres (A, 2) [x, y] in each level's grid units, the
    stride of each anchor (A,)), float32 unless `dtype` says. Levels in `strides` order, each
    row-major over (h, w) as `decode_predictions` flattens them. `imgsz` is
    an int (square) or (h, w)."""
    h, w = (imgsz, imgsz) if isinstance(imgsz, int) else imgsz
    points, strs = [], []
    for s in strides:
        nh, nw = h // s, w // s
        ys = torch.arange(nh, dtype=dtype, device=device) + 0.5
        xs = torch.arange(nw, dtype=dtype, device=device) + 0.5
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        points.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1))
        strs.append(torch.full((nh * nw,), float(s), dtype=dtype, device=device))
    return torch.cat(points, 0), torch.cat(strs, 0)


def iou_xyxy(box1: torch.Tensor, box2: torch.Tensor, kind: str = "ciou", eps: float = 1e-7) -> torch.Tensor:
    """Elementwise IoU of broadcastable xyxy boxes -> (...,). kind "iou" is
    the plain IoU, "ciou" the complete IoU (centre distance and aspect
    ratio penalties; the trade-off alpha is detached, as ultralytics does)."""
    b1x1, b1y1, b1x2, b1y2 = box1.unbind(-1)
    b2x1, b2y1, b2x2, b2y2 = box2.unbind(-1)
    w1, h1 = b1x2 - b1x1, b1y2 - b1y1
    w2, h2 = b2x2 - b2x1, b2y2 - b2y1
    inter = (torch.clamp_min(torch.minimum(b1x2, b2x2) - torch.maximum(b1x1, b2x1), 0)
             * torch.clamp_min(torch.minimum(b1y2, b2y2) - torch.maximum(b1y1, b2y1), 0))
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union
    if kind == "iou":
        return iou
    cw = torch.maximum(b1x2, b2x2) - torch.minimum(b1x1, b2x1)
    ch = torch.maximum(b1y2, b2y2) - torch.minimum(b1y1, b2y1)
    c2 = cw * cw + ch * ch + eps
    rho2 = ((b2x1 + b2x2 - b1x1 - b1x2) ** 2 + (b2y1 + b2y2 - b1y1 - b1y2) ** 2) / 4.0
    v = (4.0 / math.pi ** 2) * (torch.atan(w2 / (h2 + eps)) - torch.atan(w1 / (h1 + eps))) ** 2
    alpha = (v / (v - iou + (1.0 + eps))).detach()
    return iou - (rho2 / c2 + v * alpha)


def _topk_mask(metric: torch.Tensor, k: int) -> torch.Tensor:
    """(B, G, A) metric -> bool mask of each (b, g)'s top-k anchors, ties to
    the lower index (XLA's TopK), and only where the metric is > 0."""
    idx = torch.sort(metric, dim=-1, descending=True, stable=True).indices[..., :k]
    mask = torch.zeros(metric.shape, dtype=torch.bool, device=metric.device)
    mask.scatter_(-1, idx, True)
    return mask & (metric > 0)


@torch.no_grad()
def task_aligned_assign(
    pd_scores: torch.Tensor,   # (B, A, C) sigmoid class probabilities
    pd_bboxes: torch.Tensor,   # (B, A, 4) xyxy, the units of gt_bboxes
    anc_points: torch.Tensor,  # (A, 2) anchor centres, same units
    gt_labels: torch.Tensor,   # (B, G) int class ids
    gt_bboxes: torch.Tensor,   # (B, G, 4) xyxy
    gt_mask: torch.Tensor,     # (B, G) bool, padded slots False
    topk: int = 10,
    alpha: float = 0.5,
    beta: float = 6.0,
    eps: float = 1e-9,
) -> Dict[str, torch.Tensor]:
    """The TOOD / ultralytics task-aligned assigner, dense and fixed-shape.

    Returns fg_mask (B, A), target_gt_idx (B, A), target_bboxes (B, A, 4)
    and target_scores (B, A, C) (one-hot times the normalised metric)."""
    _, A, C = pd_scores.shape
    lt = anc_points[None, None] - gt_bboxes[:, :, None, :2]  # (B, G, A, 2)
    rb = gt_bboxes[:, :, None, 2:] - anc_points[None, None]
    in_gts = torch.cat([lt, rb], dim=-1).amin(-1) > eps  # (B, G, A)

    overlaps = torch.clamp_min(iou_xyxy(gt_bboxes[:, :, None, :], pd_bboxes[:, None, :, :]), 0.0)
    labels = gt_labels.long().clamp(0, C - 1)
    cls_score = torch.gather(pd_scores.transpose(1, 2), 1, labels[:, :, None].expand(-1, -1, A))
    align = cls_score ** alpha * overlaps ** beta

    gate = in_gts & gt_mask[:, :, None]
    mask_pos = _topk_mask(torch.where(gate, align, 0.0), topk) & gate

    # an anchor claimed by several ground-truth boxes keeps the best-overlap one
    n_claims = mask_pos.sum(1)  # (B, A)
    best_gt = torch.argmax(torch.where(mask_pos, overlaps, -1.0), 1)  # the first maximum, as XLA's
    single_gt = torch.argmax(mask_pos.to(torch.int32), 1)
    target_gt_idx = torch.where(n_claims > 1, best_gt, single_gt)
    fg_mask = n_claims > 0

    target_bboxes = torch.gather(gt_bboxes, 1, target_gt_idx[..., None].expand(-1, -1, 4))
    target_labels = torch.gather(gt_labels.long(), 1, target_gt_idx)
    one_hot = (target_labels[..., None] == torch.arange(C, device=pd_scores.device)).to(pd_scores.dtype)
    one_hot = one_hot * fg_mask[..., None]

    # each box's positives rescaled so that its best-aligned anchor carries
    # the box's best overlap (ultralytics' norm_align_metric)
    align_pos = torch.where(mask_pos, align, 0.0)
    pos_align = align_pos.amax(-1, keepdim=True)  # (B, G, 1)
    pos_overlap = torch.where(mask_pos, overlaps, 0.0).amax(-1, keepdim=True)
    norm = (align_pos * pos_overlap / (pos_align + eps)).amax(1)  # (B, A)
    return {
        "fg_mask": fg_mask,
        "target_gt_idx": target_gt_idx,
        "target_bboxes": target_bboxes,
        "target_scores": one_hot * norm[..., None],
    }


def _dfl_loss(pred_dist: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Distribution focal loss: pred_dist (..., 4, 16) logits, target
    (..., 4) distances in [0, 15) -> (...,) the mean over the 4 sides of
    the two-hot cross-entropy."""
    tl = torch.floor(target).long().clamp(0, REG_MAX - 2)
    tr = tl + 1
    wl = tr.to(target.dtype) - target
    wr = 1.0 - wl
    logp = torch.log_softmax(pred_dist, dim=-1)
    ce_l = -torch.gather(logp, -1, tl[..., None])[..., 0]
    ce_r = -torch.gather(logp, -1, tr[..., None])[..., 0]
    return (ce_l * wl + ce_r * wr).mean(-1)


def sigmoid_bce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise BCE with logits in the stable log1p form
    max(x, 0) - x * t + log1p(exp(-|x|))."""
    return torch.clamp_min(logits, 0) - logits * targets + torch.log1p(torch.exp(-torch.abs(logits)))


def yolo_loss(
    level_outputs,             # per level (box_logits (B, h, w, 64), cls_logits (B, h, w, C)), NHWC
    gt_bboxes: torch.Tensor,   # (B, G, 4) xyxy in input pixels
    gt_labels: torch.Tensor,   # (B, G) int
    gt_mask: torch.Tensor,     # (B, G) bool
    imgsz=640,                 # int or (h, w)
    topk: int = 10,
) -> Dict[str, torch.Tensor]:
    """The v8 detection loss over the head's per-level outputs. Boxes decode
    in each level's grid units (DFL distances are bin counts), the
    assignment runs in pixels, the box and DFL losses in grid units.
    Returns 0-dim tensors {"total" (gain-weighted), "box", "cls", "dfl",
    "num_fg"}."""
    B = level_outputs[0][0].shape[0]
    C = level_outputs[0][1].shape[-1]
    dtype = torch.promote_types(level_outputs[0][0].dtype, torch.float32)
    dev = level_outputs[0][0].device
    anc_points, anc_strides = make_anchors(imgsz, device=dev, dtype=dtype)

    box_logits = torch.cat([b.reshape(B, -1, 4 * REG_MAX) for b, _ in level_outputs], 1).to(dtype)
    cls_logits = torch.cat([c.reshape(B, -1, C) for _, c in level_outputs], 1).to(dtype)

    ltrb = dfl_expectation(box_logits)  # (B, A, 4) grid units
    pd_grid = torch.cat([anc_points[None] - ltrb[..., :2], anc_points[None] + ltrb[..., 2:]], -1)

    assign = task_aligned_assign(
        torch.sigmoid(cls_logits.detach()),
        pd_grid.detach() * anc_strides[None, :, None],
        anc_points * anc_strides[:, None],
        gt_labels, gt_bboxes, gt_mask, topk=topk,
    )
    fg = assign["fg_mask"]
    target_scores = assign["target_scores"]
    tss = torch.clamp_min(all_reduce_sum(target_scores.sum()), 1.0)  # global under a group

    loss_cls = sigmoid_bce(cls_logits, target_scores).sum() / tss

    tgt_grid = assign["target_bboxes"] / anc_strides[None, :, None]
    weight = target_scores.sum(-1)  # (B, A)
    iou = iou_xyxy(pd_grid, tgt_grid, kind="ciou")
    loss_box = torch.where(fg, (1.0 - iou) * weight, 0.0).sum() / tss

    tgt_ltrb = torch.cat([anc_points[None] - tgt_grid[..., :2], tgt_grid[..., 2:] - anc_points[None]], -1)
    tgt_ltrb = torch.clamp(tgt_ltrb, 0.0, REG_MAX - 1 - 0.01)
    dfl = _dfl_loss(box_logits.reshape(B, -1, 4, REG_MAX), tgt_ltrb)
    loss_dfl = torch.where(fg, dfl * weight, 0.0).sum() / tss

    total = BOX_GAIN * loss_box + CLS_GAIN * loss_cls + DFL_GAIN * loss_dfl
    return {"total": total, "box": loss_box, "cls": loss_cls, "dfl": loss_dfl,
            "num_fg": fg.sum().to(torch.float32)}
