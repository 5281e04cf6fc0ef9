"""Detection decode: heatmap peaks -> fixed-K 7-DOF boxes, in PyTorch.

The port of `sfa3d_tpu/ops/decode.py`, with the same NHWC head layout and
the same fixed-(B, K) masked outputs:
- `heat_nms`: 3x3 max-pool peak suppression.
- `topk_detections`: per-class top-K, then global top-K over C*K.
- `decode`: gather the heads at the peaks -> (B, K, 10) rows
  [score, x, y, z, h, w, l, sin, cos, cls] in heatmap pixels.
- `post_processing`, `detections_to_real`: BEV-pixel and metric boxes.

`torch.topk` and `lax.top_k` may order exactly tied scores differently, so
compare detection sets sorted by (cls, x, y), not row by row.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sfa3d_tpu_torch.config import kitti as cnf


def _recip(c: float) -> float:
    """XLA compiles `x / c` as `x * float32(1/c)`; so does the port."""
    return float(np.float32(1.0 / c))


def _nchw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 3, 1, 2)


def heat_nms(heat: torch.Tensor, kernel: int = 3) -> torch.Tensor:
    """Keep only local maxima: heat * (maxpool3x3(heat) == heat).
    `heat`: (B, H, W, C)."""
    pad = (kernel - 1) // 2
    h = _nchw(heat)
    hmax = F.max_pool2d(h, kernel, stride=1, padding=pad)
    return (h * (hmax == h).to(h.dtype)).permute(0, 2, 3, 1)


def topk_detections(scores: torch.Tensor, K: int = 50):
    """Per-class top-K then global top-K over C*K. `scores`: (B, H, W, C).
    Returns (score, inds, clses, ys, xs), each (B, K); `inds` are flat
    y*W+x positions in the H*W plane."""
    b, h, w, c = scores.shape
    per_class = _nchw(scores).reshape(b, c, h * w)
    topk_scores, topk_inds = torch.topk(per_class, K, dim=-1)  # (B, C, K)
    topk_ys = torch.div(topk_inds, w, rounding_mode="floor").to(torch.float32)
    topk_xs = (topk_inds % w).to(torch.float32)

    topk_score, topk_ind = torch.topk(topk_scores.reshape(b, c * K), K, dim=-1)
    topk_clses = torch.div(topk_ind, K, rounding_mode="floor").to(torch.int32)

    def gather(t):
        return torch.gather(t.reshape(b, c * K), 1, topk_ind)

    return (
        topk_score,
        gather(topk_inds).to(torch.int32),
        topk_clses,
        gather(topk_ys),
        gather(topk_xs),
    )


def _gather_feat(feat: torch.Tensor, inds: torch.Tensor) -> torch.Tensor:
    """Gather a (B, H, W, D) head at (B, K) flat indices -> (B, K, D)."""
    b, h, w, d = feat.shape
    planes = _nchw(feat).reshape(b, d, h * w)
    idx = inds.long()[:, None, :].expand(b, d, inds.shape[1])
    return torch.gather(planes, 2, idx).transpose(1, 2)


def decode(
    hm_cen: torch.Tensor,
    cen_offset: torch.Tensor,
    direction: torch.Tensor,
    z_coor: torch.Tensor,
    dim: torch.Tensor,
    K: int = 50,
) -> torch.Tensor:
    """Heads (NHWC, post-sigmoid hm/offset) -> detections (B, K, 10):
    [score, x, y, z, h, w, l, sin(im), cos(re), cls] in heatmap pixels."""
    heat = heat_nms(hm_cen)
    scores, inds, clses, ys, xs = topk_detections(heat, K=K)
    off = _gather_feat(cen_offset, inds)  # (B, K, 2)
    xs = xs[..., None] + off[:, :, 0:1]
    ys = ys[..., None] + off[:, :, 1:2]
    drt = _gather_feat(direction, inds)  # (B, K, 2)
    z = _gather_feat(z_coor, inds)  # (B, K, 1)
    dims = _gather_feat(dim, inds)  # (B, K, 3)
    return torch.cat(
        [scores[..., None], xs, ys, z, dims, drt, clses[..., None].to(torch.float32)],
        dim=2,
    )


def post_processing(
    detections: torch.Tensor,
    peak_thresh: float = 0.2,
    down_ratio: int = 4,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, K, 10) decode output -> (B, K, 9) BEV-pixel boxes + validity mask.
    Rows: [cls, score, x_bev, y_bev, z, h, w_bev, l_bev, yaw]."""
    score = detections[..., 0]
    x = detections[..., 1] * down_ratio
    y = detections[..., 2] * down_ratio
    z = detections[..., 3]
    h = detections[..., 4]
    w = detections[..., 5] * _recip(cnf.bound_size_y) * cnf.BEV_WIDTH
    l = detections[..., 6] * _recip(cnf.bound_size_x) * cnf.BEV_HEIGHT
    yaw = torch.atan2(detections[..., 7], detections[..., 8])
    cls = detections[..., 9]
    boxes = torch.stack([cls, score, x, y, z, h, w, l, yaw], dim=-1)
    return boxes, score > peak_thresh


def detections_to_real(boxes: torch.Tensor, mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, K, 9) BEV-pixel boxes -> (B, K, 8) metric velodyne-frame rows
    [cls, x, y, z, h, w, l, yaw] (BEV px -> meters, yaw negated)."""
    cls = boxes[..., 0]
    score = boxes[..., 1]
    x_bev, y_bev = boxes[..., 2], boxes[..., 3]
    z = boxes[..., 4] + cnf.boundary["minZ"]
    h = boxes[..., 5]
    w = boxes[..., 6] * _recip(cnf.BEV_WIDTH) * cnf.bound_size_y
    l = boxes[..., 7] * _recip(cnf.BEV_HEIGHT) * cnf.bound_size_x
    yaw = -boxes[..., 8]
    x = y_bev * _recip(cnf.BEV_HEIGHT) * cnf.bound_size_x + cnf.boundary["minX"]
    y = x_bev * _recip(cnf.BEV_WIDTH) * cnf.bound_size_y + cnf.boundary["minY"]
    real = torch.stack([cls, x, y, z, h, w, l, yaw], dim=-1)
    return real, mask & (score > 0)


def masked_detections_to_numpy(boxes, mask) -> Dict[int, np.ndarray]:
    """Host side: strip padding to the reference's ragged per-class layout
    {cls: (n, 8) [score, x, y, z, h, w, l, yaw]}."""
    boxes = torch.as_tensor(boxes).detach().cpu().numpy()
    mask = torch.as_tensor(mask).detach().cpu().numpy()
    out = {}
    for c in range(cnf.NUM_CLASSES):
        sel = mask & (boxes[..., 0].astype(int) == c)
        out[c] = boxes[sel][:, 1:]
    return out
