"""Metric 3D detections -> camera-image 2D AABBs, fixed-K masked, batched
over frames: the port of `sfa3d_tpu/fusion/boxes2d.py`.

Metric velodyne box -> camera frame (yaw ry) -> 8 corners -> P2 projection
-> clipped axis-aligned [x, y, w, h], int-truncated. A detection is kept
when its confidence is >= conf_gate, every corner lies in front of the
image plane (camera z > 0.1: a corner at or behind it flips sign under the
perspective divide), and its clipped box has positive area.
"""

from __future__ import annotations

import torch

from sfa3d_tpu_torch.geometry.transforms import lidar_to_camera_box


def _per_frame(v, like: torch.Tensor) -> torch.Tensor:
    """A number or a (B,) tensor -> a float32 (B, 1) or (1, 1) tensor."""
    return torch.as_tensor(v, dtype=torch.float32, device=like.device).reshape(-1, 1)


def project_boxes_to_image(boxes_real: torch.Tensor, scores: torch.Tensor, mask: torch.Tensor,
                           V2C, R0, P2, *, img_h=375, img_w=1242, conf_gate: float = 0.3):
    """(B, K, 8) metric rows [cls, x, y, z, h, w, l, yaw] + (B, K)
    scores/mask, per-frame V2C (B, 3, 4), R0 (B, 3, 3), P2 (B, 3, 4), and
    `img_h`/`img_w` as numbers or (B,) tensors -> ((B, K, 4) [x, y, w, h]
    int-truncated boxes, (B, K) valid). A single frame (K, 8) with (3, 4)
    matrices and number sizes works too."""
    single = boxes_real.dim() == 2
    if single:
        boxes_real, scores, mask = boxes_real[None], scores[None], mask[None]
    dev = boxes_real.device
    V2C, R0, P2 = (torch.as_tensor(m, dtype=torch.float32, device=dev) for m in (V2C, R0, P2))
    if single:
        V2C, R0, P2 = V2C[None], R0[None], P2[None]
    # lidar_to_camera_points applies (B, 3, 4) matrices to (B, K, 4) rows
    cam = lidar_to_camera_box(boxes_real[..., 1:8], V2C, R0, P2)  # (B, K, 7)
    x, y, z, h, w, l, ry = cam.unbind(-1)

    # 8 corners in the object frame (y up is -h)
    zero = torch.zeros_like(h)
    xc = torch.stack([-l / 2, -l / 2, l / 2, l / 2, -l / 2, -l / 2, l / 2, l / 2], -1)
    yc = torch.stack([zero] * 4 + [-h] * 4, -1)
    zc = torch.stack([-w / 2, w / 2, w / 2, -w / 2, -w / 2, w / 2, w / 2, -w / 2], -1)

    c, s = torch.cos(ry)[..., None], torch.sin(ry)[..., None]
    cx = c * xc + s * zc + x[..., None]
    cy = yc + y[..., None]
    cz = -s * xc + c * zc + z[..., None]
    corners = torch.stack([cx, cy, cz, torch.ones_like(cx)], dim=-1)  # (B, K, 8, 4)

    uvw = torch.einsum("bij,bkcj->bkci", P2, corners)  # (B, K, 8, 3)
    uv = uvw[..., :2] / uvw[..., 2:3]
    in_front = torch.all(uvw[..., 2] > 0.1, dim=-1)

    w_lim = _per_frame(img_w, boxes_real)
    h_lim = _per_frame(img_h, boxes_real)
    min_x = torch.clamp_min(uv[..., 0].amin(-1), 0.0)
    max_x = torch.minimum(uv[..., 0].amax(-1), w_lim)
    min_y = torch.clamp_min(uv[..., 1].amin(-1), 0.0)
    max_y = torch.minimum(uv[..., 1].amax(-1), h_lim)

    valid = mask & in_front & (scores >= conf_gate) & (max_x > min_x) & (max_y > min_y)
    boxes2d = torch.stack(
        [torch.trunc(min_x), torch.trunc(min_y), torch.trunc(max_x - min_x), torch.trunc(max_y - min_y)],
        dim=-1,
    )
    out = torch.where(valid[..., None], boxes2d, 0.0)
    return (out[0], valid[0]) if single else (out, valid)
