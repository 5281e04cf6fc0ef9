"""CenterNet training targets in PyTorch, batched over frames on the device:
the port of `sfa3d_tpu/ops/targets.py` (`compute_radius`,
`_gaussian_splat`, `build_targets`).

Every object slot paints a full-grid Gaussian masked to its radius window,
and the heatmap is the max over slots, per class. The arithmetic follows
the JAX function under `jax.jit` op for op, so that indices and masks are
bit-exact:
- XLA compiles a division by a constant as a multiplication by the float32
  reciprocal, and folds a chain of constant factors into one float32
  constant: `l / bsx * hm_h` is `l * float32(float32(1 / bsx) * hm_h)`
  (3.04 at the default geometry), and so are `(y - min_y) / bsy * hm_w`,
  `diameter / 6` and the radius's `* (1 - o) / (1 + o)`. The port writes
  those products out (`_xla_scale`). A division by a tensor stays one.
- XLA:CPU contracts the mirror `hm_w - (y - min_y) * scale` into one fused
  multiply-add; the port computes it in float64, where the product is exact
  and the difference too unless (y - min_y) * scale < 2^-5, and rounds
  once.
- Under hflip the centre is mirrored exactly, `hm_w - c`, and the grid gate
  also reads the pre-flip x: a label on the max boundary lands on the guard
  cell hm_w, which the raster drops, and its mirror 0 must not become a
  positive.
- Heatmap values go through `exp`, which may differ by an ulp between XLA
  and PyTorch: they are held within a stated tolerance, not bit for bit
  (the peaks, exp(0) = 1, are exact).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from sfa3d_tpu_torch.config import kitti as cnf

_BOUND = (
    cnf.boundary["minX"], cnf.boundary["maxX"],
    cnf.boundary["minY"], cnf.boundary["maxY"],
    cnf.boundary["minZ"], cnf.boundary["maxZ"],
)


def _xla_scale(den: float, num: float = 1.0) -> float:
    """The float32 constant XLA makes of `x / den * num`: the reciprocal
    1 / den and then the product with num, each rounded to float32."""
    return float(np.float32(np.float32(1.0) / np.float32(den)) * np.float32(num))


def compute_radius(det_size, min_overlap: float = 0.7):
    """CenterNet's 3-case minimum-overlap Gaussian radius of (height, width)
    tensors, with the reference's /2 denominators, in the JAX function's
    order of operations."""
    height, width = det_size

    b1 = height + width
    c1 = width * height * _xla_scale(1 + min_overlap, 1 - min_overlap)
    r1 = (b1 + torch.sqrt(b1 * b1 - 4 * c1)) * 0.5

    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    r2 = (b2 + torch.sqrt(b2 * b2 - 4 * 4 * c2)) * 0.5

    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    r3 = (b3 + torch.sqrt(b3 * b3 - 4 * a3 * c3)) * 0.5

    return torch.minimum(torch.minimum(r1, r2), r3)


def _gaussian_splat(center_int: torch.Tensor, radius: torch.Tensor, hm_h: int, hm_w: int) -> torch.Tensor:
    """(..., 2) int32 (x, y) centres and (...) int32 radii -> (..., H, W)
    Gaussians on the full grid, zero outside the [-r, r] square window;
    sigma = (2r + 1) / 6."""
    dev = center_int.device
    cx = center_int[..., 0, None, None]
    cy = center_int[..., 1, None, None]
    dy = torch.arange(hm_h, dtype=torch.int32, device=dev)[:, None] - cy
    dx = torch.arange(hm_w, dtype=torch.int32, device=dev)[None, :] - cx
    r = radius[..., None, None]
    sigma = (2 * r + 1).to(torch.float32) * _xla_scale(6.0)
    dyf, dxf = dy.to(torch.float32), dx.to(torch.float32)
    g = torch.exp(-(dxf * dxf + dyf * dyf) / (2.0 * sigma * sigma))
    window = (dy.abs() <= r) & (dx.abs() <= r)
    return torch.where(window, g, 0.0)


def build_targets(
    labels: torch.Tensor,
    n_valid: torch.Tensor,
    hflipped: torch.Tensor,
    *,
    num_classes: int = 3,
    hm_size: Tuple[int, int] = (152, 152),
    max_objects: int = 50,
    bound: Tuple[float, float, float, float, float, float] = _BOUND,
) -> Dict[str, torch.Tensor]:
    """Training targets of a batch of frames, on the labels' device.

    Args:
      labels: (B, max_objects, 8) float32 rows (cls_id, x, y, z, h, w, l,
        yaw) in the velodyne frame (yaw before the reference's negation).
      n_valid: (B,) int, real label rows per frame.
      hflipped: (B,) bool, the frame's raster was mirrored along W.

    Returns a dict of tensors, each with the batch axis first:
      hm_cen (B, H, W, C) float32; cen_offset (B, M, 2); direction (B, M, 2)
      [sin, cos]; z_coor (B, M, 1); dim (B, M, 3); indices_center (B, M)
      int32 flat y * W + x; obj_mask (B, M) float32.
    """
    hm_h, hm_w = hm_size
    min_x, max_x, min_y, max_y, min_z, max_z = bound
    bsx, bsy = max_x - min_x, max_y - min_y
    labels = torch.as_tensor(labels).to(torch.float32)
    dev = labels.device
    n_valid = torch.as_tensor(n_valid, device=dev)
    hflipped = torch.as_tensor(hflipped, device=dev).to(torch.bool)
    if labels.shape[1] != max_objects:
        raise ValueError(f"labels hold {labels.shape[1]} slots; max_objects is {max_objects}")

    in_slot = torch.arange(max_objects, device=dev)[None, :] < n_valid[:, None]
    cls_id = labels[..., 0].to(torch.int32)
    x, y, z = labels[..., 1], labels[..., 2], labels[..., 3]
    h, w, l = labels[..., 4], labels[..., 5], labels[..., 6]
    yaw = -labels[..., 7]  # the reference negates yaw

    in_bounds = (
        (x >= min_x) & (x <= max_x)
        & (y >= min_y) & (y <= max_y)
        & (z >= min_z) & (z <= max_z)
    )
    active = in_slot & in_bounds & (h > 0) & (w > 0) & (l > 0)
    is_ignore = active & (cls_id < 0)
    is_pos = active & (cls_id >= 0)

    # radius from the box footprint on the heatmap
    bbox_l = l * _xla_scale(bsx, hm_h)
    bbox_w = w * _xla_scale(bsy, hm_w)
    radius = torch.clamp_min(compute_radius((torch.ceil(bbox_l), torch.ceil(bbox_w))).to(torch.int32), 0)

    y_off = y - min_y
    center_x = y_off * _xla_scale(bsy, hm_w)
    center_y = (x - min_x) * _xla_scale(bsx, hm_h)
    center_x_preflip = center_x
    mirrored = (hm_w - y_off.to(torch.float64) * _xla_scale(bsy, hm_w)).to(torch.float32)
    center_x = torch.where(hflipped[:, None], mirrored, center_x)
    center = torch.stack([center_x, center_y], dim=-1)  # (B, M, 2)
    center_int = center.to(torch.int32)  # truncation

    in_grid = (
        (center[..., 0] >= 0) & (center[..., 0] < hm_w)
        & (center_x_preflip < hm_w)
        & (center[..., 1] >= 0) & (center[..., 1] < hm_h)
    )
    is_pos = is_pos & in_grid
    is_ignore = is_ignore & in_grid

    splat = _gaussian_splat(center_int, radius, hm_h, hm_w)  # (B, M, H, W)

    classes = torch.arange(num_classes, device=dev)
    pos_onehot = (cls_id.clamp(0, num_classes - 1)[..., None] == classes).to(torch.float32) * is_pos[..., None]
    ig_onehot = torch.where(
        (cls_id == -1)[..., None],
        torch.ones((), device=dev),
        ((-cls_id - 2).clamp(0, num_classes - 1)[..., None] == classes).to(torch.float32),
    ) * is_ignore[..., None]

    def max_over_slots(onehot):  # (B, M, C) -> (B, H, W, C), one class at a time
        return torch.stack([(splat * onehot[..., c, None, None]).amax(1) for c in range(num_classes)], -1)

    # ignore centres are capped below 1 so they never read as focal-loss positives
    hm = torch.maximum(max_over_slots(pos_onehot), torch.clamp_max(max_over_slots(ig_onehot), 0.9999))

    obj_mask = is_pos
    m = obj_mask[..., None]
    sin_yaw = torch.sin(yaw)
    sin_yaw = torch.where(hflipped[:, None], -sin_yaw, sin_yaw)
    indices_center = torch.where(obj_mask, center_int[..., 1] * hm_w + center_int[..., 0], 0)
    return {
        "hm_cen": hm,
        "cen_offset": (center - center_int.to(torch.float32)) * m,
        "direction": torch.stack([sin_yaw, torch.cos(yaw)], dim=-1) * m,
        "z_coor": ((z - min_z) * obj_mask)[..., None],
        "dim": torch.stack([h, w, l], dim=-1) * m,
        "indices_center": indices_center.to(torch.int32),
        "obj_mask": obj_mask.to(torch.float32),
    }
