"""Plain PyTorch BEV raster, the reference of the served raster.

SFA3D's `makeBEVMap` (data_process/kitti_bev_utils.py) keeps, per cell of
the front 50 m x 50 m window at 608 x 608, the highest point's height and
intensity and the point density min(1, log(n + 1) / log 64). The program
follows the JAX package in quantising height to 13 bits and intensity to 12
bits, with a tie on height going to the larger intensity; this reference
states the same rule (a departure from SFA3D, which keeps the raw values),
so that the two compute one function:

    in range      minX <= x <= maxX, minY <= y <= maxY, minZ <= z <= maxZ
    row, col      floor((x - minX) * f32(1/d)), floor(y * f32(1/d)) + W/2
    key           round((z - minZ) * f32(1/(maxZ - minZ)) * 8191) << 12
                  | round(r * 4095), each clamped to its range
    channels      (key & 4095) * f32(1/4095), (key >> 12) * f32(1/8191),
                  min(1, log(min(n, 63) + 1) * f32(1/log 64))

Divisions by constants are products with the float32 reciprocal, as the
program and XLA compute them. `filter_and_pad` is the host-side range
filter: the first `max_points` in-range points, in scan order.
"""

from __future__ import annotations

import numpy as np
import torch


def f32_recip(c: float) -> float:
    return float(np.float32(1.0 / c))


def filter_and_pad(points: np.ndarray, boundary: dict, max_points: int):
    p = np.asarray(points, np.float32)
    keep = ((p[:, 0] >= boundary["minX"]) & (p[:, 0] <= boundary["maxX"])
            & (p[:, 1] >= boundary["minY"]) & (p[:, 1] <= boundary["maxY"])
            & (p[:, 2] >= boundary["minZ"]) & (p[:, 2] <= boundary["maxZ"]))
    kept = p[keep][:max_points]
    out = np.zeros((max_points, 4), np.float32)
    out[: len(kept)] = kept
    valid = np.zeros(max_points, bool)
    valid[: len(kept)] = True
    return out, valid


def raster(points: torch.Tensor, valid: torch.Tensor, boundary: dict, height: int, width: int) -> torch.Tensor:
    """(B, N, 4) float32 padded points + (B, N) mask -> (B, 3, H, W)."""
    b = points.shape[0]
    x, y, z, r = points.float().unbind(-1)
    d = (boundary["maxX"] - boundary["minX"]) / height
    inv_d = f32_recip(d)
    row = torch.floor((x - boundary["minX"]) * inv_d)
    col = torch.floor(y * inv_d) + float(width // 2)
    ok = (valid & (x >= boundary["minX"]) & (x <= boundary["maxX"]) & (y >= boundary["minY"])
          & (y <= boundary["maxY"]) & (z >= boundary["minZ"]) & (z <= boundary["maxZ"])
          & (row >= 0) & (row < height) & (col >= 0) & (col < width))
    z_range = boundary["maxZ"] - boundary["minZ"]
    qz = torch.clamp((z - boundary["minZ"]) * f32_recip(z_range) * 8191.0 + 0.5, 0, 8191).to(torch.int64)
    qr = torch.clamp(torch.nan_to_num(r) * 4095.0 + 0.5, 0, 4095).to(torch.int64)
    key = (qz << 12) | qr
    cells = height * width
    cell = torch.where(ok, row.long() * width + col.long(), cells)
    frame = torch.arange(b, device=points.device)[:, None] * (cells + 1)
    flat = (cell + frame).reshape(-1)
    best = torch.full((b * (cells + 1),), -1, dtype=torch.int64, device=points.device)
    best.scatter_reduce_(0, flat, torch.where(ok, key, -1).reshape(-1), reduce="amax")
    count = torch.bincount(flat, weights=ok.reshape(-1).float(), minlength=b * (cells + 1))
    best = best.view(b, cells + 1)[:, :cells]
    count = count.view(b, cells + 1)[:, :cells].clamp_max(63.0)
    hit = best >= 0
    key0 = best.clamp_min(0)
    intensity = torch.where(hit, (key0 & 4095).float() * f32_recip(4095.0), 0.0)
    height_map = torch.where(hit, (key0 >> 12).float() * f32_recip(8191.0), 0.0)
    density = torch.clamp_max(torch.log(count + 1.0) * f32_recip(float(np.log(64.0))), 1.0)
    return torch.stack([intensity, height_map, density], 1).view(b, 3, height, width)
