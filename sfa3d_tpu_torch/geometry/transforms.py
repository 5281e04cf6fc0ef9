"""Velodyne -> camera-rect transforms in PyTorch: the part of
`sfa3d_tpu/geometry/transforms.py` that the 3D -> 2D projection needs
(`lidar_to_camera_points`, `lidar_to_camera_box`).

Conventions (KITTI): velodyne x forward, y left, z up, yaw `rz` about +z;
camera-rect x right, y down, z forward, yaw `ry` about +y; rz = -ry - pi/2.
7-DOF boxes are rows of (x, y, z, h, w, l, yaw).

Points may carry leading batch axes; matrices are (3, 4) / (3, 3) for all
of them or carry the same leading axes as the points minus the point axis
(one matrix per frame).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from sfa3d_tpu_torch.config import kitti as cnf


def _default_mats(V2C, R0, like: torch.Tensor):
    if V2C is None or R0 is None:
        V2C, R0 = cnf.Tr_velo_to_cam, cnf.R0
    V2C = torch.as_tensor(V2C, dtype=like.dtype, device=like.device)[..., :3, :]
    R0 = torch.as_tensor(R0, dtype=like.dtype, device=like.device)[..., :3, :3]
    return V2C, R0


def lidar_to_camera_points(points: torch.Tensor, V2C=None, R0=None) -> torch.Tensor:
    """(..., N, 3) velodyne -> (..., N, 3) camera-rect."""
    V2C, R0 = _default_mats(V2C, R0, points)
    p = points[..., :3]
    p = torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)  # (..., N, 4)
    p = p @ V2C.transpose(-1, -2)  # reference camera frame
    return p @ R0.transpose(-1, -2)


def lidar_to_camera_box(boxes: torch.Tensor, V2C=None, R0=None,
                        P2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(..., N, 7) velodyne boxes -> camera boxes (x, y, z, h, w, l, ry)."""
    xyz = lidar_to_camera_points(boxes[..., 0:3], V2C, R0)
    ry = -boxes[..., 6:7] - math.pi / 2
    return torch.cat([xyz, boxes[..., 3:6], ry], dim=-1)
