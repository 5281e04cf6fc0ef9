"""Camera-rect <-> velodyne transforms, the port of
`sfa3d_tpu/geometry/transforms.py`.

`lidar_to_camera_points` / `lidar_to_camera_box` serve the 3D -> 2D
projection on the device (tensors) and the synthetic dataset on the host
(numpy arrays in, numpy out). The dataset and its augmentation use the
numpy functions below on the host: `inverse_rigid_trans`,
`camera_to_lidar_points`, `camera_to_lidar_box`, `center_to_corner_box3d`,
`corner_to_center_box3d`, `point_transform` and `box_transform`, each the
JAX package's numpy route written out op for op. `project_to_image` and
`compute_box_3d_camera` (numpy or tensors) are the JAX module's camera
projection helpers; the drawing modules keep their own int32 projection
(`viz/draw.py`), as the JAX package's do.

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

import numpy as np
import torch

from sfa3d_tpu_torch.config import kitti as cnf


def _default_mats(V2C, R0, like: torch.Tensor):
    if V2C is None or R0 is None:
        V2C, R0 = cnf.Tr_velo_to_cam, cnf.R0
    V2C = torch.as_tensor(V2C, dtype=like.dtype, device=like.device)[..., :3, :]
    R0 = torch.as_tensor(R0, dtype=like.dtype, device=like.device)[..., :3, :3]
    return V2C, R0


def _np_mats(V2C, R0):
    if V2C is None or R0 is None:
        return np.asarray(cnf.Tr_velo_to_cam[:3]), np.asarray(cnf.R0[:3, :3])
    return np.asarray(V2C)[:3], np.asarray(R0)[:3, :3]


def _homogeneous(points: np.ndarray) -> np.ndarray:
    return np.concatenate([points, np.ones_like(points[..., :1])], axis=-1)


def lidar_to_camera_points(points, V2C=None, R0=None):
    """(..., N, 3) velodyne -> (..., N, 3) camera-rect; a numpy array gives
    a numpy array."""
    if isinstance(points, np.ndarray):
        V2C, R0 = _np_mats(V2C, R0)
        return (_homogeneous(points[..., :3]) @ V2C.T) @ R0.T
    V2C, R0 = _default_mats(V2C, R0, points)
    p = points[..., :3]
    p = torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)  # (..., N, 4)
    p = p @ V2C.transpose(-1, -2)  # reference camera frame
    return p @ R0.transpose(-1, -2)


def lidar_to_camera_box(boxes, V2C=None, R0=None, P2: Optional[torch.Tensor] = None):
    """(..., N, 7) velodyne boxes -> camera boxes (x, y, z, h, w, l, ry); a
    numpy array gives a numpy array."""
    xyz = lidar_to_camera_points(boxes[..., 0:3], V2C, R0)
    ry = -boxes[..., 6:7] - math.pi / 2
    if isinstance(boxes, np.ndarray):
        return np.concatenate([xyz, boxes[..., 3:6], ry], axis=-1)
    return torch.cat([xyz, boxes[..., 3:6], ry], dim=-1)


def inverse_rigid_trans(Tr: np.ndarray) -> np.ndarray:
    """Invert a (3, 4) [R|t] rigid transform."""
    R, t = Tr[:3, :3], Tr[:3, 3]
    Rt = np.swapaxes(R, -1, -2)
    return np.concatenate([Rt, (-Rt @ t)[..., None]], axis=-1)


def camera_to_lidar_points(points: np.ndarray, V2C=None, R0=None) -> np.ndarray:
    """(N, 3) camera-rect -> (N, 3) velodyne."""
    V2C, R0 = _np_mats(V2C, R0)
    p = points[..., :3] @ np.swapaxes(R0, -1, -2).T  # undo rectification
    return _homogeneous(p) @ inverse_rigid_trans(V2C).T


def camera_to_lidar_box(boxes: np.ndarray, V2C=None, R0=None, P2=None) -> np.ndarray:
    """(N, 7) camera boxes (x, y, z, h, w, l, ry) -> velodyne (x, y, z, h,
    w, l, rz), rz = -ry - pi/2."""
    xyz = camera_to_lidar_points(boxes[..., 0:3], V2C, R0)
    return np.concatenate([xyz, boxes[..., 3:6], -boxes[..., 6:7] - np.pi / 2], axis=-1)


# unit box corners in the velodyne frame, bottom face first (box origin at
# the bottom centre); columns scale by (l, w, h)
_CORNER_TEMPLATE = np.array([
    [-0.5, +0.5, 0.0], [-0.5, -0.5, 0.0], [+0.5, -0.5, 0.0], [+0.5, +0.5, 0.0],
    [-0.5, +0.5, 1.0], [-0.5, -0.5, 1.0], [+0.5, -0.5, 1.0], [+0.5, +0.5, 1.0],
])


def center_to_corner_box3d(boxes: np.ndarray) -> np.ndarray:
    """(N, 7) velodyne boxes -> (N, 8, 3) corners."""
    h, w, l, yaw = boxes[..., 3], boxes[..., 4], boxes[..., 5], boxes[..., 6]
    corners = _CORNER_TEMPLATE[None, :, :] * np.stack([l, w, h], axis=-1)[:, None, :]
    c, s = np.cos(yaw), np.sin(yaw)
    zeros, ones = np.zeros_like(c), np.ones_like(c)
    rot = np.stack([np.stack([c, -s, zeros], axis=-1),
                    np.stack([s, c, zeros], axis=-1),
                    np.stack([zeros, zeros, ones], axis=-1)], axis=-2)
    return np.einsum("nij,nkj->nki", rot, corners) + boxes[..., None, 0:3]


def corner_to_center_box3d(corners: np.ndarray) -> np.ndarray:
    """(N, 8, 3) velodyne corners -> (N, 7) boxes: averaged edge lengths and
    edge-angle yaw."""
    xy_bottom = np.mean(corners[..., :4, :2], axis=-2)
    z = np.mean(corners[..., :4, 2], axis=-1)
    h = np.abs(np.mean(corners[..., 4:, 2] - corners[..., :4, 2], axis=-1))

    def edge(a, b):
        return np.sqrt(np.sum((corners[..., a, :2] - corners[..., b, :2]) ** 2, axis=-1))

    def yaw_edge(a, b):
        d = corners[..., b, :2] - corners[..., a, :2]
        return np.arctan2(d[..., 1], d[..., 0])

    w = (edge(0, 1) + edge(2, 3) + edge(4, 5) + edge(6, 7)) / 4.0
    l = (edge(0, 3) + edge(1, 2) + edge(4, 7) + edge(5, 6)) / 4.0
    yaw = (yaw_edge(1, 2) + yaw_edge(0, 3) + yaw_edge(5, 6) + yaw_edge(4, 7)) / 4.0
    return np.stack([xy_bottom[..., 0], xy_bottom[..., 1], z, h, w, l, yaw], axis=-1)


def point_transform(points: np.ndarray, tx, ty, tz, rx=0.0, ry=0.0, rz=0.0) -> np.ndarray:
    """Translate, then rotate (N, 3) points: p' = (p + t) @ Rx @ Ry @ Rz,
    row vectors multiplied on the right (the reference's convention)."""
    p = points[..., :3] + np.asarray([tx, ty, tz])

    def rot_x(a):
        c, s = np.cos(a), np.sin(a)
        return np.asarray([[1, 0, 0], [0, c, -s], [0, s, c]])

    def rot_y(a):
        c, s = np.cos(a), np.sin(a)
        return np.asarray([[c, 0, s], [0, 1, 0], [-s, 0, c]])

    def rot_z(a):
        c, s = np.cos(a), np.sin(a)
        return np.asarray([[c, -s, 0], [s, c, 0], [0, 0, 1]])

    if not np.isscalar(rx) or rx != 0:
        p = p @ rot_x(rx)
    if not np.isscalar(ry) or ry != 0:
        p = p @ rot_y(ry)
    if not np.isscalar(rz) or rz != 0:
        p = p @ rot_z(rz)
    return p


def box_transform(boxes: np.ndarray, tx, ty, tz, r=0.0) -> np.ndarray:
    """Rigid-transform velodyne boxes through their corners; h, w, l are
    kept as they were."""
    corners = center_to_corner_box3d(boxes)
    flat = point_transform(corners.reshape(-1, 3), tx, ty, tz, rz=r)
    out = corner_to_center_box3d(flat.reshape(corners.shape))
    return np.concatenate([out[..., :3], boxes[..., 3:6], out[..., 6:7]], axis=-1)


def project_to_image(pts_3d, P):
    """(N, 3) camera-rect points -> (N, 2) float pixels through the 3 x 4
    P: [p, 1] @ P.T, then x / z and y / z. A numpy array gives a numpy
    array; a tensor a tensor."""
    if isinstance(pts_3d, np.ndarray):
        p = _homogeneous(pts_3d) @ np.asarray(P).T
        return p[..., :2] / p[..., 2:3]
    P = torch.as_tensor(P, dtype=pts_3d.dtype, device=pts_3d.device)
    p = torch.cat([pts_3d, torch.ones_like(pts_3d[..., :1])], dim=-1) @ P.T
    return p[..., :2] / p[..., 2:3]


def compute_box_3d_camera(box, P=None):
    """Camera-frame 8 corners of (..., 7) boxes (x, y, z, h, w, l, ry),
    origin at the bottom centre, y down: (..., 8, 3) points, and (..., 8, 2)
    pixels when P is given. numpy in, numpy out; tensors likewise."""
    xp = np if isinstance(box, np.ndarray) else torch
    x, y, z, h, w, l, ry = [box[..., i] for i in range(7)]
    c, s = xp.cos(ry), xp.sin(ry)
    x_c = xp.stack([l / 2, l / 2, -l / 2, -l / 2, l / 2, l / 2, -l / 2, -l / 2], -1)
    y_c = xp.stack([xp.zeros_like(h)] * 4 + [-h] * 4, -1)
    z_c = xp.stack([w / 2, -w / 2, -w / 2, w / 2, w / 2, -w / 2, -w / 2, w / 2], -1)
    cx = c[..., None] * x_c + s[..., None] * z_c + x[..., None]
    cy = y_c + y[..., None]
    cz = -s[..., None] * x_c + c[..., None] * z_c + z[..., None]
    corners = xp.stack([cx, cy, cz], -1)
    if P is None:
        return corners
    return corners, project_to_image(corners, P)
