"""Seeded inputs of the traffic: KITTI-sized LiDAR scans.

A frozen copy of the port's scene generator (`sfa3d_tpu_torch/data/
synthetic.py::synthetic_scene` and `_box_surface_points`, the same numpy
draws) and of `chip_smoke.py::_kitti_sized_scan`, so that the yardstick
does not move when the program's copy does. A scan is a synthetic scene
(ground, clutter, twelve box-shaped objects: 25-30k points in the front
window) with 85000 points out of range behind and beside it, shuffled:
120600 points, about a raw KITTI scan. One departure from the copies: the
scene's rows are shuffled by a permutation (the same distribution, other
draws; numpy's in-place row shuffle is 25 times slower), so a scene is not
the port's byte for byte.
"""

from __future__ import annotations

from typing import List

import numpy as np

SCAN_POINTS = 20000 + 6000 + 12 * 800 + 85000


def _box_surface_points(rng, h, w, l, x, y, z, yaw, m):
    local = np.empty((m, 3), np.float32)
    local[:, 0] = rng.uniform(-l / 2, l / 2, m)
    local[:, 1] = rng.uniform(-w / 2, w / 2, m)
    local[:, 2] = rng.uniform(0, h, m)
    face = rng.integers(0, 3, m)
    local[face == 0, 0] = np.sign(local[face == 0, 0]) * l / 2
    local[face == 1, 1] = np.sign(local[face == 1, 1]) * w / 2
    local[face == 2, 2] = h * (local[face == 2, 2] > h / 2)
    local[:, 2] += rng.uniform(-0.02, 0.02, m)
    c, s = np.cos(yaw), np.sin(yaw)
    pts = np.empty((m, 4), np.float32)
    pts[:, 0] = c * local[:, 0] - s * local[:, 1] + x
    pts[:, 1] = s * local[:, 0] + c * local[:, 1] + y
    pts[:, 2] = local[:, 2] + z
    frontness = local[:, 0] / l + 0.5
    pts[:, 3] = np.clip(rng.uniform(0.15, 0.35, m) + 0.55 * frontness, 0.0, 1.0)
    return pts


def synthetic_scene(seed: int, n_ground=20000, n_clutter=6000, n_objects=12, points_per_object=800):
    """(points (N, 4) float32, labels (M, 8) [cls, x, y, z, h, w, l, yaw])."""
    rng = np.random.default_rng(seed)
    ground = np.empty((n_ground, 4), np.float32)
    r = np.sqrt(rng.uniform(0.02, 1.0, n_ground))
    theta = rng.uniform(-np.pi, np.pi, n_ground)
    ground[:, 0] = r * 60.0 * np.abs(np.cos(theta))
    ground[:, 1] = r * 40.0 * np.sin(theta)
    ground[:, 2] = rng.normal(-1.73, 0.05, n_ground)
    ground[:, 3] = rng.uniform(0.0, 0.4, n_ground)
    clutter = np.empty((n_clutter, 4), np.float32)
    clutter[:, 0] = rng.uniform(-10, 60, n_clutter)
    clutter[:, 1] = rng.uniform(-30, 30, n_clutter)
    clutter[:, 2] = rng.uniform(-1.7, 1.2, n_clutter)
    clutter[:, 3] = rng.uniform(0, 1, n_clutter)
    dims_by_class = {0: (1.76, 0.66, 0.84), 1: (1.52, 1.63, 3.88), 2: (1.73, 0.60, 1.76)}
    obj_points, labels = [], []
    for _ in range(n_objects):
        cls = int(rng.integers(0, 3))
        h, w, l = dims_by_class[cls]
        h *= rng.uniform(0.9, 1.1)
        w *= rng.uniform(0.9, 1.1)
        l *= rng.uniform(0.9, 1.1)
        x, y, z = rng.uniform(5, 45), rng.uniform(-20, 20), -1.73
        yaw = rng.uniform(-np.pi, np.pi)
        obj_points.append(_box_surface_points(rng, h, w, l, x, y, z, yaw, points_per_object))
        labels.append([cls, x, y, z, h, w, l, -yaw])
    points = np.concatenate([ground, clutter] + obj_points).astype(np.float32)
    return points[rng.permutation(len(points))], np.asarray(labels, np.float32)


def kitti_sized_scan(scene_seed: int, rng: np.random.Generator):
    scan, _ = synthetic_scene(scene_seed)
    far = np.empty((85000, 4), np.float32)
    far[:, 0] = rng.uniform(-80, 0, len(far))
    far[:, 1] = rng.uniform(-80, 80, len(far))
    far[:, 2] = rng.uniform(-3, 1, len(far))
    far[:, 3] = rng.uniform(0, 1, len(far))
    out = np.concatenate([scan, far])
    out = out[rng.permutation(len(out))]
    return out


def scan_pool(seed: int, n: int) -> List[np.ndarray]:
    """n distinct scans from the seed."""
    rng = np.random.default_rng([int(seed) % (2 ** 63), 1])
    scene_seeds = rng.integers(0, 2 ** 31, n)
    return [kitti_sized_scan(int(s), rng) for s in scene_seeds]
