"""LiDAR augmentation on the host (numpy), the port of
`sfa3d_tpu/data/augment.py`: Compose / OneOf / RandomRotation /
RandomScaling / Cutout and the reference training augmentation. Each
transform draws from the numpy Generator it is given, in the JAX package's
order, so one generator gives the same augmented sample in both packages.
RandomScaling samples its whole range (the reference drew a constant).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from sfa3d_tpu_torch.geometry.transforms import box_transform, point_transform


class Compose:
    """Apply all transforms with probability p (transformation.py:313-322)."""

    def __init__(self, transforms: Sequence, p: float = 1.0):
        self.transforms = list(transforms)
        self.p = p

    def __call__(self, lidar, labels, rng: np.random.Generator):
        if rng.random() <= self.p:
            for t in self.transforms:
                lidar, labels = t(lidar, labels, rng)
        return lidar, labels


class OneOf:
    """Apply one randomly chosen transform with probability p
    (transformation.py:325-335)."""

    def __init__(self, transforms: Sequence, p: float = 1.0):
        self.transforms = list(transforms)
        self.p = p

    def __call__(self, lidar, labels, rng: np.random.Generator):
        if rng.random() <= self.p:
            choice = rng.integers(0, len(self.transforms))
            lidar, labels = self.transforms[choice](lidar, labels, rng)
        return lidar, labels


class RandomRotation:
    """Rotate scan + boxes about +z by U(-limit, limit)
    (transformation.py:338-353)."""

    def __init__(self, limit_angle: float = np.pi / 4, p: float = 0.5):
        self.limit_angle = limit_angle
        self.p = p

    def __call__(self, lidar, labels, rng: np.random.Generator):
        if rng.random() <= self.p:
            angle = rng.uniform(-self.limit_angle, self.limit_angle)
            lidar = lidar.copy()
            lidar[:, 0:3] = np.asarray(
                point_transform(lidar[:, 0:3], 0.0, 0.0, 0.0, rz=angle)
            )
            if len(labels):
                labels = np.asarray(box_transform(labels, 0.0, 0.0, 0.0, r=angle))
        return lidar, labels


class RandomScaling:
    """Uniformly scale scan + box geometry (transformation.py:356-371,
    with the constant-factor bug fixed)."""

    def __init__(self, scaling_range: Tuple[float, float] = (0.95, 1.05), p: float = 0.5):
        self.scaling_range = scaling_range
        self.p = p

    def __call__(self, lidar, labels, rng: np.random.Generator):
        if rng.random() <= self.p:
            factor = rng.uniform(self.scaling_range[0], self.scaling_range[1])
            lidar = lidar.copy()
            lidar[:, 0:3] *= factor
            if len(labels):
                labels = labels.copy()
                labels[:, 0:6] *= factor
        return lidar, labels


class Cutout:
    """Mask random square patches from the BEV raster, dropping targets whose
    centers fall inside (transformation.py:374-422). Operates on the (H, W, C)
    raster + (M, 8) label rows [cls, x, y, ...] expressed in raster pixels."""

    def __init__(self, n_holes: int, ratio: float, fill_value: float = 0.0, p: float = 1.0):
        assert 0.0 <= fill_value <= 1.0
        self.n_holes = n_holes
        self.ratio = ratio
        self.fill_value = fill_value
        self.p = p

    def __call__(self, bev, targets_px, rng: np.random.Generator):
        if rng.random() <= self.p:
            h, w = bev.shape[0], bev.shape[1]
            hc, wc = int(self.ratio * h), int(self.ratio * w)
            bev = bev.copy()
            for _ in range(self.n_holes):
                y = rng.integers(0, h)
                x = rng.integers(0, w)
                y1, y2 = np.clip(y - hc // 2, 0, h), np.clip(y + hc // 2, 0, h)
                x1, x2 = np.clip(x - wc // 2, 0, w), np.clip(x + wc // 2, 0, w)
                bev[y1:y2, x1:x2, :] = self.fill_value
                if len(targets_px):
                    keep = ~(
                        (targets_px[:, 1] >= x1) & (targets_px[:, 1] <= x2)
                        & (targets_px[:, 2] >= y1) & (targets_px[:, 2] <= y2)
                    )
                    targets_px = targets_px[keep]
        return bev, targets_px


def default_train_aug(aug_prob: float = 0.66,
                      rotation_limit: float = np.pi / 4,
                      scaling_range: Tuple[float, float] = (0.95, 1.05)):
    """The reference training augmentation: OneOf(rotation, scaling) @ p=0.66
    (kitti_dataloader.py:20-23)."""
    return OneOf(
        [RandomRotation(rotation_limit, p=1.0), RandomScaling(scaling_range, p=1.0)],
        p=aug_prob,
    )
