"""SE(3) rigid transforms and quaternion utilities, in numpy: the port of
`sfa3d_tpu/geometry/se3.py` (reference data_process/new_se3.py:4-46 and
new_transform_utils.py:4-28, plus the quaternion -> yaw helper of the
Argoverse dataset, argoverse_dataset.py:144-148).

Quaternions are scalar-first (w, x, y, z), the Argoverse convention.
"""

from __future__ import annotations

import numpy as np


def quat2rotmat(q):
    """Quaternion (w, x, y, z) -> 3x3 rotation matrix, in the textbook
    (Hamilton) form after normalising q (the reference's
    new_transform_utils.py has sign slips in the off-diagonals; this form
    matches scipy's `Rotation.from_quat`)."""
    q = np.asarray(q, dtype=np.float64)
    q = q / np.linalg.norm(q)
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def yaw_from_quaternion(q):
    """Yaw (rotation about +z) of quaternion (w, x, y, z)."""
    w, x, y, z = np.asarray(q, dtype=np.float64)
    return float(np.arctan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z)))


class SE3:
    """Rigid transform: p_dst = R @ p_src + t."""

    def __init__(self, rotation, translation):
        rotation = np.asarray(rotation, dtype=np.float64)
        translation = np.asarray(translation, dtype=np.float64)
        if rotation.shape != (3, 3) or translation.shape != (3,):
            raise ValueError(f"SE3 needs a (3, 3) rotation and a (3,) translation; got "
                             f"{rotation.shape} and {translation.shape}")
        self.rotation = rotation
        self.translation = translation
        self.transform_matrix = np.eye(4)
        self.transform_matrix[:3, :3] = rotation
        self.transform_matrix[:3, 3] = translation

    @classmethod
    def from_quaternion(cls, q, translation):
        return cls(quat2rotmat(q), translation)

    def transform_point_cloud(self, points):
        """(N, 3) -> (N, 3)."""
        return points @ self.rotation.T + self.translation

    def inverse(self) -> "SE3":
        Rt = self.rotation.T
        return SE3(Rt, -(Rt @ self.translation))

    def compose(self, other: "SE3") -> "SE3":
        """self * other: first apply `other`, then `self`."""
        M = self.transform_matrix @ other.transform_matrix
        return SE3(M[:3, :3], M[:3, 3])

    def __repr__(self):
        return f"SE3(R={self.rotation.tolist()}, t={self.translation.tolist()})"
