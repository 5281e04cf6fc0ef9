"""KITTI calibration file parsing (host side, numpy), the port of
`sfa3d_tpu/geometry/calibration.py` (`read_calib_file`, `KittiCalibration`).

y_image2 = P2 @ R0_rect @ Tr_velo_to_cam @ x_velo.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from sfa3d_tpu_torch.config import kitti as cnf


def read_calib_file(filepath: str) -> Dict[str, np.ndarray]:
    """Parse a KITTI calib txt into a {key: flat float64 array} dict. Takes
    both 'key: values' and 'key values' lines; skips blank lines, comments
    and lines whose values are not numbers."""
    data = {}
    with open(filepath) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if ":" in line:
                key, value = line.split(":", 1)
            else:
                parts = line.split(" ", 1)
                if len(parts) != 2:
                    continue
                key, value = parts
            try:
                data[key.strip()] = np.array([float(x) for x in value.split()], dtype=np.float64)
            except ValueError:
                continue
    return data


class KittiCalibration:
    """Per-frame KITTI calibration: P2, P3 (3, 4), V2C (3, 4), R0 (3, 3).

    `filepath=None` gives the dataset-average matrices (config/kitti.py);
    `set_matrices` overwrites them in place."""

    def __init__(self, filepath: Optional[str] = None):
        if filepath is None:
            self.P2 = np.asarray(cnf.P2[:3], dtype=np.float64).reshape(3, 4)
            self.P3 = self.P2.copy()
            self.V2C = np.asarray(cnf.Tr_velo_to_cam[:3], dtype=np.float64).reshape(3, 4)
            self.R0 = np.asarray(cnf.R0[:3, :3], dtype=np.float64).reshape(3, 3)
        else:
            calibs = read_calib_file(filepath)
            self.P2 = calibs["P2"].reshape(3, 4)
            self.P3 = calibs.get("P3", calibs["P2"]).reshape(3, 4)
            v2c = calibs.get("Tr_velo_to_cam", calibs.get("Tr_velo2cam"))
            self.V2C = v2c.reshape(3, 4)
            r0 = calibs.get("R0_rect", calibs.get("R_rect"))
            self.R0 = r0.reshape(3, 3)
        self._refresh_intrinsics()

    def _refresh_intrinsics(self):
        self.c_u = self.P2[0, 2]
        self.c_v = self.P2[1, 2]
        self.f_u = self.P2[0, 0]
        self.f_v = self.P2[1, 1]
        self.b_x = self.P2[0, 3] / (-self.f_u)
        self.b_y = self.P2[1, 3] / (-self.f_v)

    def set_matrices(self, P2=None, R0=None, V2C=None):
        """Inject externally estimated matrices."""
        if P2 is not None:
            self.P2 = np.asarray(P2, dtype=np.float64).reshape(3, 4)
        if R0 is not None:
            self.R0 = np.asarray(R0, dtype=np.float64).reshape(3, 3)
        if V2C is not None:
            self.V2C = np.asarray(V2C, dtype=np.float64).reshape(3, 4)
        self._refresh_intrinsics()

    def cart2hom(self, pts):
        return np.hstack([pts, np.ones((pts.shape[0], 1), dtype=pts.dtype)])

    def project_velo_to_rect(self, pts_velo):
        p = self.cart2hom(pts_velo) @ self.V2C.T
        return p @ self.R0.T

    def project_rect_to_image(self, pts_rect):
        p = self.cart2hom(pts_rect) @ self.P2.T
        return p[:, :2] / p[:, 2:3]

    def project_velo_to_image(self, pts_velo):
        return self.project_rect_to_image(self.project_velo_to_rect(pts_velo))


def save_calibration_kitti_format(
    filepath: str,
    calib: Dict[str, np.ndarray],
    extra_comments: Optional[Dict[str, np.ndarray]] = None,
):
    """Write a KITTI-format calib txt: the known keys in KITTI's order, each
    value as `{v:.12e}`, then `extra_comments` as `# key: values` lines."""
    with open(filepath, "w") as f:
        for key in ["P0", "P1", "P2", "P3", "R0_rect", "Tr_velo_to_cam", "Tr_imu_to_velo"]:
            if key in calib:
                vals = " ".join(f"{v:.12e}" for v in np.asarray(calib[key]).ravel())
                f.write(f"{key}: {vals}\n")
        if extra_comments:
            for key, value in extra_comments.items():
                vals = " ".join(f"{v:.12e}" for v in np.asarray(value).ravel())
                f.write(f"# {key}: {vals}\n")
