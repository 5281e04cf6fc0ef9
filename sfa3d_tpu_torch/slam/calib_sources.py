"""Pluggable calibration sources for the dynamic-calibration fusion path, the
port of `sfa3d_tpu/slam/calib_sources.py`:

- KITTI_DATASET_CALIB: the frame's calibration file (or the base set).
- VISUAL_SLAM_SIM: simulated visual SLAM. Without PnP, frame-indexed
  rotational drift on R0; with PnP, a noisy 3D <-> 2D correspondence grid
  seen from a drifting ground-truth pose, and the pose recovered by
  `slam/pnp.py::ransac_pnp` (on the device, minimal sets from a CPU
  generator seeded with seed + frame index).
- LIDAR_SLAM_SIM: frame-indexed rotation and x-translation drift on V2C.
- VISUAL_INERTIAL_SLAM_SIM: stronger rotation drift on R0, y-translation
  drift on V2C.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from sfa3d_tpu_torch.device import Device, resolve_device

SLAM_METHODS = (
    "KITTI_DATASET_CALIB",
    "VISUAL_SLAM_SIM",
    "LIDAR_SLAM_SIM",
    "VISUAL_INERTIAL_SLAM_SIM",
)

# the base static matrices
P2_BASE = np.array(
    [
        [7.215e02, 0.0, 6.095e02, 4.485e01],
        [0.0, 7.215e02, 1.728e02, 2.163e-01],
        [0.0, 0.0, 1.0, 2.745e-03],
    ],
    dtype=np.float64,
)
R0_BASE = np.array(
    [
        [9.999e-01, 9.837e-03, -7.445e-03],
        [-9.869e-03, 9.999e-01, -4.278e-03],
        [7.402e-03, 4.351e-03, 9.999e-01],
    ],
    dtype=np.float64,
)
V2C_BASE = np.array(
    [
        [7.533e-03, -9.999e-01, -1.481e-02, -4.069e-03],
        [1.465e-02, 1.496e-02, -9.997e-01, -7.631e-02],
        [9.998e-01, 7.523e-03, 1.480e-02, -2.717e-01],
    ],
    dtype=np.float64,
)


def _rot_z(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def _simulate_pnp_visual_slam(frame_idx: int, img_shape, use_pnp: bool, seed: int, device):
    """A 5 x 3 x 3 grid of landmarks projected through a drifting
    ground-truth pose with N(0, 1.5 px) noise, then the pose recovered by
    RANSAC PnP; without PnP (or with fewer than 6 points in the image) the
    canned pose of the drift-only simulation."""
    from sfa3d_tpu_torch.slam.pnp import ransac_pnp, rodrigues

    X, Y, Z = np.meshgrid(
        np.linspace(-5, 5, 5), np.linspace(-2, 2, 3), np.linspace(8, 15, 3)
    )
    obj = np.vstack([X.ravel(), Y.ravel(), Z.ravel()]).T.astype(np.float64)
    rvec_gt = np.array(
        [
            0.005 * np.sin(frame_idx * 0.01),
            0.003 * np.cos(frame_idx * 0.01),
            0.001 * frame_idx,
        ]
    )
    tvec_gt = np.array(
        [
            0.01 * np.sin(frame_idx * 0.005),
            0.005 * np.cos(frame_idx * 0.005),
            0.05 * frame_idx + 10.0,
        ]
    )
    K = P2_BASE[:, :3]
    R_gt = rodrigues(rvec_gt, "cpu").numpy()
    cam = obj @ R_gt.T + tvec_gt
    uvw = cam @ K.T
    uv = uvw[:, :2] / uvw[:, 2:3]
    rng = np.random.default_rng(seed + frame_idx)
    uv_noisy = uv + rng.normal(0, 1.5, uv.shape)
    h, w = img_shape[:2]
    in_img = (
        (uv_noisy[:, 0] >= 0) & (uv_noisy[:, 0] < w)
        & (uv_noisy[:, 1] >= 0) & (uv_noisy[:, 1] < h)
    )

    if not use_pnp or in_img.sum() < 6:
        R_est = rodrigues(np.array([0.01, -0.02, 0.005]), "cpu").numpy()
        t_est = np.array([0.1, 0.2, 1.5])
        return R_est, t_est

    n_pad = 64
    pts3d = np.zeros((n_pad, 3))
    pts2d = np.zeros((n_pad, 2))
    valid = np.zeros((n_pad,), bool)
    m = min(int(in_img.sum()), n_pad)
    pts3d[:m] = obj[in_img][:m]
    pts2d[:m] = uv_noisy[in_img][:m]
    valid[:m] = True
    pose, _, _ = ransac_pnp(
        pts3d.astype(np.float32), pts2d.astype(np.float32), K.astype(np.float32), valid,
        seed=seed + frame_idx, reprojection_error=8.0, device=device,
    )
    pose = pose.cpu().numpy().astype(np.float64)
    return pose[:, :3], pose[:, 3]


def get_calibration_from_slam(
    image_path: str,
    lidar_data=None,
    slam_method: str = "KITTI_DATASET_CALIB",
    img_shape=(375, 1242),
    use_pnp: bool = True,
    seed: int = 2020,
    calib_file: Optional[str] = None,
    device: Device = None,
) -> Dict[str, np.ndarray]:
    """{'P2', 'R0', 'V2C'} (float64) for the frame named by `image_path`
    (its digits are the frame index); `use_pnp` picks the PnP estimator of
    VISUAL_SLAM_SIM, which runs on `device` (cuda unless "cpu")."""
    if slam_method not in SLAM_METHODS:
        raise ValueError(f"unknown SLAM method: {slam_method} (choose from {SLAM_METHODS})")
    dev = resolve_device(device)

    base = os.path.basename(image_path).split(".")[0]
    frame_idx = int(base) if base.isdigit() else 0
    P2, R0, V2C = P2_BASE.copy(), R0_BASE.copy(), V2C_BASE.copy()

    if slam_method == "KITTI_DATASET_CALIB":
        if calib_file and os.path.isfile(calib_file):
            from sfa3d_tpu_torch.geometry.calibration import KittiCalibration

            c = KittiCalibration(calib_file)
            return {"P2": c.P2, "R0": c.R0, "V2C": c.V2C}

    elif slam_method == "VISUAL_SLAM_SIM":
        if use_pnp:
            R_est, t_est = _simulate_pnp_visual_slam(frame_idx, img_shape, True, seed, dev)
            R0 = R_est @ R0_BASE
            V2C[:3, 3] = V2C_BASE[:3, 3] + t_est
        else:
            R0 = R0_BASE @ _rot_z(frame_idx * 0.00005)

    elif slam_method == "LIDAR_SLAM_SIM":
        rot = _rot_z(frame_idx * 0.0001)
        V2C[:3, :3] = V2C_BASE[:3, :3] @ rot
        V2C[:3, 3] = V2C_BASE[:3, 3] + np.array([frame_idx * 0.005, 0, 0])

    elif slam_method == "VISUAL_INERTIAL_SLAM_SIM":
        R0 = R0_BASE @ _rot_z(frame_idx * 0.0002)
        V2C[:3, 3] = V2C_BASE[:3, 3] + np.array([0, frame_idx * 0.002, 0])

    return {"P2": P2, "R0": R0, "V2C": V2C}
