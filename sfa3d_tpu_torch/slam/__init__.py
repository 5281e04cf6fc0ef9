"""Dynamic calibration and SLAM, the port of `sfa3d_tpu/slam/`: pluggable
calibration sources (the static KITTI set, simulated visual, LiDAR and
visual-inertial SLAM with frame-indexed drift), RANSAC PnP, the epipolar
chain (fundamental RANSAC, essential matrix, triangulation, pose
recovery), and targetless stereo self-calibration over an ORB detector and
a Hamming matcher owned by the port. The estimators are batched torch
programs on the device; the minimal RANSAC sets are an argument or come
from a CPU generator."""

from sfa3d_tpu_torch.slam.calib_sources import get_calibration_from_slam, SLAM_METHODS
from sfa3d_tpu_torch.slam.pnp import ransac_pnp
from sfa3d_tpu_torch.slam.epipolar import (
    estimate_fundamental_ransac,
    essential_from_fundamental,
    recover_pose,
    triangulate_points,
)

__all__ = [
    "get_calibration_from_slam",
    "SLAM_METHODS",
    "ransac_pnp",
    "estimate_fundamental_ransac",
    "essential_from_fundamental",
    "recover_pose",
    "triangulate_points",
]
