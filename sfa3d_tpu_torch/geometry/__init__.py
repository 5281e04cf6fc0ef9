"""Calibration and the camera <-> LiDAR transforms; the port of
`sfa3d_tpu/geometry/`, exporting the names its `__init__` does."""

from sfa3d_tpu_torch.geometry.transforms import (
    camera_to_lidar_points,
    lidar_to_camera_points,
    camera_to_lidar_box,
    lidar_to_camera_box,
    center_to_corner_box3d,
    corner_to_center_box3d,
    point_transform,
    box_transform,
    inverse_rigid_trans,
    project_to_image,
)
from sfa3d_tpu_torch.geometry.se3 import SE3, quat2rotmat, yaw_from_quaternion
from sfa3d_tpu_torch.geometry.calibration import KittiCalibration, save_calibration_kitti_format

__all__ = [
    "camera_to_lidar_points",
    "lidar_to_camera_points",
    "camera_to_lidar_box",
    "lidar_to_camera_box",
    "center_to_corner_box3d",
    "corner_to_center_box3d",
    "point_transform",
    "box_transform",
    "inverse_rigid_trans",
    "project_to_image",
    "SE3",
    "quat2rotmat",
    "yaw_from_quaternion",
    "KittiCalibration",
    "save_calibration_kitti_format",
]
