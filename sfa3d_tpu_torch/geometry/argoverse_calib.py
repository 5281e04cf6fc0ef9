"""Argoverse v1 calibration in numpy: JSON SE3 parsing, projection, lens
distortion, ego-motion compensation. The port of
`sfa3d_tpu/geometry/argoverse_calib.py`, the same functions in the same
float64 arithmetic.

Reference: data_process/argoverse_data_utils_copy.py (ArgoverseCalibration:
L2C = inv(T_ego_cam) @ T_ego_lidar, NaN-masked projection),
data_process/corrected_calib.py and data_process/ref_calib.py (distortion
polynomial :473-567, motion-compensated projection :568-686).

Convention (a reference inconsistency fixed in the JAX package, kept here):
the calibration JSON stores `vehicle_SE3_camera_` = ego_T_cam, and
`extrinsic` is ALWAYS camera_SE3_egovehicle (= inv(ego_T_cam)), so the
lidar and ego projections agree.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np

from sfa3d_tpu_torch.geometry.se3 import SE3, quat2rotmat


class CameraConfig(NamedTuple):
    """(corrected_calib.py:33, ref_calib.py CameraConfig)."""

    extrinsic: np.ndarray  # 4x4 camera_SE3_egovehicle
    intrinsic: np.ndarray  # 3x3 K
    img_width: int
    img_height: int
    distortion_coeffs: np.ndarray  # (3,) radial k1, k2, k3


DEFAULT_DISTORTION = np.array(
    [-0.16983475865148748, 0.1189081299929571, -0.02488434834889849]
)

# Camera inventories (reference corrected_calib.py:12-18 CAMERA_LIST /
# RECTIFIED_STEREO_CAMERA_LIST — the ref hardcodes placeholder names with a
# "You MUST populate these" comment; these are the real Argoverse v1
# argoverse-api camera_stats names its ref_calib.py:14 imports).
RING_CAMERA_LIST = [
    "ring_front_center", "ring_front_left", "ring_front_right",
    "ring_rear_left", "ring_rear_right", "ring_side_left", "ring_side_right",
]
STEREO_CAMERA_LIST = ["stereo_front_left", "stereo_front_right"]
RECTIFIED_STEREO_CAMERA_LIST = [
    "stereo_front_left_rect", "stereo_front_right_rect",
]
CAMERA_LIST = RING_CAMERA_LIST + STEREO_CAMERA_LIST

CAMERA_DIMS = {
    # 'stereo' must precede 'front': stereo camera names contain 'front'
    "stereo": (2464, 2056),  # argoverse-api STEREO_IMG_WIDTH/HEIGHT
    # argoverse_data_utils_copy.py:84-94 hardcoded dims
    "front": (1920, 1200),
    "side": (1280, 960),
    "rear": (1280, 960),
}


def _quat_coeffs_to_rotmat(coeffs) -> np.ndarray:
    """Real Argoverse v1 JSON stores quaternion `coefficients` SCALAR-FIRST
    (qw, qx, qy, qz) — the convention of argoverse-api and of the reference's
    own ref_calib.py:275-276, which passes coefficients straight into a
    (w,x,y,z) quat2rotmat.

    Documented divergence: the reference's corrected_calib.py:56 and
    argoverse_data_utils_copy.py:59 comment "(qx, qy, qz, qw)" and REORDER
    the coefficients, so on real dataset files those paths build garbage
    extrinsics (and disagree with the reference's own motion-compensation
    path). We use the real-dataset convention everywhere; see
    docs/TECHNICAL.md "Intentional divergences"."""
    return quat2rotmat(np.asarray(coeffs, dtype=np.float64))


def _se3_from_json(node: Dict[str, Any]) -> SE3:
    R = _quat_coeffs_to_rotmat(node["rotation"]["coefficients"])
    t = np.asarray(node["translation"], dtype=np.float64)
    return SE3(R, t)


def image_dims_for_camera(camera_name: str) -> Tuple[int, int]:
    for key, dims in CAMERA_DIMS.items():
        if key in camera_name:
            return dims
    raise ValueError(f"Unknown camera name for dimensions: {camera_name}")


def load_calib(calib_filepath: str) -> Dict[str, Any]:
    """(corrected_calib.py:317-349 load_calib)."""
    with open(calib_filepath) as f:
        return json.load(f)


def get_calibration_config(calib_data: Dict[str, Any], camera_name: str) -> CameraConfig:
    """Build a CameraConfig from the vehicle_calibration_info.json payload."""
    camera_value = None
    for cam in calib_data["camera_data"]:
        key = cam["key"]
        # keys look like 'image_raw_ring_front_center'
        if key == camera_name or key.endswith(camera_name):
            camera_value = cam["value"]
            break
    if camera_value is None:
        raise ValueError(f"Calibration data for camera {camera_name} not found.")

    ego_T_cam = _se3_from_json(camera_value["vehicle_SE3_camera_"])
    extrinsic = ego_T_cam.inverse().transform_matrix  # camera_SE3_egovehicle

    K = np.eye(3)
    K[0, 0] = camera_value["focal_length_x_px_"]
    K[0, 1] = camera_value.get("skew_", 0.0)
    K[0, 2] = camera_value["focal_center_x_px_"]
    K[1, 1] = camera_value["focal_length_y_px_"]
    K[1, 2] = camera_value["focal_center_y_px_"]

    width, height = image_dims_for_camera(camera_name)
    dist = np.asarray(camera_value.get("distortion_coeffs", DEFAULT_DISTORTION))
    return CameraConfig(extrinsic, K, width, height, dist)


class ArgoverseCalibration:
    """Per-log calibration with lidar->camera chaining
    (argoverse_data_utils_copy.py:97-231). `calib_data` skips the JSON
    re-read when constructing calibrations for many cameras of one log
    (load_all_camera_calibs / load_stereo_calib)."""

    def __init__(self, calib_filepath: str,
                 target_camera: str = "ring_front_center",
                 calib_data: Optional[Dict[str, Any]] = None):
        self.calib_data = calib_data if calib_data is not None else load_calib(calib_filepath)
        self.target_camera = target_camera
        self.camera_config = get_calibration_config(self.calib_data, target_camera)
        self.P2 = self.camera_config.intrinsic

        lidar_value = self.calib_data["lidar_data"][0]["value"]
        # accept either down_lidar or up_lidar keys
        key = next(k for k in lidar_value if k.startswith("vehicle_SE3"))
        self.ego_T_lidar = _se3_from_json(lidar_value[key])
        # L2C = cam_T_ego @ ego_T_lidar
        self.L2C = self.camera_config.extrinsic @ self.ego_T_lidar.transform_matrix

    def _project_cam_points(self, points_cam: np.ndarray):
        """(N,3) camera-frame -> NaN-masked (N,2) pixels + validity."""
        uvw = points_cam @ self.P2.T
        depth = uvw[:, 2]
        valid = depth > 1e-6
        uv = np.full((len(points_cam), 2), np.nan)
        uv[valid] = uvw[valid, :2] / depth[valid, None]
        w, h = self.camera_config.img_width, self.camera_config.img_height
        in_img = valid & (uv[:, 0] >= 0) & (uv[:, 0] < w) & (uv[:, 1] >= 0) & (uv[:, 1] < h)
        return uv, valid, in_img

    def project_lidar_to_image(self, lidar_points: np.ndarray):
        """(N,3) lidar-frame points -> ((N,2) uv with NaN for behind-camera,
        (N,) depth-valid mask)."""
        hom = np.hstack([lidar_points[:, :3], np.ones((len(lidar_points), 1))])
        cam = (hom @ self.L2C.T)[:, :3]
        uv, valid, _ = self._project_cam_points(cam)
        return uv, valid

    def project_ego_to_image(self, points_ego: np.ndarray):
        """(N,3) ego-frame points -> ((N,2) uv, valid). Uses the CORRECT
        camera_SE3_egovehicle (see module docstring)."""
        hom = np.hstack([points_ego[:, :3], np.ones((len(points_ego), 1))])
        cam = (hom @ self.camera_config.extrinsic.T)[:, :3]
        uv, valid, _ = self._project_cam_points(cam)
        return uv, valid

    def project_image_to_ego(self, uv_depth: np.ndarray) -> np.ndarray:
        """(N,3) [u, v, depth] -> (N,3) ego points (ref_calib.py
        project_image_to_ego)."""
        Kinv = np.linalg.inv(self.P2)
        uv1 = np.hstack([uv_depth[:, :2], np.ones((len(uv_depth), 1))])
        rays = uv1 @ Kinv.T
        cam = rays * uv_depth[:, 2:3]
        ego_T_cam = np.linalg.inv(self.camera_config.extrinsic)
        hom = np.hstack([cam, np.ones((len(cam), 1))])
        return (hom @ ego_T_cam.T)[:, :3]


def load_all_camera_calibs(
    calib_filepath: str, cameras=tuple(CAMERA_LIST)
) -> Dict[str, ArgoverseCalibration]:
    """Calibration objects for every camera present in the log's JSON
    (ref_calib.py:202-226 load_calib, corrected_calib.py:317-331): cameras
    missing from `camera_data` are skipped, mirroring the reference's
    `continue` on a missing `image_raw_<camera>` key."""
    calib_data = load_calib(calib_filepath)
    out: Dict[str, ArgoverseCalibration] = {}
    for camera in cameras:
        try:
            out[camera] = ArgoverseCalibration(
                calib_filepath, camera, calib_data=calib_data
            )
        except ValueError:
            continue
    return out


def load_stereo_calib(
    calib_filepath: str, cameras=tuple(RECTIFIED_STEREO_CAMERA_LIST)
) -> Dict[str, ArgoverseCalibration]:
    """Calibration objects for the rectified stereo pair
    (ref_calib.py:229-257 load_stereo_calib, corrected_calib.py:334-349):
    same per-camera construction as load_all_camera_calibs over the
    RECTIFIED_STEREO_CAMERA_LIST, skipping cameras absent from the JSON."""
    return load_all_camera_calibs(calib_filepath, cameras)


def stereo_baseline_m(
    left: ArgoverseCalibration, right: ArgoverseCalibration
) -> float:
    """Metric baseline of a stereo pair: the distance between the two
    camera centers in the ego frame (translations of ego_T_cam, i.e. of
    inv(extrinsic)). For a rectified pair this is the `b` of the disparity
    relation d = fx * b / z (slam/stereo.py consumes it)."""
    t_l = np.linalg.inv(left.camera_config.extrinsic)[:3, 3]
    t_r = np.linalg.inv(right.camera_config.extrinsic)[:3, 3]
    return float(np.linalg.norm(t_l - t_r))


# ---------------------------------------------------------------------------
# lens distortion (ref_calib.py:473-567, corrected_calib.py:185-203)
# ---------------------------------------------------------------------------


def distort_radius(radius_undist, distort_coeffs=DEFAULT_DISTORTION):
    """Forward radial distortion: r_d = r + k1 r^3 + k2 r^5 + k3 r^7
    (distort_single, ref_calib.py:509-528), vectorized."""
    r = np.asarray(radius_undist, dtype=np.float64)
    r_d = r.copy()
    r_pow = r.copy()
    for k in np.asarray(distort_coeffs):
        r_pow = r_pow * r**2
        r_d = r_d + r_pow * k
    return r_d


def undistort_radius(radius_dist, distort_coeffs=DEFAULT_DISTORTION, iterations: int = 10):
    """Invert the distortion polynomial by fixed-iteration Newton steps
    (corrected_calib.py:185-203 undistort_radius)."""
    r_d = np.asarray(radius_dist, dtype=np.float64)
    r = r_d.copy()
    ks = np.asarray(distort_coeffs)
    for _ in range(iterations):
        f = distort_radius(r, ks) - r_d
        # derivative: 1 + 3 k1 r^2 + 5 k2 r^4 + 7 k3 r^6
        df = np.ones_like(r)
        for i, k in enumerate(ks):
            df = df + (2 * i + 3) * k * r ** (2 * i + 2)
        r = r - f / np.maximum(np.abs(df), 1e-9) * np.sign(df)
    return r


# ---------------------------------------------------------------------------
# ego-motion compensation (ref_calib.py:568-686)
# ---------------------------------------------------------------------------


def get_city_SE3_egovehicle_at_sensor_t(
    timestamp: int, dataset_dir: str, log_id: str
) -> Optional[SE3]:
    """Load the city_SE3_egovehicle pose for a sensor timestamp from the
    log's poses directory (argoverse layout:
    {dataset_dir}/{log_id}/poses/city_SE3_egovehicle_{t}.json)."""
    path = os.path.join(
        dataset_dir, log_id, "poses", f"city_SE3_egovehicle_{timestamp}.json"
    )
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        pose = json.load(f)
    # both forms store the quaternion scalar-first (w, x, y, z), same as the
    # calibration JSON (argoverse-api convention)
    rot = pose["rotation"]
    R = _quat_coeffs_to_rotmat(rot if isinstance(rot, list) else rot["coefficients"])
    trans = pose["translation"]
    if not isinstance(trans, list):  # {"x": .., "y": .., "z": ..} dict form
        trans = [trans["x"], trans["y"], trans["z"]]
    return SE3(R, np.asarray(trans, dtype=np.float64))


def motion_compensate_points(
    pts_lidar_time: np.ndarray,
    city_T_ego_cam_t: SE3,
    city_T_ego_lidar_t: SE3,
) -> np.ndarray:
    """Move ego-frame points captured at lidar time into the ego frame at
    camera time: ego_cam_T_ego_lidar = inv(city_T_ego_cam) * city_T_ego_lidar
    (ref_calib.py:619-686)."""
    rel = city_T_ego_cam_t.inverse().compose(city_T_ego_lidar_t)
    return rel.transform_point_cloud(pts_lidar_time[:, :3])


def project_lidar_to_img_motion_compensated(
    pts_lidar_time: np.ndarray,
    calib: ArgoverseCalibration,
    cam_timestamp: int,
    lidar_timestamp: int,
    dataset_dir: str,
    log_id: str,
):
    """Full motion-compensated ego-frame -> image projection
    (ref_calib.py:568-686). Returns (uv, valid) or (None, None) when poses
    are missing."""
    city_T_cam = get_city_SE3_egovehicle_at_sensor_t(cam_timestamp, dataset_dir, log_id)
    city_T_lid = get_city_SE3_egovehicle_at_sensor_t(lidar_timestamp, dataset_dir, log_id)
    if city_T_cam is None or city_T_lid is None:
        return None, None
    pts_cam_time = motion_compensate_points(pts_lidar_time, city_T_cam, city_T_lid)
    return calib.project_ego_to_image(pts_cam_time)
