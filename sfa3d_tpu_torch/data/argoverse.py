"""Argoverse v1 dataset reader, device-side batch preparation, training
loader and synthetic fixture writer: the port of `sfa3d_tpu/data/argoverse.py`.

The reader pairs `samplefile/lidar/*.bin` (or `*.ply`) sweeps with camera
frames by sorted order, takes labels from one `annotations/track_label.json`
keyed by timestamp and the calibration from `vehicle_calibration_info.json`,
and emits the same fixed-shape padded samples as the KITTI reader
(reference data_process/argoverse_dataset.py and argoverse_dataloader.py).
`argoverse_prepare_batch` turns a collated batch into the detector's input
on the points' device: the 1000 x 1000 Argoverse raster (one launch of the
hand-written tile kernel), its centre 608 x 608 crop and the training
targets in that crop's frame.

Camera frames are paired but never decoded here: nothing on the detection
or training path reads their pixels. The port has no JPEG codec, so its
fixture writer stores each frame as a PNG (`data/png.py`) of the seeded
pixels that the JAX writer JPEG-encodes with cv2; the reader pairs `*.jpg`
and `*.png` frames alike.
"""

from __future__ import annotations

import glob
import json
import math
import os
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from sfa3d_tpu_torch.config import argoverse as acnf
from sfa3d_tpu_torch.data.loader import KittiTrainLoader
from sfa3d_tpu_torch.device import Device
from sfa3d_tpu_torch.geometry.argoverse_calib import ArgoverseCalibration
from sfa3d_tpu_torch.geometry.se3 import yaw_from_quaternion
from sfa3d_tpu_torch.ops.bev import argoverse_points_to_bev_nchw, filter_and_pad_points
from sfa3d_tpu_torch.ops.bev_counts import _f32_reciprocal
from sfa3d_tpu_torch.ops.targets import build_targets

CROP = 608  # the detector's input: the centre of the 1000 x 1000 raster
HALF = 30.4  # m: (608 px * 0.1 m/px) / 2
CROP_BOUND = (0.0, 2 * HALF, -HALF, HALF, acnf.boundary["minZ"], acnf.boundary["maxZ"])
_INV_255 = _f32_reciprocal(255.0)  # XLA compiles the crop's / 255.0 as this product


def load_ply_lidar(path: str) -> np.ndarray:
    """Minimal PLY reader for Argoverse sweeps (x, y, z, intensity[,
    laser_number]); binary little-endian or ASCII. -> (N, 4) float32."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii").strip()
            header.append(line)
            if line == "end_header":
                break
        n_vertex = 0
        props = []
        fmt = "binary_little_endian"
        for line in header:
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element vertex"):
                n_vertex = int(line.split()[-1])
            elif line.startswith("property"):
                _, ptype, pname = line.split()
                props.append((pname, ptype))
        type_map = {
            "float": "<f4", "float32": "<f4", "double": "<f8",
            "uchar": "u1", "uint8": "u1", "int": "<i4", "uint32": "<u4",
            "short": "<i2", "ushort": "<u2",
        }
        if fmt != "binary_little_endian":
            data = np.loadtxt(f, max_rows=n_vertex)
            arr = {name: data[:, i] for i, (name, _) in enumerate(props)}
        else:
            dtype = np.dtype([(n, type_map[t]) for n, t in props])
            raw = np.frombuffer(f.read(dtype.itemsize * n_vertex), dtype=dtype)
            arr = {n: raw[n].astype(np.float64) for n, _ in props}
    x = arr.get("x")
    y = arr.get("y")
    z = arr.get("z")
    intensity = arr.get("intensity", np.zeros_like(x))
    return np.stack([x, y, z, intensity], axis=1).astype(np.float32)


def load_lidar(path: str) -> np.ndarray:
    if path.endswith(".ply"):
        return load_ply_lidar(path)
    return np.fromfile(path, dtype=np.float32).reshape(-1, 4)


@dataclass
class ArgoverseSample:
    timestamp: str
    points: np.ndarray  # (max_points, 4) padded ego-frame points
    valid: np.ndarray
    labels: np.ndarray  # (max_objects, 8) [cls, x, y, z, h, w, l, yaw]
    n_labels: np.int32
    img_path: str
    lidar_path: str
    calib: Optional[ArgoverseCalibration]


class ArgoverseDataset:
    """Fixed-shape Argoverse samples (argoverse_dataset.py:29-193)."""

    def __init__(
        self,
        dataset_dir: str,
        mode: str = "train",
        target_camera: str = "ring_front_center",
        num_samples: Optional[int] = None,
        max_points: int = acnf.MAX_POINTS,
        max_objects: int = 50,
    ):
        if mode not in ("train", "val", "test"):
            raise ValueError(f"mode must be train, val or test; got {mode!r}")
        self.dataset_dir = dataset_dir
        self.mode = mode
        self.target_camera = target_camera
        self.max_points = max_points
        self.max_objects = max_objects

        lidar_dir = os.path.join(dataset_dir, "samplefile", "lidar")
        image_dir = os.path.join(dataset_dir, "samplefile", target_camera)
        self.lidar_files = sorted(
            glob.glob(os.path.join(lidar_dir, "*.bin"))
            + glob.glob(os.path.join(lidar_dir, "*.ply"))
        )
        self.image_files = sorted(
            glob.glob(os.path.join(image_dir, "*.jpg"))
            + glob.glob(os.path.join(image_dir, "*.png"))
        )
        n = min(len(self.lidar_files), len(self.image_files)) or len(self.lidar_files)
        if num_samples is not None:
            n = min(n, num_samples)
        self.num_samples = n

        ann_path = os.path.join(dataset_dir, "annotations", "track_label.json")
        self.annotations = {}
        if os.path.isfile(ann_path):
            with open(ann_path) as f:
                self.annotations = json.load(f)

        calib_path = os.path.join(dataset_dir, "vehicle_calibration_info.json")
        self.calib = (
            ArgoverseCalibration(calib_path, target_camera=target_camera)
            if os.path.isfile(calib_path)
            else None
        )

    def __len__(self):
        return self.num_samples

    def _labels_for(self, timestamp: str) -> np.ndarray:
        frame = self.annotations.get(timestamp)
        if not frame:
            return np.zeros((0, 8), np.float32)
        rows = []
        for obj in frame.get("track_label_list", []):
            cls_name = obj.get("object_type", obj.get("label_class"))
            if cls_name not in acnf.CLASS_NAME_TO_ID:
                continue
            cls_id = acnf.CLASS_NAME_TO_ID[cls_name]
            x, y, z = (
                obj["translation"]
                if isinstance(obj["translation"], list)
                else [obj["translation"][k] for k in ("x", "y", "z")]
            )
            h, w, l = obj["height"], obj["width"], obj["length"]
            q = obj["rotation"]
            if isinstance(q, dict):
                q = q["coefficients"]
            # scalar-first (w, x, y, z), as argoverse-api stores them; yaw about +z
            rows.append([cls_id, x, y, z, h, w, l, yaw_from_quaternion(q)])
        return np.asarray(rows, np.float32) if rows else np.zeros((0, 8), np.float32)

    def __getitem__(self, index: int) -> ArgoverseSample:
        lidar_path = self.lidar_files[index]
        img_path = self.image_files[index] if index < len(self.image_files) else ""
        timestamp = os.path.splitext(os.path.basename(lidar_path))[0]
        pts, valid = filter_and_pad_points(
            load_lidar(lidar_path), max_points=self.max_points, boundary=acnf.boundary
        )
        labels = self._labels_for(timestamp)
        lab = np.zeros((self.max_objects, 8), np.float32)
        k = min(len(labels), self.max_objects)
        lab[:k] = labels[:k]
        return ArgoverseSample(
            timestamp, pts, valid, lab, np.int32(k), img_path, lidar_path, self.calib
        )


def crop_raster(bev_nchw: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) Argoverse raster in [0, 255] -> its centre (B, 3, 608,
    608) crop in [0, 1], the detector's input."""
    h, w = bev_nchw.shape[-2:]
    y0, x0 = (h - CROP) // 2, (w - CROP) // 2
    return bev_nchw[:, :, y0:y0 + CROP, x0:x0 + CROP] * _INV_255


def argoverse_prepare_batch(
    points: torch.Tensor,  # (N, P, 4) float32
    valid: torch.Tensor,  # (N, P) bool
    labels: torch.Tensor,  # (N, M, 8)
    n_labels: torch.Tensor,  # (N,)
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Device-side preparation of a flat batch of N sweeps, on the points'
    device: the Argoverse raster's centre crop (N, 3, 608, 608) in [0, 1]
    and the `build_targets` dict in the crop's frame.

    The raster's row runs along -x; the crop covers x, y in (-30.4, 30.4].
    `build_targets` takes the KITTI frame, row increasing with x, so the labels are
    mirrored into the crop's frame: x' = 30.4 - x (row' = (30.4 - x) * 2.5 =
    (raster row - 196) / 4), yaw' = pi - yaw (the mirror reverses heading),
    with the bound (0, 60.8, -30.4, 30.4, minZ, maxZ); y, z, h, w, l keep."""
    bev = crop_raster(argoverse_points_to_bev_nchw(points, valid))
    labels = torch.as_tensor(labels, device=bev.device).to(torch.float32)
    crop_labels = torch.cat(
        [labels[..., 0:1], HALF - labels[..., 1:2], labels[..., 2:7], math.pi - labels[..., 7:8]], dim=-1
    )
    n_labels = torch.as_tensor(n_labels, device=bev.device)
    no_flip = torch.zeros(labels.shape[0], dtype=torch.bool, device=bev.device)
    targets = build_targets(crop_labels, n_labels, no_flip, max_objects=labels.shape[1], bound=CROP_BOUND)
    return bev, targets


class ArgoverseTrainLoader(KittiTrainLoader):
    """Batched loader for the Argoverse path (argoverse_dataloader.py): the
    KITTI loader's sampler, collation, tail and process sharding, with
    `argoverse_prepare_batch` as its device preparation. It has no hflip and
    no LiDAR augmentation, as the reference's Argoverse path has none."""

    def __init__(self, dataset, batch_size: int, subdivisions: int = 1,
                 shuffle: bool = True, seed: int = 2020, drop_last: bool = True,
                 process_index: int = 0, process_count: int = 1,
                 num_workers: int = 0, prefetch: int = 2, device: Device = None):
        def prepare(points, valid, labels, n_labels, hflip):
            return argoverse_prepare_batch(points, valid, labels, n_labels)

        super().__init__(
            dataset, batch_size, subdivisions, shuffle, seed, drop_last,
            process_index, process_count, prepare_fn=prepare,
            num_workers=num_workers, prefetch=prefetch, device=device,
        )


def write_mini_argoverse(root: str, n_frames: int = 2, seed: int = 0) -> str:
    """Synthetic Argoverse-layout fixture: lidar .bin sweeps, camera frames,
    track_label.json, vehicle_calibration_info.json and per-frame poses, so
    the whole Argoverse path runs without the dataset. The lidar, JSON and
    pose files are byte for byte the JAX writer's; each camera frame is a
    PNG of the seeded pixels (BGR, as the JAX writer hands them to cv2)
    where the JAX writer stores a JPEG."""
    from sfa3d_tpu_torch.data.png import write_png_rgb
    from sfa3d_tpu_torch.data.synthetic import synthetic_scene

    os.makedirs(os.path.join(root, "samplefile", "lidar"), exist_ok=True)
    os.makedirs(os.path.join(root, "samplefile", "ring_front_center"), exist_ok=True)
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    os.makedirs(os.path.join(root, "log0", "poses"), exist_ok=True)

    rng = np.random.default_rng(seed)
    annotations = {}
    base_ts = 315974052820626000
    for i in range(n_frames):
        ts = base_ts + i * 100_000_000
        pts, labels = synthetic_scene(seed=seed + i)
        pts.tofile(os.path.join(root, "samplefile", "lidar", f"{ts}.bin"))
        img = (rng.uniform(0, 255, (120, 192, 3))).astype(np.uint8)
        write_png_rgb(os.path.join(root, "samplefile", "ring_front_center", f"{ts}.png"), img[:, :, ::-1])
        track_list = []
        for cls, x, y, z, h, w, l, yaw in labels:
            yaw = -yaw  # synthetic labels store -yaw (see synthetic_scene)
            track_list.append(
                {
                    "object_type": ["PEDESTRIAN", "VEHICLE", "BICYCLE"][int(cls)],
                    "translation": [float(x), float(y), float(z)],
                    "height": float(h), "width": float(w), "length": float(l),
                    "rotation": [float(np.cos(yaw / 2)), 0.0, 0.0, float(np.sin(yaw / 2))],
                }
            )
        annotations[str(ts)] = {"track_label_list": track_list}
        pose = {
            "rotation": [1.0, 0.0, 0.0, float(i) * 1e-4],  # (w, x, y, z)
            "translation": [float(i) * 0.5, 0.0, 0.0],
        }
        with open(
            os.path.join(root, "log0", "poses", f"city_SE3_egovehicle_{ts}.json"), "w"
        ) as f:
            json.dump(pose, f)

    with open(os.path.join(root, "annotations", "track_label.json"), "w") as f:
        json.dump(annotations, f)

    calib = {
        "camera_data": [
            {
                "key": "image_raw_ring_front_center",
                "value": {
                    "focal_length_x_px_": 1392.0,
                    "focal_length_y_px_": 1392.0,
                    "focal_center_x_px_": 980.0,
                    "focal_center_y_px_": 604.0,
                    "skew_": 0.0,
                    "vehicle_SE3_camera_": {
                        # camera looks along ego +x: cam z = ego x;
                        # coefficients scalar-first (w, x, y, z)
                        "rotation": {"coefficients": [0.5, -0.5, 0.5, -0.5]},
                        "translation": [1.6, 0.0, 1.4],
                    },
                },
            },
        ]
        # a rectified stereo pair in the front camera's optical frame, 0.3 m
        # apart along ego -y (the left camera on +y)
        + [
            {
                "key": f"image_raw_{name}",
                "value": {
                    "focal_length_x_px_": 3660.0,
                    "focal_length_y_px_": 3660.0,
                    "focal_center_x_px_": 1232.0,
                    "focal_center_y_px_": 1028.0,
                    "skew_": 0.0,
                    "vehicle_SE3_camera_": {
                        "rotation": {"coefficients": [0.5, -0.5, 0.5, -0.5]},
                        "translation": [1.6, ty, 1.4],
                    },
                },
            }
            for name, ty in [
                ("stereo_front_left_rect", 0.1493),
                ("stereo_front_right_rect", -0.1493),
            ]
        ],
        "lidar_data": [
            {
                "key": "down_lidar",
                "value": {
                    "vehicle_SE3_down_lidar_": {
                        # identity rotation, scalar-first (w, x, y, z)
                        "rotation": {"coefficients": [1.0, 0.0, 0.0, 0.0]},
                        "translation": [1.35, 0.0, 1.68],
                    }
                },
            }
        ],
    }
    with open(os.path.join(root, "vehicle_calibration_info.json"), "w") as f:
        json.dump(calib, f)
    return root
