"""KITTI dataset reader on the host, the port of `sfa3d_tpu/data/kitti.py`
(`KittiSample`, `Object3d`, `read_label`, `parse_labels_camera`,
`KittiDataset`, and `DemoKittiDataset` for raw drives).

Samples come out as fixed-shape padded arrays (points + label slots +
counts) so that batches go straight to the device raster and to
`build_targets`; the Gaussian splats are made on the device
(`ops/targets.py`). Augmentation draws from a generator made per (seed,
epoch, index), so the threaded loader and the synchronous one give the
same samples in any completion order.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from sfa3d_tpu_torch import native
from sfa3d_tpu_torch.config import kitti as cnf
from sfa3d_tpu_torch.geometry.calibration import KittiCalibration
from sfa3d_tpu_torch.geometry.transforms import camera_to_lidar_box
from sfa3d_tpu_torch.ops.bev import filter_and_pad_points


@dataclass
class KittiSample:
    sample_id: int
    points: np.ndarray  # (max_points, 4) padded, RAW z (kernel shifts)
    valid: np.ndarray  # (max_points,) bool
    labels: np.ndarray  # (max_objects, 8) [cls, x, y, z, h, w, l, yaw] velodyne
    n_labels: np.int32
    img_path: str
    calib: Optional[KittiCalibration] = None
    # (max_objects,) int difficulty per label row (1/2/3, 4 = unknown;
    # 0 past n_labels) — feeds the evaluator's Easy/Moderate/Hard buckets
    levels: Optional[np.ndarray] = None


class Object3d:
    """One KITTI label row (kitti_data_utils.py:17-85)."""

    def __init__(self, line: str):
        parts = line.strip().split(" ")
        self.type = parts[0]
        self.truncation = float(parts[1])
        self.occlusion = int(float(parts[2]))
        self.alpha = float(parts[3])
        self.xmin, self.ymin, self.xmax, self.ymax = map(float, parts[4:8])
        self.box2d = np.array([self.xmin, self.ymin, self.xmax, self.ymax])
        self.h, self.w, self.l = map(float, parts[8:11])
        self.t = tuple(map(float, parts[11:14]))
        self.ry = float(parts[14])
        self.score = float(parts[15]) if len(parts) > 15 else -1.0
        self.cls_id = self.cls_type_to_id(self.type)
        self.level = self.get_obj_level()

    @staticmethod
    def cls_type_to_id(cls_type: str) -> int:
        return cnf.CLASS_NAME_TO_ID.get(cls_type, -99)

    def get_obj_level(self) -> int:
        """Easy/Moderate/Hard/Unknown (kitti_data_utils.py:54-68)."""
        height = float(self.box2d[3]) - float(self.box2d[1]) + 1
        if height >= 40 and self.truncation <= 0.15 and self.occlusion <= 0:
            return 1
        if height >= 25 and self.truncation <= 0.3 and self.occlusion <= 1:
            return 2
        if height >= 25 and self.truncation <= 0.5 and self.occlusion <= 2:
            return 3
        return 4

    def to_kitti_format(self) -> str:
        """(kitti_data_utils.py:80-85)"""
        return (
            f"{self.type} {self.truncation:.2f} {int(self.occlusion)} {self.alpha:.2f} "
            f"{self.box2d[0]:.2f} {self.box2d[1]:.2f} {self.box2d[2]:.2f} {self.box2d[3]:.2f} "
            f"{self.h:.2f} {self.w:.2f} {self.l:.2f} "
            f"{self.t[0]:.2f} {self.t[1]:.2f} {self.t[2]:.2f} {self.ry:.2f}"
        )


def read_label(label_path: str) -> List[Object3d]:
    with open(label_path) as f:
        return [Object3d(line) for line in f if line.strip()]


def parse_labels_camera(label_path: str) -> Tuple[np.ndarray, np.ndarray, bool]:
    """Label file -> ((N, 8) camera-frame rows [cat_id, x, y, z, h, w, l, ry],
    (N,) difficulty levels 1=Easy 2=Moderate 3=Hard 4=unknown), ignoring
    Tram/Misc (kitti_dataset.py:124-155). Levels use the Object3d
    2D-height/truncation/occlusion rule (kitti_data_utils.py:54-68) and feed
    the evaluator's Easy/Moderate/Hard buckets."""
    labels, levels = [], []
    for line in open(label_path):
        parts = line.split()
        if not parts:
            continue
        # class gate BEFORE any float parsing (reference behavior,
        # kitti_dataset.py:128-131): a truncated/garbage row whose first
        # token is not a known class is skipped, not a ValueError; a
        # known-class row with bad fields still raises loudly
        if parts[0] not in cnf.CLASS_NAME_TO_ID:
            continue
        obj = Object3d(line)
        if obj.cls_id <= -99:
            continue
        labels.append([obj.cls_id, *obj.t, obj.h, obj.w, obj.l, obj.ry])
        levels.append(obj.level)
    if not labels:
        return np.zeros((1, 8), np.float32), np.zeros((1,), np.int32), False
    return (
        np.asarray(labels, np.float32),
        np.asarray(levels, np.int32),
        True,
    )


class KittiDataset:
    """KITTI object-detection split reader (kitti_dataset.py:23-106).

    `__getitem__` returns a KittiSample with padded fixed-shape tensors.
    Augmentation runs here (host numpy); the range filter, BEV raster, flip,
    and target splatting run on device (ops/bev.py, ops/targets.py).
    """

    def __init__(
        self,
        dataset_dir: str,
        mode: str = "train",
        lidar_aug=None,
        hflip_prob: Optional[float] = None,
        num_samples: Optional[int] = None,
        max_points: int = cnf.MAX_POINTS_FILTERED,
        max_objects: int = 50,
        seed: int = 2020,
    ):
        assert mode in ("train", "val", "test"), f"Invalid mode: {mode}"
        self.mode = mode
        self.is_test = mode == "test"
        sub = "testing" if self.is_test else "training"
        self.image_dir = os.path.join(dataset_dir, sub, "image_2")
        self.lidar_dir = os.path.join(dataset_dir, sub, "velodyne")
        self.calib_dir = os.path.join(dataset_dir, sub, "calib")
        self.label_dir = os.path.join(dataset_dir, sub, "label_2")
        split_txt = os.path.join(dataset_dir, "ImageSets", f"{mode}.txt")
        self.sample_id_list = [int(x.strip()) for x in open(split_txt)]
        if num_samples is not None:
            self.sample_id_list = self.sample_id_list[:num_samples]
        self.lidar_aug = lidar_aug
        self.hflip_prob = hflip_prob or 0.0
        self.max_points = max_points
        self.max_objects = max_objects
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int):
        """Reseed augmentation per epoch (DistributedSampler.set_epoch
        analog for the sample-level rng); forwarded by the loader."""
        self.epoch = int(epoch)

    def _sample_rng(self, index: int) -> np.random.Generator:
        """Per-(seed, epoch, sample) generator: np.random.Generator is NOT
        thread-safe, and the async loader's worker threads call __getitem__
        concurrently — a shared generator would race and make the
        augmentation stream completion-order-dependent. A fresh
        deterministic generator per call is both thread-safe and identical
        between the sync and async paths."""
        return np.random.default_rng((self.seed, self.epoch, index))

    def __len__(self):
        return len(self.sample_id_list)

    def get_lidar(self, sample_id: int) -> np.ndarray:
        path = os.path.join(self.lidar_dir, f"{sample_id:06d}.bin")
        return np.fromfile(path, dtype=np.float32).reshape(-1, 4)

    def get_calib(self, sample_id: int) -> KittiCalibration:
        return KittiCalibration(os.path.join(self.calib_dir, f"{sample_id:06d}.txt"))

    def get_image_path(self, sample_id: int) -> str:
        return os.path.join(self.image_dir, f"{sample_id:06d}.png")

    def _pad_points(self, points: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Host range filter, then pad to the fixed budget."""
        return filter_and_pad_points(points, max_points=self.max_points)

    def _read_points_filtered(self, sample_id: int) -> Tuple[np.ndarray, np.ndarray]:
        """Read + range filter + pad when no augmentation needs the raw
        cloud: the native fused read (`native/preproc.cpp` streams the .bin;
        the raw scan is never materialised), or with SFA3D_TPU_NO_NATIVE the
        numpy read and its filter."""
        native.note_path()
        if native.enabled():
            path = os.path.join(self.lidar_dir, f"{sample_id:06d}.bin")
            return native.read_velodyne_filtered(path, self.max_points, cnf.boundary)
        return self._pad_points(self.get_lidar(sample_id))

    def _pad_labels(self, labels: np.ndarray) -> Tuple[np.ndarray, np.int32]:
        out = np.zeros((self.max_objects, 8), np.float32)
        n = min(len(labels), self.max_objects)
        out[:n] = labels[:n]
        return out, np.int32(n)

    def __getitem__(self, index: int) -> KittiSample:
        sample_id = int(self.sample_id_list[index])
        img_path = self.get_image_path(sample_id)

        if self.is_test:
            pts, valid = self._read_points_filtered(sample_id)
            return KittiSample(
                sample_id, pts, valid,
                np.zeros((self.max_objects, 8), np.float32), np.int32(0),
                img_path, None,
            )

        calib = self.get_calib(sample_id)
        label_path = os.path.join(self.label_dir, f"{sample_id:06d}.txt")
        cam_labels, levels, has_labels = parse_labels_camera(label_path)
        if has_labels:
            velo = np.asarray(
                camera_to_lidar_box(cam_labels[:, 1:], calib.V2C, calib.R0, calib.P2)
            )
            labels = np.concatenate([cam_labels[:, :1], velo], axis=1).astype(np.float32)
        else:
            labels = np.zeros((0, 8), np.float32)
            levels = np.zeros((0,), np.int32)

        rng = self._sample_rng(index)
        # augmentation needs the raw (unfiltered) cloud
        do_aug = self.lidar_aug is not None and len(labels)
        if do_aug:
            points = self.get_lidar(sample_id)
            points, boxes = self.lidar_aug(points, labels[:, 1:], rng)
            labels = np.concatenate([labels[:, :1], np.asarray(boxes, np.float32)], axis=1)

        # label boundary filter (get_filtered_lidar, kitti_data_utils.py:243-249)
        if len(labels):
            m = (
                (labels[:, 1] >= cnf.boundary["minX"]) & (labels[:, 1] < cnf.boundary["maxX"])
                & (labels[:, 2] >= cnf.boundary["minY"]) & (labels[:, 2] < cnf.boundary["maxY"])
                & (labels[:, 3] >= cnf.boundary["minZ"]) & (labels[:, 3] < cnf.boundary["maxZ"])
            )
            labels = labels[m]
            levels = levels[m]

        hflipped = bool(rng.random() < self.hflip_prob)
        if do_aug:
            pts, valid = self._pad_points(points)
        else:
            pts, valid = self._read_points_filtered(sample_id)
        lab, n_lab = self._pad_labels(labels)
        lev = np.zeros((self.max_objects,), np.int32)
        lev[: int(n_lab)] = levels[: int(n_lab)]
        sample = KittiSample(
            sample_id, pts, valid, lab, n_lab, img_path, calib, levels=lev
        )
        sample.hflipped = hflipped
        return sample


class DemoKittiDataset:
    """A KITTI raw drive (image_02/data, velodyne_points/data, 10-digit ids)
    for the `demo` and `track` CLIs. Item i is (points (max_points, 4),
    valid (max_points,), camera image path): the scan filtered to the union
    of the front and rear detection windows, then padded (the native fused
    read, or numpy with SFA3D_TPU_NO_NATIVE), so a raw ~120k-point scan is
    never truncated by azimuth."""

    def __init__(self, root_dir: str, max_points: int = cnf.MAX_POINTS):
        self.image_dir = os.path.join(root_dir, "image_02", "data")
        self.lidar_dir = os.path.join(root_dir, "velodyne_points", "data")
        self.sample_ids = sorted(
            int(os.path.splitext(f)[0]) for f in os.listdir(self.lidar_dir) if f.endswith(".bin")
        )
        self.max_points = max_points

    def __len__(self):
        return len(self.sample_ids)

    def __getitem__(self, index: int):
        sid = self.sample_ids[index]
        lidar_path = os.path.join(self.lidar_dir, f"{sid:010d}.bin")
        img_path = os.path.join(self.image_dir, f"{sid:010d}.png")
        union = dict(cnf.boundary, minX=cnf.boundary_back["minX"])
        native.note_path()
        if native.enabled():  # the fused native read
            out, valid = native.read_velodyne_filtered(lidar_path, self.max_points, union)
        else:
            points = np.fromfile(lidar_path, dtype=np.float32).reshape(-1, 4)
            out, valid = filter_and_pad_points(points, max_points=self.max_points, boundary=union)
        return out, valid, img_path
