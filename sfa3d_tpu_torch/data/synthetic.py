"""Synthetic KITTI-like scenes, the port of `sfa3d_tpu/data/synthetic.py`
without cv2: ground plane + clutter + car-like box clusters with matching
labels (`synthetic_scene`, the same numpy draws as the JAX package, so one
seed gives the same scene byte for byte), a mini KITTI layout on disk
(`write_mini_kitti`) and padded benchmark batches (`synthetic_batch_points`).

`write_mini_kitti` writes no camera frames: the JAX package renders them
with cv2 and skips them when cv2 is absent, which is what the port does
(training never reads them). The labels' 2D boxes, truncation, occlusion
and alpha still come from the scene geometry (`annotate_labels_camera`).
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from sfa3d_tpu_torch.config import kitti as cnf
from sfa3d_tpu_torch.geometry.transforms import lidar_to_camera_box


def _roty(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def compute_box_3d(dim, location, ry) -> np.ndarray:
    """Camera-frame 8 corners of a box whose origin is its bottom centre."""
    h, w, l = dim
    x = [l / 2, l / 2, -l / 2, -l / 2, l / 2, l / 2, -l / 2, -l / 2]
    y = [0, 0, 0, 0, -h, -h, -h, -h]
    z = [w / 2, -w / 2, -w / 2, w / 2, w / 2, -w / 2, -w / 2, w / 2]
    corners = _roty(ry) @ np.array([x, y, z], dtype=np.float32)
    return (corners + np.asarray(location, np.float32).reshape(3, 1)).T


def project_to_image(pts_3d: np.ndarray, P: np.ndarray) -> np.ndarray:
    """(N, 3) camera points -> (N, 2) int32 pixels through a 3x4 P."""
    homo = np.concatenate([pts_3d, np.ones((len(pts_3d), 1), np.float32)], axis=1)
    uv = (np.asarray(P) @ homo.T).T
    return (uv[:, :2] / uv[:, 2:]).astype(np.int32)


def _box_surface_points(rng, h, w, l, x, y, z, yaw, m):
    """Surface-ish samples of one box in the velodyne frame, (m, 4) f32.
    Keeps the JAX package's exact rng call sequence, so a seed draws the
    same scene in both packages."""
    local = np.empty((m, 3), np.float32)
    local[:, 0] = rng.uniform(-l / 2, l / 2, m)
    local[:, 1] = rng.uniform(-w / 2, w / 2, m)
    local[:, 2] = rng.uniform(0, h, m)
    face = rng.integers(0, 3, m)
    local[face == 0, 0] = np.sign(local[face == 0, 0]) * l / 2
    local[face == 1, 1] = np.sign(local[face == 1, 1]) * w / 2
    local[face == 2, 2] = h * (local[face == 2, 2] > h / 2)
    # ~2 cm z noise (Velodyne-class range accuracy): real sensors never
    # emit bit-identical heights; the exact-duplicate z values the
    # face-pinning creates would otherwise make raster tie-breaking
    # (reference: exact-max-z point; ours: max intensity within the
    # 0.5 mm quantization bucket) visible on hundreds of pixels per frame
    local[:, 2] += rng.uniform(-0.02, 0.02, m)
    c, s = np.cos(yaw), np.sin(yaw)
    pts = np.empty((m, 4), np.float32)
    pts[:, 0] = c * local[:, 0] - s * local[:, 1] + x
    pts[:, 1] = s * local[:, 0] + c * local[:, 1] + y
    pts[:, 2] = local[:, 2] + z
    # Front/back asymmetry (like real vehicles): intensity rises toward
    # the local +x (front) face. Without it a box's point cloud is
    # IDENTICAL under yaw -> yaw+pi, the (sin, cos) direction targets
    # for visually-equal scenes contradict each other, and a trained
    # direction head collapses to ~0 (= random yaw; found by the round-3
    # generalization run: centers/dims/class learned, yaw uniform).
    frontness = local[:, 0] / l + 0.5  # 0 at rear face, 1 at front
    pts[:, 3] = np.clip(
        rng.uniform(0.15, 0.35, m) + 0.55 * frontness, 0.0, 1.0
    )
    return pts


def synthetic_scene(
    seed: int = 0,
    n_ground: int = 20000,
    n_clutter: int = 6000,
    n_objects: int = 12,
    points_per_object: int = 800,
    range_falloff: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray]:
    # Defaults sized so the front-range filter keeps ~25-30k points —
    # matching real KITTI scans (raw ~120k, in-range 15-25k) and fitting the
    # MAX_POINTS_FILTERED padding budget without silent truncation.
    """Returns (points (N,4) float32 velodyne, labels (M,8) float32 rows
    [cls, x, y, z, h, w, l, yaw(velodyne rz)]).

    range_falloff > 0 scales each object's point count by the LiDAR
    1/r^2 return density, full density at r = range_falloff meters
    (floor 64 points) — far objects then carry genuinely fewer returns,
    so the KITTI Easy/Moderate/Hard buckets discriminate on this data.
    OFF by default: enabling it changes the rng call sequence, and the
    default scenes are pinned byte-for-byte by seeds recorded in
    parity/bench artifacts."""
    rng = np.random.default_rng(seed)

    ground = np.empty((n_ground, 4), np.float32)
    r = np.sqrt(rng.uniform(0.02, 1.0, n_ground))  # radial density falloff
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

    dims_by_class = {
        0: (1.76, 0.66, 0.84),  # Pedestrian h,w,l
        1: (1.52, 1.63, 3.88),  # Car
        2: (1.73, 0.60, 1.76),  # Cyclist
    }
    obj_points = []
    labels = []
    for _ in range(n_objects):
        cls = int(rng.integers(0, 3))
        h, w, l = dims_by_class[cls]
        h *= rng.uniform(0.9, 1.1)
        w *= rng.uniform(0.9, 1.1)
        l *= rng.uniform(0.9, 1.1)
        x = rng.uniform(5, 45)
        y = rng.uniform(-20, 20)
        z = -1.73
        yaw = rng.uniform(-np.pi, np.pi)
        m = points_per_object
        if range_falloff > 0.0:
            r = float(np.hypot(x, y))
            m = max(64, int(points_per_object
                            * min(1.0, (range_falloff / r) ** 2)))
        obj_points.append(
            _box_surface_points(rng, h, w, l, x, y, z, yaw, m)
        )
        # label yaw convention: build_targets negates (kitti_dataset.py:181),
        # so store -yaw to make the heatmap target yaw equal `yaw`.
        labels.append([cls, x, y, z, h, w, l, -yaw])

    points = np.concatenate([ground, clutter] + obj_points).astype(np.float32)
    rng.shuffle(points, axis=0)
    return points, np.asarray(labels, np.float32)


def annotate_labels_camera(labels: np.ndarray, P: np.ndarray,
                           hw: Tuple[int, int] = (375, 1242),
                           grid: int = 4):
    """Derive the KITTI annotation fields the difficulty rules read
    (kitti_data_utils.py:54-68) from the scene geometry, per labeled box:

    - 2D bbox: the image-clipped bounds of the projected 3D corners (its
      height drives the Easy>=40px / Moderate,Hard>=25px rule);
    - truncation: the fraction of the full projected bbox clipped away by
      the image boundary (KITTI's "leaving image boundaries" fraction);
    - occlusion: 0/1/2 from the fraction of the box's image footprint
      covered by NEARER boxes, measured on a `grid`-px occupancy raster
      painted near-to-far (matches render_camera_image's painter order);
    - alpha: the observation angle ry - atan2(x_cam, z_cam).

    Returns a list of dicts {alpha, bbox (4,), truncation, occlusion};
    boxes fully outside the image get truncation 1.0 (level 4 territory).
    """
    h_img, w_img = hw
    P = np.asarray(P, np.float64).reshape(3, 4)
    cam = np.asarray(lidar_to_camera_box(labels[:, 1:8].astype(np.float64)))
    gh, gw = (h_img + grid - 1) // grid, (w_img + grid - 1) // grid
    occupied = np.zeros((gh, gw), bool)

    out = [None] * len(cam)
    # near-to-far: each box's occlusion reads only NEARER boxes' footprint
    for j in np.argsort(cam[:, 2]):
        x, y, z, bh, bw, bl, ry = cam[j]
        corners = compute_box_3d((bh, bw, bl), (x, y, z), ry)
        alpha = float(ry - np.arctan2(x, z))
        if (corners[:, 2] <= 0.1).any():
            # clipped by the image plane: no stable projection
            out[j] = dict(alpha=alpha, bbox=np.zeros(4), truncation=1.0,
                          occlusion=0)
            continue
        uv = project_to_image(corners, P)
        x1f, y1f = uv[:, 0].min(), uv[:, 1].min()
        x2f, y2f = uv[:, 0].max(), uv[:, 1].max()
        x1, y1 = max(x1f, 0.0), max(y1f, 0.0)
        x2, y2 = min(x2f, w_img - 1.0), min(y2f, h_img - 1.0)
        full = (x2f - x1f) * (y2f - y1f)
        vis = max(x2 - x1, 0.0) * max(y2 - y1, 0.0)
        trunc = float(1.0 - vis / full) if full > 0 else 1.0
        if vis <= 0.0:
            out[j] = dict(alpha=alpha, bbox=np.zeros(4), truncation=1.0,
                          occlusion=0)
            continue
        gx1, gy1 = int(x1) // grid, int(y1) // grid
        gx2, gy2 = int(x2) // grid + 1, int(y2) // grid + 1
        cells = occupied[gy1:gy2, gx1:gx2]
        occ_frac = float(cells.mean()) if cells.size else 0.0
        occlusion = 0 if occ_frac < 0.15 else (1 if occ_frac < 0.5 else 2)
        cells[:] = True  # paint for the boxes behind this one
        out[j] = dict(alpha=alpha, bbox=np.array([x1, y1, x2, y2]),
                      truncation=trunc, occlusion=occlusion)
    return out


def write_mini_kitti(root: str, n_frames: int = 4, seed: int = 0,
                     splits=("train", "val", "test"),
                     range_falloff: float = 0.0) -> str:
    """Write a tiny KITTI-layout dataset under `root` from synthetic scenes:
    velodyne .bin, calib .txt, label_2 .txt and ImageSets (no camera frames,
    see the module docstring). `splits` is a tuple of split names that all
    list frames 0..n_frames-1, or a dict {split: range of frame ids}."""
    for sub in ("training", "testing"):
        for d in ("velodyne", "calib", "label_2", "image_2", "image_3"):
            os.makedirs(os.path.join(root, sub, d), exist_ok=True)
    os.makedirs(os.path.join(root, "ImageSets"), exist_ok=True)

    names = {0: "Pedestrian", 1: "Car", 2: "Cyclist"}
    P2 = np.asarray(cnf.P2[:3], np.float64).reshape(3, 4)
    P3 = P2.copy()
    P3[0, 3] -= P2[0, 0] * STEREO_BASELINE_M
    R0 = np.asarray(cnf.R0[:3, :3]).reshape(-1)
    V2C = np.asarray(cnf.Tr_velo_to_cam[:3]).reshape(-1)
    zeros12 = " ".join(["0"] * 12)
    calib_lines = [f"{key}: " + " ".join(f"{v:.12e}" for v in vals)
                   for key, vals in [("P0", P2.reshape(-1)), ("P1", P2.reshape(-1)),
                                     ("P2", P2.reshape(-1)), ("P3", P3.reshape(-1))]]
    calib_lines.insert(4, "R0_rect: " + " ".join(f"{v:.12e}" for v in R0))
    calib_lines.append("Tr_velo_to_cam: " + " ".join(f"{v:.12e}" for v in V2C))
    calib_lines.append(f"Tr_imu_to_velo: {zeros12}")
    calib_txt = "\n".join(calib_lines) + "\n"

    for sub in ("training", "testing"):
        for i in range(n_frames):
            points, labels = synthetic_scene(
                seed=seed + i + (1000 if sub == "testing" else 0), range_falloff=range_falloff)
            points.tofile(os.path.join(root, sub, "velodyne", f"{i:06d}.bin"))
            with open(os.path.join(root, sub, "calib", f"{i:06d}.txt"), "w") as f:
                f.write(calib_txt)
            if sub == "training":
                anns = annotate_labels_camera(labels, P2)
                cam = np.asarray(lidar_to_camera_box(labels[:, 1:]))
                with open(os.path.join(root, sub, "label_2", f"{i:06d}.txt"), "w") as f:
                    for row, c, ann in zip(cam, labels[:, 0].astype(int), anns):
                        x, y, z, h, w, l, ry = row
                        bx1, by1, bx2, by2 = ann["bbox"]
                        f.write(
                            f"{names[int(c)]} {ann['truncation']:.2f} "
                            f"{ann['occlusion']} {ann['alpha']:.2f} "
                            f"{bx1:.2f} {by1:.2f} {bx2:.2f} {by2:.2f} "
                            f"{h:.2f} {w:.2f} {l:.2f} {x:.2f} {y:.2f} {z:.2f} {ry:.2f}\n"
                        )
    if isinstance(splits, dict):
        for split, id_range in splits.items():
            with open(os.path.join(root, "ImageSets", f"{split}.txt"), "w") as f:
                f.write("\n".join(f"{i:06d}" for i in id_range) + "\n")
    else:
        ids = "\n".join(f"{i:06d}" for i in range(n_frames)) + "\n"
        for split in splits:
            with open(os.path.join(root, "ImageSets", f"{split}.txt"), "w") as f:
                f.write(ids)
    return root


# KITTI colour-pair stereo baseline (m); P3's tx = P2's tx - fx * baseline
STEREO_BASELINE_M = 0.54


def synthetic_batch_points(batch: int, max_points: int = cnf.MAX_POINTS,
                           seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """(B, N, 4) padded raw scans + (B, N) masks, frame b from seed + b."""
    from sfa3d_tpu_torch.ops.bev import _pad_raw

    pts = np.zeros((batch, max_points, 4), np.float32)
    valid = np.zeros((batch, max_points), bool)
    for b in range(batch):
        scan, _ = synthetic_scene(seed=seed + b)
        pts[b], valid[b] = _pad_raw(scan, max_points)
    return pts, valid
