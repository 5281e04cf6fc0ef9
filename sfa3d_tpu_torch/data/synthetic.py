"""Synthetic KITTI-like scenes, the port of `sfa3d_tpu/data/synthetic.py`
without cv2: ground plane + clutter + car-like box clusters with matching
labels (`synthetic_scene`, the same numpy draws as the JAX package, so one
seed gives the same scene byte for byte), camera frames rendered from the
scene (`render_camera_image`), a mini KITTI layout on disk
(`write_mini_kitti`, camera frames as PNG through `data/png.py`), a drive
of moving objects (`moving_scene_sequence`) and a raw-drive layout on disk
(`write_mini_drive`), and padded benchmark batches
(`synthetic_batch_points`).

The renderer draws what the JAX one draws with cv2, in numpy: the
velodyne-point dots are the same pixels, and each box's convex hull is
filled by a scanline test of pixel centres and outlined by the pixels
within 1 px of a hull edge (cv2's `fillConvexPoly` and 2-px `polylines`
rasterise the edges by their own rules, so pixels next to a hull edge may
differ). The labels' 2D boxes, truncation, occlusion and alpha come from
the scene geometry (`annotate_labels_camera`).
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from sfa3d_tpu_torch.config import kitti as cnf
from sfa3d_tpu_torch.geometry.transforms import lidar_to_camera_box
from sfa3d_tpu_torch.viz.draw import compute_box_3d, project_to_image


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


def convex_hull(points: np.ndarray) -> np.ndarray:
    """(N, 2) integer points -> the convex hull's vertices (M, 2) int64,
    counter-clockwise in image axes (Andrew's monotone chain; collinear
    points dropped)."""
    pts = sorted({(int(x), int(y)) for x, y in np.asarray(points)})
    if len(pts) <= 2:
        return np.asarray(pts, np.int64).reshape(-1, 2)

    def cross(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    lower, upper = [], []
    for p in pts:
        while len(lower) >= 2 and cross(lower[-2], lower[-1], p) <= 0:
            lower.pop()
        lower.append(p)
    for p in reversed(pts):
        while len(upper) >= 2 and cross(upper[-2], upper[-1], p) <= 0:
            upper.pop()
        upper.append(p)
    return np.asarray(lower[:-1] + upper[:-1], np.int64)


def _hull_window(img: np.ndarray, hull: np.ndarray, margin: int):
    """The pixel rows and columns of `img` within `margin` of the hull's
    bounding box, as (ys (h, 1), xs (1, w), row slice, column slice), or
    None when the box lies outside the image."""
    h, w = img.shape[:2]
    x0, y0 = max(int(hull[:, 0].min()) - margin, 0), max(int(hull[:, 1].min()) - margin, 0)
    x1, y1 = min(int(hull[:, 0].max()) + margin, w - 1), min(int(hull[:, 1].max()) + margin, h - 1)
    if x0 > x1 or y0 > y1:
        return None
    ys = np.arange(y0, y1 + 1, dtype=np.int64)[:, None]
    xs = np.arange(x0, x1 + 1, dtype=np.int64)[None, :]
    return ys, xs, slice(y0, y1 + 1), slice(x0, x1 + 1)


def fill_convex(img: np.ndarray, hull: np.ndarray, color) -> None:
    """Paint every pixel whose centre lies inside or on the convex polygon
    `hull` (integer vertices, either orientation) with `color`, in place."""
    win = _hull_window(img, hull, 0)
    if win is None or len(hull) < 3:
        return
    ys, xs, rows, cols = win
    area2 = sum(int(hull[i, 0]) * int(hull[i - 1, 1]) - int(hull[i - 1, 0]) * int(hull[i, 1])
                for i in range(len(hull)))
    sign = 1 if area2 <= 0 else -1  # inside is left of each edge for one orientation
    inside = np.ones((ys.shape[0], xs.shape[1]), bool)
    for i in range(len(hull)):
        (ax, ay), (bx, by) = hull[i - 1], hull[i]
        inside &= sign * ((bx - ax) * (ys - ay) - (by - ay) * (xs - ax)) >= 0
    img[rows, cols][inside] = color


def outline_convex(img: np.ndarray, hull: np.ndarray, color, half_width: float = 1.0) -> None:
    """Paint the pixels whose centre lies within `half_width` of an edge of
    the closed polygon `hull` (a 2-px outline at the default), in place."""
    win = _hull_window(img, hull, int(np.ceil(half_width)))
    if win is None:
        return
    ys, xs, rows, cols = win
    on = np.zeros((ys.shape[0], xs.shape[1]), bool)
    for i in range(len(hull)):
        (ax, ay), (bx, by) = hull[i - 1].astype(np.float64), hull[i].astype(np.float64)
        dx, dy = bx - ax, by - ay
        length2 = dx * dx + dy * dy
        t = np.clip(((xs - ax) * dx + (ys - ay) * dy) / length2, 0.0, 1.0) if length2 else 0.0
        on |= (xs - ax - t * dx) ** 2 + (ys - ay - t * dy) ** 2 <= half_width * half_width
    img[rows, cols][on] = color


def render_camera_image(points: np.ndarray, labels: np.ndarray,
                        P: np.ndarray, hw: Tuple[int, int] = (375, 1242)) -> np.ndarray:
    """A synthetic camera frame consistent with the scene, (H, W, 3) RGB
    uint8: velodyne points become intensity-shaded 2 x 2 dots and each
    labelled box a filled class-coloured convex hull with a bright 2-px
    outline, painted far to near. `P` is a 3 x 4 rect-frame projection (P2
    for the left camera, a P3 with the stereo baseline for the right). The
    JAX package's renderer returns the same frame in BGR."""
    h, w = hw
    P = np.asarray(P, np.float64).reshape(3, 4)
    img = np.full((h, w, 3), 28, np.uint8)

    V2C = np.asarray(cnf.Tr_velo_to_cam[:3], np.float64).reshape(3, 4)
    R0 = np.asarray(cnf.R0[:3, :3], np.float64)
    rect = (R0 @ (V2C[:, :3] @ points[:, :3].T.astype(np.float64) + V2C[:, 3:4])).T
    infront = rect[:, 2] > 1.0
    rect, inten = rect[infront], points[infront, 3]
    uvz = (P[:, :3] @ rect.T + P[:, 3:4]).T
    uv = uvz[:, :2] / uvz[:, 2:3]
    ui = np.round(uv[:, 0]).astype(np.int64)
    vi = np.round(uv[:, 1]).astype(np.int64)
    inb = (ui >= 0) & (ui < w - 1) & (vi >= 0) & (vi < h - 1)
    ui, vi = ui[inb], vi[inb]
    shade = (70 + 180 * np.clip(inten[inb], 0, 1)).astype(np.uint8)
    for du in (0, 1):
        for dv in (0, 1):
            img[vi + dv, ui + du] = shade[:, None]

    rgb_colors = {0: (230, 80, 80), 1: (90, 200, 90), 2: (60, 160, 230)}
    if len(labels):
        cam = np.asarray(lidar_to_camera_box(labels[:, 1:8].astype(np.float64)))
        for j in np.argsort(-cam[:, 2]):  # far to near: near boxes cover far ones
            x, y, z, bh, bw, bl, ry = cam[j]
            corners = compute_box_3d((bh, bw, bl), (x, y, z), ry)
            if (corners[:, 2] <= 1.0).any():
                continue
            hull = convex_hull(project_to_image(corners, P))
            color = rgb_colors[int(labels[j, 0]) % 3]
            fill_convex(img, hull, color)
            outline_convex(img, hull, tuple(min(255, c + 90) for c in color))
    return img


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
                     cameras: bool = True,
                     range_falloff: float = 0.0) -> str:
    """Write a tiny KITTI-layout dataset under `root` from synthetic scenes:
    velodyne .bin, calib .txt, label_2 .txt, ImageSets and, with `cameras`,
    the stereo camera frames image_2 / image_3 as PNG (image_3 through a P3
    with the 0.54 m KITTI baseline). `splits` is a tuple of split names that
    all list frames 0..n_frames-1, or a dict {split: range of frame ids}."""
    from sfa3d_tpu_torch.data.png import write_png_rgb

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
            if cameras:
                for cam_dir, P in (("image_2", P2), ("image_3", P3)):
                    write_png_rgb(os.path.join(root, sub, cam_dir, f"{i:06d}.png"),
                                  render_camera_image(points, labels, P))
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


def moving_scene_sequence(
    n_frames: int,
    seed: int = 0,
    n_objects: int = 6,
    points_per_object: int = 800,
    n_ground: int = 20000,
    n_clutter: int = 6000,
):
    """A drive in which the same objects move at constant per-object
    velocities (0.05-1.2 m a frame by class, each box facing its motion)
    while ground and clutter are drawn anew each frame: the input the 3D
    tracker needs, where frame t + 1 is frame t moved. An object reverses
    a velocity component when it would leave x in (6, 44) or y in (-19, 19),
    so every id stays observable. The JAX package's rng call sequence, so
    a seed gives the same frames in both packages.

    Returns a list of (points (N, 4), labels (M, 8), gt_ids (M,)) per
    frame; labels store -yaw, as `synthetic_scene`'s do."""
    rng = np.random.default_rng(seed)
    dims_by_class = {0: (1.76, 0.66, 0.84), 1: (1.52, 1.63, 3.88), 2: (1.73, 0.60, 1.76)}
    # per-frame (0.1 s at KITTI's 10 Hz) speeds: walking pedestrians, urban
    # cars, cyclists; a frame's displacement stays within the box footprint,
    # which IoU-gated association needs
    speed_by_class = {0: (0.05, 0.15), 1: (0.3, 1.2), 2: (0.2, 0.6)}
    objs = []
    for oid in range(n_objects):
        cls = int(rng.integers(0, 3))
        h, w, l = dims_by_class[cls]
        h *= rng.uniform(0.9, 1.1)
        w *= rng.uniform(0.9, 1.1)
        l *= rng.uniform(0.9, 1.1)
        x, y = rng.uniform(10, 40), rng.uniform(-15, 15)
        theta = rng.uniform(-np.pi, np.pi)
        speed = rng.uniform(*speed_by_class[cls])
        objs.append(dict(oid=oid, cls=cls, h=h, w=w, l=l, x=x, y=y,
                         vx=speed * np.cos(theta), vy=speed * np.sin(theta)))

    frames = []
    for _t in range(n_frames):
        ground = np.empty((n_ground, 4), np.float32)
        r = np.sqrt(rng.uniform(0.02, 1.0, n_ground))
        th = rng.uniform(-np.pi, np.pi, n_ground)
        ground[:, 0] = r * 60.0 * np.abs(np.cos(th))
        ground[:, 1] = r * 40.0 * np.sin(th)
        ground[:, 2] = rng.normal(-1.73, 0.05, n_ground)
        ground[:, 3] = rng.uniform(0.0, 0.4, n_ground)
        clutter = np.empty((n_clutter, 4), np.float32)
        clutter[:, 0] = rng.uniform(-10, 60, n_clutter)
        clutter[:, 1] = rng.uniform(-30, 30, n_clutter)
        clutter[:, 2] = rng.uniform(-1.7, 1.2, n_clutter)
        clutter[:, 3] = rng.uniform(0, 1, n_clutter)

        pts, labels, ids = [ground, clutter], [], []
        for o in objs:
            yaw = np.arctan2(o["vy"], o["vx"])  # face the motion
            pts.append(_box_surface_points(rng, o["h"], o["w"], o["l"], o["x"], o["y"], -1.73, yaw,
                                           points_per_object))
            labels.append([o["cls"], o["x"], o["y"], -1.73, o["h"], o["w"], o["l"], -yaw])
            ids.append(o["oid"])
            # advance, bouncing off the walls of the observable core
            o["x"] += o["vx"]
            o["y"] += o["vy"]
            if not (6.0 < o["x"] < 44.0):
                o["vx"] *= -1.0
                o["x"] += 2.0 * o["vx"]
            if not (-19.0 < o["y"] < 19.0):
                o["vy"] *= -1.0
                o["y"] += 2.0 * o["vy"]
        points = np.concatenate(pts).astype(np.float32)
        rng.shuffle(points, axis=0)
        frames.append((points, np.asarray(labels, np.float32), np.asarray(ids, np.int32)))
    return frames


def write_mini_drive(root: str, n_frames: int = 2, seed: int = 0,
                     cameras: bool = True, motion: bool = False) -> str:
    """A tiny KITTI raw-drive layout (image_02/data + velodyne_points/data
    with 10-digit ids) from synthetic scenes, for the `demo` and `track`
    CLIs. Each scan is a front scene plus an x-mirrored rear scene, so
    `demo --two_sides` finds content in both windows; `motion=True` takes
    the front scenes from `moving_scene_sequence` (the same objects moving)
    so that `track` has identities to follow. The scans are byte for byte
    the JAX writer's; the camera frames are PNGs of `render_camera_image`."""
    from sfa3d_tpu_torch.data.png import write_png_rgb

    os.makedirs(os.path.join(root, "image_02", "data"), exist_ok=True)
    os.makedirs(os.path.join(root, "velodyne_points", "data"), exist_ok=True)
    P2 = np.asarray(cnf.P2[:3], np.float64).reshape(3, 4)
    moving = moving_scene_sequence(n_frames, seed=seed) if motion else None
    for i in range(n_frames):
        if moving is not None:
            front, labels, _ids = moving[i]
        else:
            front, labels = synthetic_scene(seed=seed + i)
        back, _ = synthetic_scene(seed=seed + i + 500)
        back = back.copy()
        back[:, 0] *= -1.0  # mirrored into the rear window (boundary_back)
        scan = np.concatenate([front, back]).astype(np.float32)
        scan.tofile(os.path.join(root, "velodyne_points", "data", f"{i:010d}.bin"))
        if cameras:
            write_png_rgb(os.path.join(root, "image_02", "data", f"{i:010d}.png"),
                          render_camera_image(front, labels, P2))
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
