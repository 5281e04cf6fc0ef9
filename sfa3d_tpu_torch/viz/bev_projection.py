"""Dataset-agnostic 3D box -> BEV projection and its drawing, the
counterpart of `sfa3d_tpu/viz/bev_projection.py`.

`get_3d_box_corners` and `project_box_to_bev` are the JAX module's. The JAX
`draw_bev_boxes` returns a matplotlib figure; the port has no matplotlib,
so its `draw_bev_boxes` draws the same plot into a uint8 BGR image of the
figure's size (10 x 10 in at 120 dpi: 1200 x 1200 px) with
`viz/raster.py`: the cloud scattered one pixel per point, coloured by z
through matplotlib's viridis table (kept here as a constant) at alpha 0.5,
the boxes' bottom polygons in red, their heading arrows in lime, the axes
with ticks, labels and the title. It returns the image and writes it as a
PNG when `save_path` is given.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np

from sfa3d_tpu_torch.geometry.se3 import SE3
from sfa3d_tpu_torch.geometry.transforms import center_to_corner_box3d
from sfa3d_tpu_torch.viz import raster

# matplotlib's viridis as a 256 x 3 BGR table, 768 bytes as hex
_VIRIDIS_HEX = (
    "5401445602445704455905455a07465c08465d0a465e0b46600d47610e47631047641147651347671448681648691748"
    "6a18486c1a486d1b486e1c486f1d48701f487120487321487423487524487625487726487828487929487a2a477a2c47"
    "7b2d477c2e477d2f477e30467e32467f3346803446813545813745823845833944833a44843b44843d43853e43853f42"
    "86404286414287424187444188454088464088473f89483f89493e894a3e8a4c3e8a4d3d8a4e3d8a4f3c8b503c8b513b"
    "8b523b8b533a8c543a8c55398c56398c58388c59388c5a378d5b378d5c368d5d368d5e358d5f358d60348d61348d6233"
    "8d63338e64328e65328e66318e67318e68318e69308e6a308e6b2f8e6c2f8e6d2e8e6e2e8e6f2e8e702d8e712d8e712c"
    "8e722c8e732c8e742b8e752b8e762a8e772a8e782a8e79298e7a298e7b298e7c288e7d288e7e278e7f278e80278e8126"
    "8e82268e82268e83258e84258e85258e86248e87248e88238e89238d8a238d8b228d8c228d8d228d8e218d8f218d9021"
    "8c91218c92208c92208c93208c941f8b951f8b961f8b971f8b981f8a991f8a9a1f8a9b1e899c1e899d1e899e1f889f1f"
    "88a01f88a11f87a11f87a21f86a32086a42085a52185a62185a72284a82283a92383aa2482ab2582ac2581ad2681ad27"
    "80ae287faf297fb02a7eb12c7db22d7cb32e7cb42f7bb5317ab63279b63479b73578b83777b93876ba3a75bb3b74bc3d"
    "73bc3f72bd4071be4270bf446fc0466ec1486dc14a6cc24c6bc34e6ac45069c55268c55467c65665c75864c85a63c85c"
    "62c95e60ca605fcb635ecb655ccc675bcd695acd6c58ce6e57cf7056d07354d07553d17751d17a50d27c4ed37f4dd381"
    "4bd48449d58648d58946d68b45d68e43d79041d79340d8953ed8983cd99b3bd99d39daa037daa236dba534dba832dcaa"
    "30dcad2fddb02dddb22bdeb529deb828deba26dfbd25dfc023dfc221e0c520e0c81fe1ca1de1cd1ce1d01be2d21ae2d5"
    "19e2d819e3da18e3dd18e3df18e4e219e4e519e4e71ae5ea1be5ec1ce5ef1de5f11ee6f420e6f621e6f823e7fb25e7fd"
)
VIRIDIS_BGR = np.frombuffer(bytes.fromhex(_VIRIDIS_HEX), np.uint8).reshape(256, 3)

FIGURE_PX = 1200  # 10 in at 120 dpi
_MARGINS = (150, 60, 90, 130)  # left, right, top, bottom, px
_RED, _LIME, _BLACK = (0, 0, 255), (0, 255, 0), (0, 0, 0)


def get_3d_box_corners(box7: np.ndarray) -> np.ndarray:
    """(7,) [x, y, z, h, w, l, yaw] z-up box -> (8, 3) corners."""
    return np.asarray(center_to_corner_box3d(np.asarray(box7, np.float64)[None]))[0]


def project_box_to_bev(corners3d: np.ndarray) -> np.ndarray:
    """(8, 3) -> (4, 2) bottom-face BEV polygon (drop z)."""
    return np.asarray(corners3d)[:4, :2]


def bev_plot_transform(points: np.ndarray, boxes7: Sequence[np.ndarray],
                       boundary: Optional[Dict[str, float]] = None):
    """The plot's data -> pixel map: (to_pixels, (x0, y0, x1, y1)) with
    `to_pixels((N, 2) metres) -> (N, 2) float pixels` (x right, y up, one
    scale for both axes) and the plot area's pixel box. The range is
    `boundary`'s, else the points' and polygons' with a 5 % margin."""
    if boundary:
        lo = np.array([boundary["minX"], boundary["minY"]], np.float64)
        hi = np.array([boundary["maxX"], boundary["maxY"]], np.float64)
    else:
        xy = [np.asarray(points, np.float64)[:, :2]]
        xy += [project_box_to_bev(get_3d_box_corners(b)) for b in boxes7]
        xy = np.concatenate(xy)
        lo, hi = xy.min(0), xy.max(0)
        pad = 0.05 * np.maximum(hi - lo, 1e-6)
        lo, hi = lo - pad, hi + pad
    left, right, top, bottom = _MARGINS
    aw, ah = FIGURE_PX - left - right, FIGURE_PX - top - bottom
    scale = min(aw / (hi[0] - lo[0]), ah / (hi[1] - lo[1]))
    pw, ph = (hi[0] - lo[0]) * scale, (hi[1] - lo[1]) * scale
    x0, y0 = left + (aw - pw) / 2.0, top + (ah - ph) / 2.0

    def to_pixels(xy):
        xy = np.asarray(xy, np.float64).reshape(-1, 2)
        return np.stack([x0 + (xy[:, 0] - lo[0]) * scale, y0 + ph - (xy[:, 1] - lo[1]) * scale], axis=1)

    box = (int(round(x0)), int(round(y0)), int(round(x0 + pw)), int(round(y0 + ph)))
    return to_pixels, box, (lo, hi)


def _ticks(lo: float, hi: float):
    """About six round tick values within [lo, hi]."""
    raw = (hi - lo) / 6.0
    mag = 10.0 ** math.floor(math.log10(raw))
    step = min((m * mag for m in (1, 2, 2.5, 5, 10) if m * mag >= raw), default=10 * mag)
    first = math.ceil(lo / step - 1e-9) * step
    return [first + k * step for k in range(int((hi - first) / step + 1e-9) + 1)]


def _text_centered(img, text, cx, y, scale, thick=1):
    (w, _), _ = raster.get_text_size(text, raster.FONT_HERSHEY_SIMPLEX, scale, thick)
    raster.put_text(img, text, (int(cx - w / 2), int(y)), raster.FONT_HERSHEY_SIMPLEX, scale, _BLACK, thick)


def draw_bev_boxes(
    points: np.ndarray,
    boxes7: Sequence[np.ndarray],
    save_path: Optional[str] = None,
    boundary: Optional[Dict[str, float]] = None,
    title: str = "BEV projection",
) -> np.ndarray:
    """Scatter the cloud and draw the box polygons with heading arrows;
    returns the (1200, 1200, 3) uint8 BGR image (and writes it as a PNG to
    `save_path`)."""
    pts = np.asarray(points, np.float64)
    img = np.full((FIGURE_PX, FIGURE_PX, 3), 255, np.uint8)
    to_pixels, (x0, y0, x1, y1), (lo, hi) = bev_plot_transform(pts, boxes7, boundary)
    area = img[y0:y1 + 1, x0:x1 + 1]  # drawing in the view clips to the axes
    if len(pts):
        z = pts[:, 2]
        span = z.max() - z.min()
        level = np.zeros(len(z), np.int64) if span <= 0 else np.rint((z - z.min()) / span * 255).astype(np.int64)
        uv = np.floor(to_pixels(pts[:, :2])).astype(np.int64) - [x0, y0]
        keep = (uv[:, 0] >= 0) & (uv[:, 0] < area.shape[1]) & (uv[:, 1] >= 0) & (uv[:, 1] < area.shape[0])
        uv, level = uv[keep], level[keep]
        bg = area[uv[:, 1], uv[:, 0]].astype(np.int32)
        area[uv[:, 1], uv[:, 0]] = ((bg + VIRIDIS_BGR[level].astype(np.int32) + 1) // 2).astype(np.uint8)
    for box in boxes7:
        poly = project_box_to_bev(get_3d_box_corners(box))
        corners = np.rint(to_pixels(poly)).astype(np.int64) - [x0, y0]
        raster.polylines(area, [corners.reshape(-1, 1, 2)], True, _RED, 2)
        cx, cy, yaw = float(box[0]), float(box[1]), float(box[6])
        d = np.array([math.cos(yaw), math.sin(yaw)])
        n = np.array([-d[1], d[0]])
        tail, tip = np.array([cx, cy]), np.array([cx, cy]) + 1.5 * d
        head = [tip + 0.2 * n, tip + 0.6 * d, tip - 0.2 * n]
        a, b = np.rint(to_pixels([tail, tip])).astype(np.int64) - [x0, y0]
        raster.line(area, tuple(a), tuple(b), _LIME, 2)
        tri = np.rint(to_pixels(head)).astype(np.int64) - [x0, y0]
        raster.fill_convex_poly(area, tri, _LIME)
    raster.rectangle(img, (x0, y0), (x1, y1), _BLACK, 1)
    for v in _ticks(lo[0], hi[0]):
        px = int(round(to_pixels([[v, lo[1]]])[0, 0]))
        raster.line(img, (px, y1), (px, y1 + 7), _BLACK, 1)
        _text_centered(img, f"{v:g}", px, y1 + 28, 0.5)
    for v in _ticks(lo[1], hi[1]):
        py = int(round(to_pixels([[lo[0], v]])[0, 1]))
        raster.line(img, (x0 - 7, py), (x0, py), _BLACK, 1)
        label = f"{v:g}"
        (w, h), _ = raster.get_text_size(label, raster.FONT_HERSHEY_SIMPLEX, 0.5, 1)
        raster.put_text(img, label, (x0 - 12 - w, py + h // 2), raster.FONT_HERSHEY_SIMPLEX, 0.5, _BLACK, 1)
    _text_centered(img, "x (m)", (x0 + x1) / 2, y1 + 70, 0.8)
    (w, h), base = raster.get_text_size("y (m)", raster.FONT_HERSHEY_SIMPLEX, 0.8, 1)
    label = np.full((h + base + 4, w + 4, 3), 255, np.uint8)
    raster.put_text(label, "y (m)", (2, h + 2), raster.FONT_HERSHEY_SIMPLEX, 0.8, _BLACK, 1)
    label = np.rot90(label)  # matplotlib's y label reads bottom to top
    ly, lx = (y0 + y1) // 2 - label.shape[0] // 2, max(x0 - 110, 0)
    img[ly:ly + label.shape[0], lx:lx + label.shape[1]] = label
    _text_centered(img, title, (x0 + x1) / 2, y0 - 25, 0.8)
    if save_path:
        from sfa3d_tpu_torch.data.png import write_png_rgb

        write_png_rgb(save_path, img[:, :, ::-1])
    return img


def example_usage_bev_projection(save_path: Optional[str] = None, seed: int = 0):
    """Synthetic end-to-end demo: a random cloud and boxes, a lidar -> ego
    SE3 motion, the BEV drawing."""
    from sfa3d_tpu_torch.data.synthetic import synthetic_scene

    points, labels = synthetic_scene(seed=seed, n_objects=6)
    lidar_T_ego = SE3.from_quaternion([1.0, 0.0, 0.0, 0.0], np.array([1.35, 0.0, 1.68]))
    points_ego = lidar_T_ego.transform_point_cloud(points[:, :3])
    boxes = []
    for row in labels:
        b = row[1:8].astype(np.float64).copy()
        b[6] = -row[7]  # stored as -yaw (see synthetic_scene)
        b[:3] = lidar_T_ego.transform_point_cloud(b[None, :3])[0]
        boxes.append(b)
    return draw_bev_boxes(
        np.hstack([points_ego, points[:, 3:4]]), boxes, save_path,
        boundary={"minX": -10, "maxX": 60, "minY": -30, "maxY": 30},
        title="synthetic BEV projection (ego frame)",
    )
