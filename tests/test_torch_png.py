"""The port's PNG codec (`data/png.py`) against cv2, and its camera-frame
renderer (`data/synthetic.py::render_camera_image`) against the JAX
package's cv2 renderer.

- Decoding is exact: files cv2.imwrite wrote (RGB, greyscale, RGBA) and
  files built here with each PNG row filter 0-4 decode to cv2.imread +
  cvtColor(BGR2RGB) bit for bit; cv2.imread reads the port's files back
  exactly; unsupported files raise.
- The renderer: the velodyne-point dots are the JAX frame's pixels exactly
  (no boxes). With boxes, every pixel that differs lies within EDGE_BAND
  px of a projected hull edge: the port fills pixel centres inside the
  hull and outlines those within 1 px of an edge, cv2 rasterises edges by
  its own fixed-point rules.
"""

import struct
import zlib

import cv2
import numpy as np
import pytest

from sfa3d_tpu.data import synthetic as jsynthetic
from sfa3d_tpu_torch.config import kitti as cnf
from sfa3d_tpu_torch.data import png, synthetic
from sfa3d_tpu_torch.geometry.transforms import lidar_to_camera_box

EDGE_BAND = 2.0  # px from a hull edge within which rendered pixels may differ


def _cv2_rgb(path):
    return cv2.cvtColor(cv2.imread(str(path), cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)


@pytest.mark.parametrize("channels", [3, 1, 4])
def test_cv2_written_files_decode_exactly(tmp_path, channels):
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, (37, 53, channels) if channels > 1 else (37, 53)).astype(np.uint8)
    img[5:20, 10:40] = 77  # flat areas let the encoder pick other filters
    path = tmp_path / "a.png"
    assert cv2.imwrite(str(path), img)
    np.testing.assert_array_equal(png.read_png_rgb(str(path)), _cv2_rgb(path))


def _filtered_png(img: np.ndarray, filters) -> bytes:
    """An 8-bit RGB PNG whose row y is written with filter filters[y]."""
    h, w, _ = img.shape
    bpp, stride = 3, w * 3
    flat = img.reshape(h, stride).astype(np.int64)
    rows = []
    for y in range(h):
        cur = flat[y]
        up = flat[y - 1] if y else np.zeros(stride, np.int64)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        up_left = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        f = filters[y]
        if f == 0:
            pred = np.zeros(stride, np.int64)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = up
        elif f == 3:
            pred = (left + up) // 2
        else:
            p = left + up - up_left
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - up_left)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, up_left))
        rows.append(bytes([f]) + ((cur - pred) % 256).astype(np.uint8).tobytes())

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))


def test_every_row_filter_decodes_like_cv2(tmp_path):
    rng = np.random.default_rng(9)
    img = rng.integers(0, 256, (25, 31, 3)).astype(np.uint8)
    img[:, 8:20] = rng.integers(0, 256, (1, 12, 3))  # columns repeat down the rows
    filters = [y % 5 for y in range(25)]
    path = tmp_path / "f.png"
    path.write_bytes(_filtered_png(img, filters))
    assert set(filters) == {0, 1, 2, 3, 4}
    np.testing.assert_array_equal(_cv2_rgb(path), img)
    np.testing.assert_array_equal(png.read_png_rgb(str(path)), img)


def test_cv2_reads_the_port_files_exactly(tmp_path):
    img = np.random.default_rng(3).integers(0, 256, (40, 70, 3)).astype(np.uint8)
    path = tmp_path / "p.png"
    png.write_png_rgb(str(path), img)
    np.testing.assert_array_equal(_cv2_rgb(path), img)
    np.testing.assert_array_equal(png.read_png_rgb(str(path)), img)


def test_unsupported_files_raise(tmp_path):
    path = tmp_path / "g16.png"
    cv2.imwrite(str(path), np.zeros((4, 4), np.uint16))
    with pytest.raises(ValueError, match="unsupported PNG"):
        png.read_png_rgb(str(path))
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode_png_rgb(b"GIF89a....")
    with pytest.raises(ValueError):
        png.write_png_rgb(str(tmp_path / "x.png"), np.zeros((4, 4), np.uint8))


def _hull_edge_distance(labels, P, hw):
    """Per pixel, the distance to the nearest edge of any rendered box hull."""
    h, w = hw
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    dist = np.full((h, w), np.inf)
    cam = np.asarray(lidar_to_camera_box(labels[:, 1:8].astype(np.float64)))
    for x, y, z, bh, bw, bl, ry in cam:
        corners = synthetic.compute_box_3d((bh, bw, bl), (x, y, z), ry)
        if (corners[:, 2] <= 1.0).any():
            continue
        hull = synthetic.convex_hull(synthetic.project_to_image(corners, P)).astype(np.float64)
        for i in range(len(hull)):
            (ax, ay), (bx, by) = hull[i - 1], hull[i]
            dx, dy = bx - ax, by - ay
            t = np.clip(((xs - ax) * dx + (ys - ay) * dy) / max(dx * dx + dy * dy, 1e-12), 0, 1)
            dist = np.minimum(dist, np.hypot(xs - ax - t * dx, ys - ay - t * dy))
    return dist


@pytest.mark.parametrize("seed", [0, 4])
def test_render_matches_jax_points_exact_hull_edges_within_band(seed):
    points, labels = synthetic.synthetic_scene(seed)
    P2 = np.asarray(cnf.P2[:3], np.float64).reshape(3, 4)
    dots = synthetic.render_camera_image(points, labels[:0], P2)
    np.testing.assert_array_equal(dots, jsynthetic.render_camera_image(points, labels[:0], P2)[..., ::-1])
    got = synthetic.render_camera_image(points, labels, P2)
    want = jsynthetic.render_camera_image(points, labels, P2)[..., ::-1]
    differ = np.any(got != want, -1)
    dist = _hull_edge_distance(labels, P2, got.shape[:2])
    assert differ.sum() < 0.01 * differ.size
    assert dist[differ].max() <= EDGE_BAND, dist[differ].max()
    assert (got != 28).any(-1).sum() > 10000  # boxes and dots were drawn


def test_mini_kitti_camera_frames_read_back(tmp_path):
    """The writer's image_2 / image_3 PNGs are the renderer's frames (the
    right one through P3, shifted by the stereo baseline)."""
    root = synthetic.write_mini_kitti(str(tmp_path / "k"), n_frames=1, splits=("train",))
    points, labels = synthetic.synthetic_scene(0)
    P2 = np.asarray(cnf.P2[:3], np.float64).reshape(3, 4)
    left = png.read_png_rgb(f"{root}/training/image_2/000000.png")
    np.testing.assert_array_equal(left, synthetic.render_camera_image(points, labels, P2))
    right = png.read_png_rgb(f"{root}/training/image_3/000000.png")
    assert right.shape == (375, 1242, 3) and not np.array_equal(left, right)
    np.testing.assert_array_equal(_cv2_rgb(f"{root}/testing/image_2/000000.png"),
                                  png.read_png_rgb(f"{root}/testing/image_2/000000.png"))
