"""The port's `viz/draw.py`, `viz/bev_projection.py` and the drawing helpers
of `geometry/transforms.py` against the JAX package's, on the same seeded
inputs: a 608 x 608 BEV, a 375 x 1242 camera frame, a few boxes (some
straddling the image edge and the camera plane).

Tolerances: the geometry (box corners, projections with their int casts,
BEV corners in float32), `bev_map_to_image`, `merge_rgb_to_bev`, the BEV box
drawings (LINE_8), the credit text and the anti-aliased cuboids of
`draw_box_3d` and `show_rgb_image_with_boxes` are exact. `draw_bev_boxes`
has no matplotlib counterpart here: its red polygons lie on the projected
corners' pixels.
"""

import numpy as np

from sfa3d_tpu.geometry import transforms as jtransforms
from sfa3d_tpu.geometry.calibration import KittiCalibration as JCalibration
from sfa3d_tpu.viz import bev_projection as jbev
from sfa3d_tpu.viz import draw as jdraw
from sfa3d_tpu_torch.geometry import transforms
from sfa3d_tpu_torch.geometry.calibration import KittiCalibration
from sfa3d_tpu_torch.viz import bev_projection, draw


def _cam_labels():
    """Camera-frame boxes [cls, x, y, z, h, w, l, ry]: in view, at the
    image's edges, straddling the camera plane, behind it, and closer than
    2 m (skipped)."""
    rng = np.random.default_rng(7)
    rows = [[1, 2.0, 1.5, 15.0, 1.5, 1.6, 3.9, 0.3], [0, -4.0, 1.6, 8.0, 1.7, 0.6, 0.8, 1.2],
            [2, 9.5, 1.5, 10.0, 1.7, 0.6, 1.8, -0.7], [1, -12.0, 1.4, 6.0, 1.5, 1.7, 4.2, 2.9],
            [1, 1.0, 1.5, 2.5, 1.5, 1.8, 6.0, 0.1], [1, 0.0, 1.5, 1.0, 1.5, 1.6, 3.9, 0.0],
            [0, 3.0, 1.5, -5.0, 1.7, 0.6, 0.8, 0.4], [7, 0.5, -1.0, 30.0, 3.0, 2.5, 9.0, -1.4]]
    for _ in range(6):
        rows.append([int(rng.integers(0, 3)), *rng.uniform(-15, 15, 1), *rng.uniform(0.5, 2, 1),
                     *rng.uniform(1, 45, 1), *rng.uniform(1, 2, 1), *rng.uniform(0.5, 2, 1),
                     *rng.uniform(0.8, 5, 1), *rng.uniform(-3.1, 3.1, 1)])
    return np.asarray(rows, np.float32)


def _bev_boxes():
    rng = np.random.default_rng(8)
    boxes = np.zeros((12, 9), np.float32)
    boxes[:, 0] = rng.integers(0, 3, 12)
    boxes[:, 1] = rng.uniform(0, 1, 12)
    boxes[:, 2:4] = rng.uniform(-20, 628, (12, 2))  # some past the edges
    boxes[:, 6] = rng.uniform(4, 30, 12)
    boxes[:, 7] = rng.uniform(8, 60, 12)
    boxes[:, 8] = rng.uniform(-np.pi, np.pi, 12)
    mask = rng.uniform(0, 1, 12) > 0.2
    return boxes, mask


def test_box_geometry_equals_jax():
    calib = JCalibration(None)
    for row in _cam_labels():
        dim, loc, ry = row[4:7], row[1:4], row[7]
        a = jdraw.compute_box_3d(dim, loc, ry)
        b = draw.compute_box_3d(dim, loc, ry)
        assert a.dtype == b.dtype and np.array_equal(a, b)
        with np.errstate(invalid="ignore", divide="ignore"):
            pa = jdraw.project_to_image(a, calib.P2)
            pb = draw.project_to_image(b, calib.P2)
        assert pa.dtype == pb.dtype == np.int32 and np.array_equal(pa, pb)
    assert np.array_equal(jdraw.roty(0.7), draw.roty(0.7))


def test_camera_projection_helpers_equal_jax():
    rng = np.random.default_rng(1)
    boxes = rng.uniform(-10, 40, (9, 7))
    P = JCalibration(None).P2
    ja, jb = jtransforms.compute_box_3d_camera(boxes, P)
    pa, pb = transforms.compute_box_3d_camera(boxes, P)
    assert np.array_equal(ja, pa) and np.array_equal(jb, pb)
    assert np.array_equal(jtransforms.compute_box_3d_camera(boxes), transforms.compute_box_3d_camera(boxes))
    pts = rng.uniform(-5, 30, (20, 3))
    assert np.array_equal(jtransforms.project_to_image(pts, P), transforms.project_to_image(pts, P))
    import torch

    t_corners, t_uv = transforms.compute_box_3d_camera(torch.from_numpy(boxes), torch.from_numpy(P))
    assert np.allclose(t_corners.numpy(), pa, rtol=0, atol=1e-12)
    assert np.allclose(t_uv.numpy(), pb, rtol=1e-12, atol=1e-9)


def test_bev_corners_and_images_equal_jax():
    boxes, _ = _bev_boxes()
    for _, _, x, y, _, _, w, l, yaw in boxes:
        a = jdraw.get_corners_bev(x, y, w, l, yaw)
        b = draw.get_corners_bev(x, y, w, l, yaw)
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)
    rng = np.random.default_rng(2)
    bev = rng.uniform(0, 1, (608, 608, 3)).astype(np.float32)
    assert np.array_equal(jdraw.bev_map_to_image(bev), draw.bev_map_to_image(bev))
    rgb = rng.integers(0, 256, (375, 1242, 3), dtype=np.uint8)
    bev_img = draw.bev_map_to_image(bev)
    for width in (608, 1242, 300):
        assert np.array_equal(jdraw.merge_rgb_to_bev(rgb, bev_img, width), draw.merge_rgb_to_bev(rgb, bev_img, width))


def test_bev_box_drawings_equal_jax():
    rng = np.random.default_rng(3)
    img = (rng.uniform(0, 1, (608, 608, 3)) * 60).astype(np.uint8)
    boxes, mask = _bev_boxes()
    a = jdraw.draw_predictions_bev(img.copy(), boxes, mask)
    b = draw.draw_predictions_bev(img.copy(), boxes, mask)
    assert np.array_equal(a, b)
    _, _, x, y, _, _, w, l, yaw = boxes[0]
    assert np.array_equal(jdraw.draw_rotated_box(img.copy(), x, y, w, l, yaw, (1, 2, 3)),
                          draw.draw_rotated_box(img.copy(), x, y, w, l, yaw, (1, 2, 3)))


def test_credit_text_equals_jax():
    for fps in (None, 42.5):
        a = jdraw.write_credit(np.zeros((300, 700, 3), np.uint8), org_author=(10, 100), org_fps=(10, 140), fps=fps)
        b = draw.write_credit(np.zeros((300, 700, 3), np.uint8), org_author=(10, 100), org_fps=(10, 140), fps=fps)
        assert np.array_equal(a, b)


def test_camera_boxes_within_the_band():
    """The anti-aliased cuboids on a camera frame, boxes at the image's
    edges and across the camera plane included, equal JAX's."""
    rng = np.random.default_rng(4)
    frame = rng.integers(0, 80, (375, 1242, 3), dtype=np.uint8)
    labels = _cam_labels()
    with np.errstate(invalid="ignore", divide="ignore"):
        a = jdraw.show_rgb_image_with_boxes(frame.copy(), labels, JCalibration(None))
        b = draw.show_rgb_image_with_boxes(frame.copy(), labels, KittiCalibration(None))
    assert (a != frame).any(2).sum() > 1000
    assert np.array_equal(a, b)


def test_draw_box_3d_within_the_band():
    rng = np.random.default_rng(5)
    for _ in range(10):
        corners = rng.integers(-200, 1400, (8, 2)).astype(np.int32)
        frame = np.zeros((375, 1242, 3), np.uint8)
        a = jdraw.draw_box_3d(frame.copy(), corners, (0, 255, 255))
        b = draw.draw_box_3d(frame.copy(), corners, (0, 255, 255))
        assert np.array_equal(a, b), corners.tolist()


def test_bev_projection_geometry_equals_jax():
    rng = np.random.default_rng(6)
    for _ in range(8):
        box = np.concatenate([rng.uniform(-20, 40, 3), rng.uniform(0.5, 5, 3), rng.uniform(-3, 3, 1)])
        a = jbev.get_3d_box_corners(box)
        b = bev_projection.get_3d_box_corners(box)
        assert np.array_equal(a, b)
        assert np.array_equal(jbev.project_box_to_bev(a), bev_projection.project_box_to_bev(b))


def test_draw_bev_boxes_polygons_on_the_projected_corners(tmp_path):
    from sfa3d_tpu_torch.data.png import read_png_rgb

    rng = np.random.default_rng(9)
    points = np.concatenate([rng.uniform(-5, 55, (3000, 2)), rng.uniform(-2, 1, (3000, 1))], axis=1)
    boxes = [np.array([10.0, 3.0, -1.0, 1.5, 1.8, 4.2, 0.4]), np.array([30.0, -8.0, -1.0, 1.7, 0.7, 0.9, -2.0]),
             np.array([48.0, 20.0, -1.0, 1.5, 2.0, 5.0, 1.2])]
    boundary = {"minX": 0, "maxX": 50, "minY": -25, "maxY": 25}
    path = tmp_path / "bev.png"
    img = bev_projection.draw_bev_boxes(points, boxes, str(path), boundary=boundary, title="t")
    assert img.shape == (1200, 1200, 3) and img.dtype == np.uint8
    assert np.array_equal(read_png_rgb(str(path))[:, :, ::-1], img)
    to_pixels, (x0, y0, x1, y1), _ = bev_projection.bev_plot_transform(points, boxes, boundary)
    red = (img == (0, 0, 255)).all(2)
    for box in boxes:
        for u, v in np.rint(to_pixels(bev_projection.project_box_to_bev(bev_projection.get_3d_box_corners(box)))):
            u, v = int(u), int(v)
            if x0 <= u <= x1 and y0 <= v <= y1:
                assert red[v, u], (box, u, v)
    # the viridis scatter lies inside the axes only
    coloured = (img != 255).any(2) & ~red
    ys, xs = np.nonzero(coloured[y0 + 2:y1 - 1, x0 + 2:x1 - 1])
    assert len(xs) > 1000
    out = bev_projection.example_usage_bev_projection(str(tmp_path / "demo.png"))
    assert out.shape == (1200, 1200, 3) and (tmp_path / "demo.png").is_file()


def test_viz_package_exports_match_jax():
    import sfa3d_tpu.viz as jviz
    import sfa3d_tpu_torch.viz as tviz

    assert tviz.__all__ == jviz.__all__
    for name in tviz.__all__:
        assert callable(getattr(tviz, name))
