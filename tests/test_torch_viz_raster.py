"""The port's drawing primitives (`sfa3d_tpu_torch/viz/raster.py`) against
cv2 on seeded inputs.

Tolerances: none. Thin and thick LINE_8 and LINE_AA lines, arrowed lines,
closed polylines, rectangles, the convex fill, JET, rotate, vconcat,
resize, the text sizes and the text pixels at fontScale 0.4, 0.5, 0.8 and
1.0 are exact.
Other text scales are refused.

`band` is the comparison the CLI tests use where two images may rightly
differ by a pixel (box corners from detections that agree within 1e-3);
the last tests here show that it reports a stroke drawn 5 px off or in
another colour.
"""

import cv2
import numpy as np
import pytest

from sfa3d_tpu_torch.viz import raster

H, W = 120, 160
CLI_STRINGS = ["Fused car 0.87", "bayesian fusion  12.3 FPS", "0.53", "github.com/maudzung",
               "Speed: 42.5 FPS", "YOLOv8 person 0.00", "SFA3D cls1 0.31", "artifact fusion  3.9 FPS",
               "#12", "(7)", "backbone layer1 (16, 16, 64)"]


def _grow(mask, radius):
    """`mask` dilated by a (2 radius + 1)-square."""
    grown = mask.copy()
    h, w = mask.shape
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            src = mask[max(dy, 0):h + min(dy, 0), max(dx, 0):w + min(dx, 0)]
            grown[max(-dy, 0):h + min(-dy, 0), max(-dx, 0):w + min(-dx, 0)] |= src
    return grown


def _window_range(img, radius):
    """Per channel, the least and the greatest value within `radius` (a
    square window, cut at the image's edges)."""
    k = 2 * radius + 1
    padded = np.pad(img, ((radius, radius), (radius, radius), (0, 0)), mode="edge")
    win = np.lib.stride_tricks.sliding_window_view(padded, (k, k), axis=(0, 1))
    return win.min(axis=(-2, -1)), win.max(axis=(-2, -1))


def band(background, a, b, ignore=None, radius=2):
    """(differing pixels outside the band, differing pixels, pixels either
    image changed from `background`); `ignore` masks pixels out of all three.

    A pixel where `a` and `b` differ lies in the band when it lies within
    `radius` of a pixel that `a` changed from the background and within
    `radius` of one that `b` changed, and when, channel by channel, its value
    in each image lies between the least and the greatest value of the
    other image within `radius`. A stroke drawn a few pixels off, or in
    another colour, falls outside."""
    ink_a = (a != background).any(2)
    ink_b = (b != background).any(2)
    diff = (a != b).any(2)
    lo_a, hi_a = (r.astype(np.int16) for r in _window_range(a, radius))
    lo_b, hi_b = (r.astype(np.int16) for r in _window_range(b, radius))
    a16, b16 = a.astype(np.int16), b.astype(np.int16)
    inside = _grow(ink_a, radius) & _grow(ink_b, radius)
    inside &= ((a16 >= lo_b) & (a16 <= hi_b)).all(2) & ((b16 >= lo_a) & (b16 <= hi_a)).all(2)
    ink = ink_a | ink_b
    if ignore is not None:
        ink &= ~ignore
        diff &= ~ignore
    return int((diff & ~inside).sum()), int(diff.sum()), int(ink.sum())


def _segments(n, seed):
    rng = np.random.default_rng(seed)
    segs = rng.integers(-80, 240, size=(n, 4)).tolist()
    for i in range(0, n, 25):  # endpoints far off the image
        segs[i][i % 4] = int(rng.choice([-1, 1])) * 10 ** 6
    return segs


@pytest.mark.parametrize("thickness", [1, 2, 3])
def test_line8_equals_cv2(thickness):
    """500 seeded segments, many off the image, some with endpoints at
    +-1e6: thin and thick LINE_8 lines equal cv2's pixel for pixel."""
    for x1, y1, x2, y2 in _segments(500, thickness):
        a = np.zeros((H, W, 3), np.uint8)
        b = a.copy()
        cv2.line(a, (x1, y1), (x2, y2), (10, 200, 30), thickness)
        raster.line(b, (x1, y1), (x2, y2), (10, 200, 30), thickness)
        assert np.array_equal(a, b), (x1, y1, x2, y2)


def test_line_through_int_min_equals_cv2():
    """A corner behind the camera casts to INT_MIN; cv2 clips such a line."""
    lo = np.iinfo(np.int32).min
    for pt1, pt2 in [((lo, lo), (50, 60)), ((40, 30), (lo, 70)), ((lo, lo), (lo, lo)), ((20, lo), (30, 80))]:
        for thickness in (1, 2):
            a = np.zeros((H, W, 3), np.uint8)
            b = a.copy()
            cv2.line(a, pt1, pt2, (255, 0, 0), thickness)
            raster.line(b, pt1, pt2, (255, 0, 0), thickness)
            assert np.array_equal(a, b), (pt1, pt2, thickness)


@pytest.mark.parametrize("thickness", [1, 2])
def test_polylines_and_rectangles_equal_cv2(thickness):
    rng = np.random.default_rng(10 + thickness)
    for _ in range(200):
        pts = rng.integers(-30, 190, size=(rng.integers(2, 6), 2)).astype(np.int32)
        for closed in (True, False):
            a = np.zeros((H, W, 3), np.uint8)
            b = a.copy()
            cv2.polylines(a, [pts.reshape(-1, 1, 2)], closed, (255, 255, 0), thickness)
            raster.polylines(b, [pts.reshape(-1, 1, 2)], closed, (255, 255, 0), thickness)
            assert np.array_equal(a, b), (pts.tolist(), closed)
        x1, y1, x2, y2 = (int(v) for v in rng.integers(-20, 180, 4))
        a = np.zeros((H, W, 3), np.uint8)
        b = a.copy()
        cv2.rectangle(a, (x1, y1), (x2, y2), (0, 255, 0), thickness)
        raster.rectangle(b, (x1, y1), (x2, y2), (0, 255, 0), thickness)
        assert np.array_equal(a, b), (x1, y1, x2, y2)


def test_fill_convex_poly_equals_cv2():
    rng = np.random.default_rng(3)
    for _ in range(200):
        hull = cv2.convexHull(rng.integers(-30, 190, size=(5, 2)).astype(np.int32)).reshape(-1, 2)
        a = np.zeros((H, W, 3), np.uint8)
        b = a.copy()
        cv2.fillConvexPoly(a, hull, (0, 255, 0))
        raster.fill_convex_poly(b, hull, (0, 255, 0))
        assert np.array_equal(a, b), hull.tolist()


@pytest.mark.parametrize("thickness", [1, 2, 3, 6])
def test_aa_lines_within_the_band(thickness):
    """LINE_AA strokes equal cv2's pixel for pixel: cv2's LineAA (its
    slope-correction and filter tables, each pixel blended twice) and, from
    thickness 2, the quad filled with anti-aliased edges and caps, on 200
    seeded segments over a coloured background, many off the image and
    some with endpoints at +-1e6."""
    for x1, y1, x2, y2 in _segments(200, 20 + thickness):
        a = np.full((H, W, 3), 30, np.uint8)
        b = a.copy()
        cv2.line(a, (x1, y1), (x2, y2), (0, 0, 255), thickness, cv2.LINE_AA)
        raster.line(b, (x1, y1), (x2, y2), (0, 0, 255), thickness, raster.LINE_AA)
        assert np.array_equal(a, b), (x1, y1, x2, y2)


@pytest.mark.parametrize("thickness", [1, 2])
@pytest.mark.parametrize("line_type", [cv2.LINE_8, cv2.LINE_AA])
def test_arrowed_line_equals_cv2(thickness, line_type):
    """cv2.arrowedLine at the track CLI's tipLength 0.3 and at 0.1 and 0.5,
    shafts of every direction and length, some clipped."""
    rng = np.random.default_rng(thickness * 10 + line_type)
    for k in range(150):
        p1 = tuple(int(v) for v in rng.integers(-30, 190, 2))
        p2 = tuple(int(v) for v in rng.integers(-30, 190, 2))
        tip = (0.3, 0.1, 0.5)[k % 3]
        a = np.full((H, W, 3), (40, 30, 20), np.uint8)
        b = a.copy()
        cv2.arrowedLine(a, p1, p2, (10, 200, 255), thickness, line_type, 0, tip)
        raster.arrowed_line(b, p1, p2, (10, 200, 255), thickness, line_type, tipLength=tip)
        assert np.array_equal(a, b), (p1, p2, tip)


def test_jet_rotate_vconcat_resize_equal_cv2():
    levels = np.arange(256, dtype=np.uint8).reshape(16, 16)
    assert np.array_equal(raster.apply_colormap_jet(levels), cv2.applyColorMap(levels, cv2.COLORMAP_JET))
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    assert np.array_equal(raster.rotate_180(img), cv2.rotate(img, cv2.ROTATE_180))
    other = rng.integers(0, 256, (11, 53, 3), dtype=np.uint8)
    assert np.array_equal(raster.vconcat([img, other]), cv2.vconcat([img, other]))
    for (h, w), (nw, nh) in [((375, 1242), (608, 183)), ((608, 608), (608, 608)), ((608, 608), (1242, 1242))]:
        src = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        assert np.array_equal(raster.resize(src, (nw, nh)), cv2.resize(src, (nw, nh)))


def _strings(seed=0, n=200):
    rng = np.random.default_rng(seed)
    chars = [chr(c) for c in range(32, 127)]
    return CLI_STRINGS + ["".join(rng.choice(chars, size=rng.integers(1, 24))) for _ in range(n)]


@pytest.mark.parametrize("scale", [0.4, 0.5, 0.8, 1.0])
@pytest.mark.parametrize("thickness", [1, 2])
def test_text_size_equals_cv2(scale, thickness):
    for text in _strings():
        want = cv2.getTextSize(text, cv2.FONT_HERSHEY_SIMPLEX, scale, thickness)
        got = raster.get_text_size(text, raster.FONT_HERSHEY_SIMPLEX, scale, thickness)
        assert (tuple(got[0]), got[1]) == (tuple(want[0]), want[1]), text


@pytest.mark.parametrize("scale", [0.4, 0.5, 0.8, 1.0])
@pytest.mark.parametrize("thickness", [1, 2])
def test_put_text_equals_cv2(scale, thickness):
    """Pixel for pixel at the CLIs' scales, any line type, over a coloured
    background; the ink lies inside cv2's text box (grown by 2 px)."""
    for k, text in enumerate(_strings(seed=1, n=60)):
        (w, h), base = cv2.getTextSize(text, cv2.FONT_HERSHEY_SIMPLEX, scale, thickness)
        org = (7, 9 + h)
        a = np.full((h + base + 20, w + 20, 3), (90, 20, 200), np.uint8)
        b = a.copy()
        line_type = cv2.LINE_AA if k % 2 else cv2.LINE_8
        cv2.putText(a, text, org, cv2.FONT_HERSHEY_SIMPLEX, scale, (0, 255, 255), thickness, line_type)
        raster.put_text(b, text, org, raster.FONT_HERSHEY_SIMPLEX, scale, (0, 255, 255), thickness, line_type)
        assert np.array_equal(a, b), text
        # the box cv2 reports, grown by 2 px for glyphs that reach left of
        # their pen ('j') or past the last advance, as cv2's own ink does
        ys, xs = np.nonzero((b != (90, 20, 200)).any(2))
        if len(xs):
            assert xs.min() >= org[0] - 2 and xs.max() < org[0] + w + 2, text
            assert ys.min() >= org[1] - h - 2 and ys.max() <= org[1] + base + 2, text


def test_put_text_clips_at_the_image_edges():
    for org in [(-5, 10), (100, 3), (150, 130), (-30, -4)]:
        a = np.zeros((H, W, 3), np.uint8)
        b = a.copy()
        cv2.putText(a, "Fused car 0.87", org, cv2.FONT_HERSHEY_SIMPLEX, 0.5, (0, 255, 0), 1)
        raster.put_text(b, "Fused car 0.87", org, raster.FONT_HERSHEY_SIMPLEX, 0.5, (0, 255, 0), 1)
        assert np.array_equal(a, b), org


@pytest.mark.parametrize("scale", [0.6, 1.2])
def test_text_refuses_untabulated_scales(scale):
    """Only the pixel sizes of fontScale 0.5, 0.8 and 1.0 are tabulated."""
    img = np.zeros((40, 80, 3), np.uint8)
    with pytest.raises(ValueError, match="fontScale"):
        raster.get_text_size("0.53", raster.FONT_HERSHEY_SIMPLEX, scale, 1)
    with pytest.raises(ValueError, match="fontScale"):
        raster.put_text(img, "0.53", (5, 20), raster.FONT_HERSHEY_SIMPLEX, scale, (255, 255, 255), 1)
    assert not img.any()


def test_drawing_refuses_other_images():
    with pytest.raises(ValueError, match="uint8"):
        raster.line(np.zeros((4, 4, 3), np.float32), (0, 0), (3, 3), (1, 1, 1))
    with pytest.raises(ValueError, match="FONT_HERSHEY_SIMPLEX"):
        raster.get_text_size("a", 1, 1.0, 1)


def _box(img, dx=0, color=(0, 0, 255), line_type=cv2.LINE_AA):
    cv2.rectangle(img, (30 + dx, 30), (100 + dx, 80), color, 2, line_type)
    return img


@pytest.mark.parametrize("fault", ["shifted", "recoloured"])
@pytest.mark.parametrize("line_type", [cv2.LINE_8, cv2.LINE_AA])
def test_band_reports_a_misplaced_or_miscoloured_box(fault, line_type):
    """A box drawn 5 px to the right, or with its channels swapped, is
    reported; the same box drawn again, or 1 px to the right, is not."""
    bg = np.full((H, W, 3), 30, np.uint8)
    a = _box(bg.copy(), line_type=line_type)
    assert band(bg, a, _box(bg.copy(), line_type=line_type))[:2] == (0, 0)
    assert band(bg, a, _box(bg.copy(), dx=1, line_type=line_type))[0] == 0
    b = _box(bg.copy(), dx=5, line_type=line_type) if fault == "shifted" else \
        _box(bg.copy(), color=(255, 0, 0), line_type=line_type)
    outside, differ, inked = band(bg, a, b)
    assert outside > 0.2 * differ > 0, (outside, differ, inked)
