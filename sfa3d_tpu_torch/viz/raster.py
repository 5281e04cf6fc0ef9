"""The drawing primitives of the port: cv2's raster calls, in numpy and
integer Python, with cv2's argument order, on uint8 (H, W, 3) BGR images
drawn in place.

- `line` (LINE_8 at thickness 1): the clipped Bresenham walk of cv2's
  `LineIterator`, after `clipLine` against the image;
- `line` at thickness > 1 (LINE_8): cv2's thick line, the 16.16
  fixed-point quad filled by `FillConvexPoly` (its edges walked by the
  fixed-point `Line2`) with a filled-circle cap at each end;
- `line` with LINE_AA: cv2's LineAA at thickness 1 (its slope-correction
  and filter tables and end-point correction, each pixel blended twice as
  cv2 5.x does) and, thicker, cv2's quad filled with anti-aliased edges and
  anti-aliased polygon caps (ellipse2Poly's vertices), pixel for pixel;
- `arrowed_line`: cv2's arrowedLine, the shaft and two tip strokes at
  +-45 degrees, each `tipLength` times the shaft's length, through `line`;
- `polylines`, `rectangle`: cv2's PolyLine over `line`'s thick segments
  (closed polylines cap every vertex but the first segment's start);
- `get_text_size` and `put_text` for FONT_HERSHEY_SIMPLEX, which cv2 5.x
  draws as an anti-aliased outline font: the metrics and the glyphs'
  coverage at fontScale 0.4, 0.5, 0.8 and 1.0 are the port's table in
  `viz/hershey.py` (equal to cv2's, pixel for pixel); other scales are
  refused;
- `rotate_180`, `vconcat`, `resize` (`models/yolov8.py::_resize_uint8`,
  cv2's INTER_LINEAR bit for bit) and `apply_colormap_jet`.

Drawing stays on the host, as it does in the JAX package: it is
presentation, not part of the detector.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Sequence

import numpy as np

LINE_8 = 8
LINE_AA = 16
FONT_HERSHEY_SIMPLEX = 0

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


def _tdiv(a: int, b: int) -> int:
    """C integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _color(color) -> np.ndarray:
    c = list(np.asarray(color, np.float64).reshape(-1)[:3])
    c += [0.0] * (3 - len(c))
    return np.clip(np.rint(c), 0, 255).astype(np.uint8)


def _check(img: np.ndarray) -> None:
    if not (isinstance(img, np.ndarray) and img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3):
        raise ValueError("drawing takes an (H, W, 3) uint8 image")


def _point(p):
    x, y = p
    return int(x), int(y)


def clip_line(width: int, height: int, x1: int, y1: int, x2: int, y2: int):
    """cv2.clipLine on a width x height box: (inside, x1, y1, x2, y2), the
    endpoints moved onto the box's edges in 64-bit integer and double
    arithmetic as cv2 does."""
    if width <= 0 or height <= 0:
        return False, x1, y1, x2, y2
    right, bottom = width - 1, height - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * float(x2 - x1) / float(y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * float(x2 - x1) / float(y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * float(y2 - y1) / float(x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * float(y2 - y1) / float(x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _line8(img, x1, y1, x2, y2, color) -> None:
    """cv2's Line at connectivity 8: LineIterator(leftToRight) over the
    clipped segment, one pixel per step of the major axis."""
    h, w = img.shape[:2]
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        inside, x1, y1, x2, y2 = clip_line(w, h, x1, y1, x2, y2)
        if not inside:
            return
    dx, dy = x2 - x1, y2 - y1
    if dx < 0:
        dx, dy, x1, y1 = -dx, -dy, x2, y2
    sy = 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    k = np.arange(dx + 1, dtype=np.int64)
    minor = _bresenham_minor(dx, dy)
    if vert:
        xs, ys = x1 + minor, y1 + sy * k
    else:
        xs, ys = x1 + k, y1 + sy * minor
    img[ys, xs] = color


def _bresenham_minor(dx: int, dy: int) -> np.ndarray:
    """Minor-axis offsets of the dx + 1 pixels of cv2's 8-connected walk
    (err0 = dx - 2 dy; a minor step follows each pixel whose err < 0)."""
    err = dx - 2 * dy
    out = np.empty(dx + 1, np.int64)
    m = 0
    for i in range(dx + 1):
        out[i] = m
        if err < 0:
            err += 2 * dx - 2 * dy
            m += 1
        else:
            err -= 2 * dy
    return out


def _line2(img, x1, y1, x2, y2, color) -> None:
    """cv2's Line2, which walks a polygon's edges between 16.16 fixed-point
    endpoints: the major axis steps whole pixels from the first endpoint,
    the minor axis carries the fixed-point slope, and the second endpoint
    is put rounded."""
    h, w = img.shape[:2]
    inside, x1, y1, x2, y2 = clip_line(w << XY_SHIFT, h << XY_SHIFT, x1, y1, x2, y2)
    if not inside:
        return
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            dy = -dy
            x1, x2, y1, y2 = x2, x1, y2, y1
        step = _tdiv(dy << XY_SHIFT, ax | 1)
        ecount = (x2 - x1) >> XY_SHIFT
    else:
        if dy < 0:
            dx = -dx
            x1, x2, y1, y2 = x2, x1, y2, y1
        step = _tdiv(dx << XY_SHIFT, ay | 1)
        ecount = (y2 - y1) >> XY_SHIFT
    x1 += XY_ONE >> 1
    y1 += XY_ONE >> 1
    k = np.arange(max(ecount + 1, 0), dtype=np.int64)
    if ax > ay:
        xs, ys = (x1 >> XY_SHIFT) + k, (y1 + k * step) >> XY_SHIFT
    else:
        xs, ys = (x1 + k * step) >> XY_SHIFT, (y1 >> XY_SHIFT) + k
    px = np.concatenate([[(x2 + (XY_ONE >> 1)) >> XY_SHIFT], xs]).astype(np.int64)
    py = np.concatenate([[(y2 + (XY_ONE >> 1)) >> XY_SHIFT], ys]).astype(np.int64)
    keep = (px >= 0) & (px < w) & (py >= 0) & (py < h)
    img[py[keep], px[keep]] = color


def _hline(img, y, x1, x2, color) -> None:
    h, w = img.shape[:2]
    if 0 <= y < h:
        x1, x2 = max(x1, 0), min(x2, w - 1)
        if x1 <= x2:
            img[y, x1:x2 + 1] = color


def _fill_convex_poly(img, v: Sequence, color, shift: int, line_type: int = LINE_8) -> None:
    """cv2's FillConvexPoly: the edges (by Line2 at LINE_8, by LineAA at
    LINE_AA), then the spans between the two edges walked down from the
    top vertex (at LINE_AA only the pixels wholly inside)."""
    h, w = img.shape[:2]
    npts = len(v)
    delta = (1 << shift) >> 1
    aa = line_type == LINE_AA
    delta1, delta2 = (XY_ONE - 1, 0) if aa else (XY_ONE >> 1, XY_ONE >> 1)
    p0x, p0y = v[-1][0] << (XY_SHIFT - shift), v[-1][1] << (XY_SHIFT - shift)
    xmin = xmax = v[0][0]
    ymin = ymax = v[0][1]
    imin = 0
    for i in range(npts):
        px, py = v[i]
        if py < ymin:
            ymin, imin = py, i
        ymax, xmax, xmin = max(ymax, py), max(xmax, px), min(xmin, px)
        px, py = px << (XY_SHIFT - shift), py << (XY_SHIFT - shift)
        if aa:
            _line_aa(img, p0x, p0y, px, py, color)
        elif shift == 0:
            _line8(img, p0x >> XY_SHIFT, p0y >> XY_SHIFT, px >> XY_SHIFT, py >> XY_SHIFT, color)
        else:
            _line2(img, p0x, p0y, px, py, color)
        p0x, p0y = px, py
    xmin, xmax = (xmin + delta) >> shift, (xmax + delta) >> shift
    ymin, ymax = (ymin + delta) >> shift, (ymax + delta) >> shift
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edges = npts
    e_idx, e_di = [imin, imin], [1, npts - 1]
    e_x, e_dx, e_ye = [-XY_ONE, -XY_ONE], [0, 0], [ymin, ymin]
    y = ymin
    while True:
        for i in range(2 if not aa or y < ymax or y == ymin else 0):
            if y >= e_ye[i]:
                idx0, di = e_idx[i], e_di[i]
                idx = idx0 + di
                if idx >= npts:
                    idx -= npts
                while edges > 0:
                    edges -= 1
                    ty = (v[idx][1] + delta) >> shift
                    if ty > y:
                        xs = v[idx0][0] << (XY_SHIFT - shift)
                        xe = v[idx][0] << (XY_SHIFT - shift)
                        e_ye[i] = ty
                        e_dx[i] = _tdiv((xe - xs) * 2 + (ty - y), 2 * (ty - y))
                        e_x[i] = xs
                        e_idx[i] = idx
                        break
                    idx0 = idx
                    idx += di
                    if idx >= npts:
                        idx -= npts
                else:
                    edges -= 1
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if e_x[0] > e_x[1] else (0, 1)
            x1 = (e_x[left] + delta1) >> XY_SHIFT
            x2 = (e_x[right] + delta2) >> XY_SHIFT
            if x2 >= 0 and x1 < w:
                x1, x2 = max(x1, 0), min(x2, w - 1)
                if aa and _RECORD is not None:
                    n = max(x2 - x1 + 1, 0)
                    _RECORD.append((np.full(n, y), np.arange(x1, x2 + 1), np.full((n, 1), 256)))
                else:
                    _hline(img, y, x1, x2, color)
        e_x[0] += e_dx[0]
        e_x[1] += e_dx[1]
        y += 1
        if y > ymax:
            break


def _fill_circle(img, cx: int, cy: int, radius: int, color) -> None:
    """cv2's Circle with fill: horizontal spans of the midpoint walk."""
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        _hline(img, cy - dy, cx - dx, cx + dx, color)
        _hline(img, cy + dy, cx - dx, cx + dx, color)
        _hline(img, cy - dx, cx - dy, cx + dy, color)
        _hline(img, cy + dx, cx - dy, cx + dy, color)
        dy += 1
        err += plus
        plus += 2
        mask = 0 if err <= 0 else -1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


# cv2's LineAA tables: the weight correction by the stroke's slope bin
# (32 bins of |minor / major| in [0, 1)) and the filter weight of a pixel
# by its sub-pixel offset across the stroke (the three pixels at 32 offsets).
# Read back from cv2 by scripts/torch_hershey_table.py.
_AA_SLOPE_CORR = (181, 181, 181, 182, 182, 183, 184, 185, 187, 188, 190, 192, 194, 196, 198, 201,
                  203, 206, 209, 211, 214, 218, 221, 224, 227, 231, 235, 238, 242, 246, 250, 254)
_AA_FILTER = np.asarray((
    168, 177, 185, 194, 202, 210, 218, 224, 231, 236, 241, 246, 249, 252, 254, 254,
    254, 254, 252, 249, 246, 241, 236, 231, 224, 218, 210, 202, 194, 185, 177, 168,
    158, 149, 140, 131, 122, 114, 105, 97, 89, 82, 75, 68, 62, 56, 50, 45,
    40, 36, 32, 28, 25, 22, 19, 16, 14, 12, 11, 9, 8, 7, 5, 5), np.int64)


_ACROSS = np.arange(3, dtype=np.int64)


def _line_aa(img, x1: int, y1: int, x2: int, y2: int, color) -> None:
    """cv2's LineAA between 16.16 fixed-point endpoints: clipped to the
    image, then per step of the major axis the three pixels across the
    stroke, each weighted a = (corr * filter >> 8) & 0xff by the slope's
    correction (in the first and last two steps cv2's end-point correction
    of it) and the sub-pixel offset's filter weight, and blended twice as
    bg + (((color - bg) * a + 127) >> 8), as cv2 5.x does."""
    h, w = img.shape[:2]
    inside, x1, y1, x2, y2 = clip_line(w << XY_SHIFT, h << XY_SHIFT, x1, y1, x2, y2)
    if not inside:
        return
    xmajor = abs(x2 - x1) > abs(y2 - y1)
    # (u, v): the major and the minor axis
    u1, v1, u2, v2, nu, nv = (x1, y1, x2, y2, w, h) if xmajor else (y1, x1, y2, x2, h, w)
    if u2 < u1:
        u1, v1, u2, v2 = u2, v2, u1, v1
    step = _tdiv((v2 - v1) << XY_SHIFT, (u2 - u1) | 1)
    u2 += XY_ONE
    ecount = (u2 >> XY_SHIFT) - (u1 >> XY_SHIFT)
    v1 += ((step * -(u1 & (XY_ONE - 1))) >> XY_SHIFT) + (XY_ONE >> 1)
    slope = ((step >> (XY_SHIFT - 5)) & 0x3F) ^ (0x3F if step < 0 else 0)
    slope = 0x100 if slope & 0x20 else _AA_SLOPE_CORR[slope]
    # the end-point correction of the first and last two steps, from the
    # 4-bit fractions of the endpoints
    i, j = (u1 >> (XY_SHIFT - 7)) & 0x78, (u2 >> (XY_SHIFT - 7)) & 0x78
    t0, t1, t2 = slope << 7, ((0x78 - i) | 4) * slope, (j | 4) * slope
    mid = ((((j - i) & 0x78) | 4) * slope >> 8) & 0x1FF
    ep = np.asarray([0, mid, (t1 >> 8) & 0x1FF, mid, ((((j - i) + 0x80) | 4) * slope >> 8) & 0x1FF,
                     ((t1 + t0) >> 8) & 0x1FF, (t2 >> 8) & 0x1FF, ((t2 + t0) >> 8) & 0x1FF, slope], np.int64)
    n = np.arange(ecount + 1, dtype=np.int64)
    v = v1 + n * step
    left = ecount - n
    corr = ep[(((n >= 2) + 1) & (n | 2)) * 3 + (((left >= 2) + 1) & (left | 2))]
    dist = (v >> (XY_SHIFT - 5)) & 31
    idx = np.empty((ecount + 1, 3), np.int64)
    idx[:, 0], idx[:, 1], idx[:, 2] = dist + 32, dist, 63 - dist
    a = ((corr[:, None] * _AA_FILTER[idx]) >> 8) & 0xFF
    us = np.broadcast_to(((u1 >> XY_SHIFT) + n)[:, None], idx.shape)
    vs = ((v >> XY_SHIFT) - 1)[:, None] + _ACROSS
    keep = (us >= 0) & (us < nu) & (vs >= 0) & (vs < nv)
    us, vs, a = us[keep], vs[keep], a[keep][:, None]
    ys, xs = (vs, us) if xmajor else (us, vs)
    _blend_twice(img, ys, xs, a, color)


# while not None, the AA drawing appends its (ys, xs, weights) here instead
# of drawing (`_cap_layers`)
_RECORD = None


def _blend_twice(img, ys, xs, a, color) -> None:
    """cv2 5.x's LINE_AA pixel write: bg + (((color - bg) * a + 127) >> 8),
    twice; a weight of 256 writes `color`."""
    if _RECORD is not None:
        _RECORD.append((ys, xs, a))
        return
    c = color.astype(np.int64)
    px = img[ys, xs].astype(np.int64)
    px += ((c - px) * a + 127) >> 8
    px += ((c - px) * a + 127) >> 8
    img[ys, xs] = px.astype(np.uint8)


def _sin_deg(deg: int) -> float:
    """cv2's sine table at whole degrees (float32)."""
    return float(np.float32(math.sin(math.radians(deg))))


def _ellipse_vertices(cx: int, cy: int, r: int):
    """ellipse2Poly's vertices (16.16) of a circle of radius `r` about
    (cx, cy): every 90, 30, 18 or 5 degrees by the radius."""
    delta = (r + (XY_ONE >> 1)) >> XY_SHIFT
    delta = 90 if delta < 3 else 30 if delta < 10 else 18 if delta < 15 else 5
    pts, prev = [], None
    for deg in range(0, 360 + delta, delta):
        deg = min(deg, 360)
        px = cx + r * _sin_deg(450 - deg)
        py = cy + r * _sin_deg(deg)
        ix, iy = _round(px / XY_ONE) << XY_SHIFT, _round(py / XY_ONE) << XY_SHIFT
        pt = (ix + _round(px - ix), iy + _round(py - iy))
        if pt != prev:
            pts.append(pt)
            prev = pt
    return pts if len(pts) > 1 else [(cx, cy), (cx, cy)]


@lru_cache(maxsize=256)
def _cap_layers(fx: int, fy: int, r: int):
    """The pixel writes of an AA cap (a filled circle of radius `r` whose
    centre lies `fx`, `fy` (16.16) past a pixel), away from the image's
    edges: per layer, each pixel's k-th write, as (dy, dx, weight) about the
    centre's pixel. Pixels are written in the order cv2 writes them."""
    global _RECORD
    ext = (r >> XY_SHIFT) + 4
    canvas = np.zeros((2 * ext + 1, 2 * ext + 1, 3), np.uint8)
    _RECORD = []
    try:
        _fill_convex_poly(canvas, _ellipse_vertices((ext << XY_SHIFT) + fx, (ext << XY_SHIFT) + fy, r),
                          np.zeros(3, np.uint8), XY_SHIFT, LINE_AA)
        ops = _RECORD
    finally:
        _RECORD = None
    hits, layers = {}, []
    for ys, xs, a in ops:
        for y, x, weight in zip(ys.tolist(), xs.tolist(), a.reshape(-1).tolist()):
            k = hits[y, x] = hits.get((y, x), -1) + 1
            if k == len(layers):
                layers.append(([], [], []))
            for dst, value in zip(layers[k], (y - ext, x - ext, weight)):
                dst.append(value)
    return tuple((np.asarray(dy), np.asarray(dx), np.asarray(wt)[:, None]) for dy, dx, wt in layers)


@lru_cache(maxsize=256)
def _cap_lut(fx: int, fy: int, r: int, color):
    """An AA cap's pixels (dy, dx about the centre's pixel) and, per pixel
    and channel, the value its writes leave for each value before them
    (n, 3, 256) uint8: the layers of `_cap_layers` applied to 0..255."""
    layers = _cap_layers(fx, fy, r)
    pixels = sorted({(y, x) for dy, dx, _ in layers for y, x in zip(dy.tolist(), dx.tolist())})
    where = {p: i for i, p in enumerate(pixels)}
    out = np.broadcast_to(np.arange(256, dtype=np.int64), (len(pixels), 3, 256)).copy()
    c = np.asarray(color, np.int64)[None, :, None]
    for dy, dx, a in layers:
        rows = [where[p] for p in zip(dy.tolist(), dx.tolist())]
        px, w = out[rows], a[:, :, None]
        px += ((c - px) * w + 127) >> 8
        px += ((c - px) * w + 127) >> 8
        out[rows] = px
    dy, dx = (np.asarray(v, np.int64) for v in zip(*pixels))
    return dy, dx, out.astype(np.uint8)


_LUT_CHANNEL = np.arange(3, dtype=np.int64)[None, :]


def _fill_ellipse_aa(img, cx: int, cy: int, r: int, color) -> None:
    """cv2's EllipseEx filled at LINE_AA for a circle of radius `r` about
    (cx, cy) (16.16): ellipse2Poly's vertices filled as a convex polygon.
    Away from the image's edges its writes come from `_cap_layers`."""
    h, w = img.shape[:2]
    px, py, ext = cx >> XY_SHIFT, cy >> XY_SHIFT, (r >> XY_SHIFT) + 4
    if _RECORD is None and ext <= px < w - ext and ext <= py < h - ext:
        dy, dx, lut = _cap_lut(cx & (XY_ONE - 1), cy & (XY_ONE - 1), r, tuple(int(c) for c in color))
        ys, xs = dy + py, dx + px
        img[ys, xs] = lut[np.arange(len(ys))[:, None], _LUT_CHANNEL, img[ys, xs]]
        return
    _fill_convex_poly(img, _ellipse_vertices(cx, cy, r), color, XY_SHIFT, LINE_AA)


def _thick_line(img, p0x, p0y, p1x, p1y, color, thickness: int, line_type: int, flags: int, shift: int):
    """cv2's ThickLine: endpoints in fixed point with `shift` fraction bits;
    `flags` bit 0 / bit 1 put a cap on the start / end."""
    if thickness > 1:
        # a thick segment is first clipped to the image grown by the
        # thickness on every side (in its own fixed point)
        h, w = img.shape[:2]
        m = thickness << shift
        inside, p0x, p0y, p1x, p1y = clip_line((w << shift) + 2 * m, (h << shift) + 2 * m,
                                               p0x + m, p0y + m, p1x + m, p1y + m)
        if not inside:
            return
        p0x, p0y, p1x, p1y = p0x - m, p0y - m, p1x - m, p1y - m
    p0x, p0y = p0x << (XY_SHIFT - shift), p0y << (XY_SHIFT - shift)
    p1x, p1y = p1x << (XY_SHIFT - shift), p1y << (XY_SHIFT - shift)
    if thickness <= 1 and line_type == LINE_AA:
        _line_aa(img, p0x, p0y, p1x, p1y, color)
        return
    if thickness <= 1:
        # cv2 (5.x) rounds a thin line's endpoints to pixels, fixed-point or
        # not, and walks them with LineIterator
        r = XY_ONE >> 1
        _line8(img, (p0x + r) >> XY_SHIFT, (p0y + r) >> XY_SHIFT, (p1x + r) >> XY_SHIFT,
               (p1y + r) >> XY_SHIFT, color)
        return
    dx = (p0x - p1x) / XY_ONE
    dy = (p1y - p0y) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    thick = thickness << (XY_SHIFT - 1)
    if abs(r) > 2.220446049250313e-16:
        r = (thick + odd * XY_ONE * 0.5) / math.sqrt(r)
        dpx, dpy = _round(dy * r), _round(dx * r)
        quad = [(p0x + dpx, p0y + dpy), (p0x - dpx, p0y - dpy), (p1x - dpx, p1y - dpy), (p1x + dpx, p1y + dpy)]
        _fill_convex_poly(img, quad, color, XY_SHIFT, line_type)
    for i in range(2):
        if flags & (i + 1):
            if line_type == LINE_AA:
                _fill_ellipse_aa(img, p0x, p0y, thick, color)
            else:
                cx = (p0x + (XY_ONE >> 1)) >> XY_SHIFT
                cy = (p0y + (XY_ONE >> 1)) >> XY_SHIFT
                _fill_circle(img, cx, cy, (thick + (XY_ONE >> 1)) >> XY_SHIFT, color)
        p0x, p0y = p1x, p1y


def _round(x: float) -> int:
    """cvRound: round half to even."""
    return int(round(x))


def _poly_line(img, pts, closed: bool, color, thickness: int, line_type: int, shift: int) -> None:
    """cv2's PolyLine over fixed-point vertices."""
    if not len(pts):
        return
    i = len(pts) - 1 if closed else 0
    flags = 2 + (not closed)
    p0 = pts[i]
    for i in range(0 if closed else 1, len(pts)):
        p = pts[i]
        _thick_line(img, p0[0], p0[1], p[0], p[1], color, thickness, line_type, flags, shift)
        p0 = p
        flags = 2


def fill_convex_poly(img: np.ndarray, points, color) -> np.ndarray:
    """cv2.fillConvexPoly(img, points, color) at LINE_8."""
    _check(img)
    verts = [_point(p) for p in np.asarray(points).reshape(-1, 2)]
    _fill_convex_poly(img, verts, _color(color), 0)
    return img


def line(img: np.ndarray, pt1, pt2, color, thickness: int = 1, lineType: int = LINE_8) -> np.ndarray:
    """cv2.line(img, pt1, pt2, color, thickness, lineType), in place."""
    _check(img)
    x1, y1 = _point(pt1)
    x2, y2 = _point(pt2)
    _thick_line(img, x1, y1, x2, y2, _color(color), int(thickness), lineType, 3, 0)
    return img


def arrowed_line(img: np.ndarray, pt1, pt2, color, thickness: int = 1, line_type: int = LINE_8,
                 tipLength: float = 0.1) -> np.ndarray:
    """cv2.arrowedLine(img, pt1, pt2, color, thickness, line_type, 0,
    tipLength): the line, then a stroke from each tip point to `pt2`, the
    tip points `tipLength * |pt2 - pt1|` from `pt2` at the shaft's angle
    +-45 degrees, rounded half to even (cvRound)."""
    x1, y1 = _point(pt1)
    x2, y2 = _point(pt2)
    tip = math.hypot(x1 - x2, y1 - y2) * tipLength
    line(img, (x1, y1), (x2, y2), color, thickness, line_type)
    angle = math.atan2(y1 - y2, x1 - x2)
    for turn in (math.pi / 4, -math.pi / 4):
        p = (int(round(x2 + tip * math.cos(angle + turn))), int(round(y2 + tip * math.sin(angle + turn))))
        line(img, p, (x2, y2), color, thickness, line_type)
    return img


def polylines(img: np.ndarray, pts, isClosed: bool, color, thickness: int = 1,
              lineType: int = LINE_8) -> np.ndarray:
    """cv2.polylines(img, [pts, ...], isClosed, color, thickness, lineType)."""
    _check(img)
    c = _color(color)
    for poly in pts:
        verts = [_point(p) for p in np.asarray(poly).reshape(-1, 2)]
        _poly_line(img, verts, bool(isClosed), c, int(thickness), lineType, 0)
    return img


def rectangle(img: np.ndarray, pt1, pt2, color, thickness: int = 1, lineType: int = LINE_8) -> np.ndarray:
    """cv2.rectangle(img, pt1, pt2, color, thickness, lineType): a closed
    polyline through the four corners (thickness >= 1)."""
    _check(img)
    x1, y1 = _point(pt1)
    x2, y2 = _point(pt2)
    _poly_line(img, [(x1, y1), (x2, y1), (x2, y2), (x1, y2)], True, _color(color), int(thickness), lineType, 0)
    return img


# ---------------------------------------------------------------------------
# text
# ---------------------------------------------------------------------------

def _font():
    from sfa3d_tpu_torch.viz import hershey

    return hershey


def _pixel_size(font_scale: float) -> int:
    """The font's pixel size at `font_scale`; only the sizes of fontScale
    0.4, 0.5, 0.8 and 1.0 are tabulated."""
    font = _font()
    size = _round(font.HEIGHT / 1000.0 * font_scale)
    if size not in font.SIZES:
        raise ValueError(f"text is drawn at fontScale 0.4, 0.5, 0.8 or 1.0 only, not {font_scale}")
    return size


def get_text_size(text: str, fontFace: int, fontScale: float, thickness: int):
    """cv2.getTextSize: ((width, height), baseline). The height is the
    font's pixel size, the width one more than the sum of the whole-pixel
    advances, the baseline the deepest descent."""
    if fontFace != FONT_HERSHEY_SIMPLEX:
        raise ValueError("only FONT_HERSHEY_SIMPLEX is available")
    size = _pixel_size(fontScale)
    width, baseline = 1, 0
    for ch in text:
        adv, desc = _font().metrics(ch, thickness, size)
        width += adv
        baseline = max(baseline, desc)
    return (width, size), baseline


def put_text(img: np.ndarray, text: str, org, fontFace: int, fontScale: float, color,
             thickness: int = 1, lineType: int = LINE_8) -> np.ndarray:
    """cv2.putText(img, text, org, fontFace, fontScale, color, thickness,
    lineType): glyph after glyph, each coverage block blended toward
    `color` as (bg * (255 - a) + color * a + 127) // 255, the pen advancing
    by whole pixels from `org` on the baseline. cv2 draws the same
    anti-aliased glyphs at every line type."""
    _check(img)
    if fontFace != FONT_HERSHEY_SIMPLEX:
        raise ValueError("only FONT_HERSHEY_SIMPLEX is available")
    c = _color(color).astype(np.int32)
    h, w = img.shape[:2]
    pen, oy = _point(org)
    size = _pixel_size(fontScale)
    weight = 2 if thickness >= 2 else 1
    for ch in text:
        x0, y0, alpha = _font().block(ch, weight, size)
        xa, ya = pen + x0, oy + y0
        pen += _font().metrics(ch, thickness, size)[0]
        cx0, cy0 = max(xa, 0), max(ya, 0)
        cx1, cy1 = min(xa + alpha.shape[1], w), min(ya + alpha.shape[0], h)
        if cx0 >= cx1 or cy0 >= cy1:
            continue
        a = alpha[cy0 - ya:cy1 - ya, cx0 - xa:cx1 - xa, None].astype(np.int32)
        bg = img[cy0:cy1, cx0:cx1].astype(np.int32)
        img[cy0:cy1, cx0:cx1] = ((bg * (255 - a) + c * a + 127) // 255).astype(np.uint8)
    return img


# ---------------------------------------------------------------------------
# whole-image operations
# ---------------------------------------------------------------------------


def rotate_180(img: np.ndarray) -> np.ndarray:
    """cv2.rotate(img, cv2.ROTATE_180)."""
    return np.ascontiguousarray(img[::-1, ::-1])


def vconcat(images: Sequence[np.ndarray]) -> np.ndarray:
    """cv2.vconcat: images of one width stacked top to bottom."""
    return np.ascontiguousarray(np.concatenate(list(images), axis=0))


def resize(img: np.ndarray, dsize) -> np.ndarray:
    """cv2.resize(img, (width, height)) with INTER_LINEAR, uint8, bit for
    bit (`models/yolov8.py::_resize_uint8`)."""
    from sfa3d_tpu_torch.models.yolov8 import _resize_uint8

    nw, nh = int(dsize[0]), int(dsize[1])
    if (nh, nw) == img.shape[:2]:
        return img.copy()
    return _resize_uint8(img, nh, nw)


# cv2.COLORMAP_JET as a 256 x 3 BGR table (cv2.applyColorMap of 0..255),
# 768 bytes as hex; scripts/torch_hershey_table.py checks it against cv2.
_JET_HEX = (
    "8000008400008800008c00009000009400009800009c0000a00000a40000a80000ac0000b00000b40000b80000bc0000"
    "c00000c40000c80000cc0000d00000d40000d80000dc0000e00000e40000e80000ec0000f00000f40000f80000fc0000"
    "ff0000ff0400ff0800ff0c00ff1000ff1400ff1800ff1c00ff2000ff2400ff2800ff2c00ff3000ff3400ff3800ff3c00"
    "ff4000ff4400ff4800ff4c00ff5000ff5400ff5800ff5c00ff6000ff6400ff6800ff6c00ff7000ff7400ff7800ff7c00"
    "ff8000ff8400ff8800ff8c00ff9000ff9400ff9800ff9c00ffa000ffa400ffa800ffac00ffb000ffb400ffb800ffbc00"
    "ffc000ffc400ffc800ffcc00ffd000ffd400ffd800ffdc00ffe000ffe400ffe800ffec00fff000fff400fff800fffc00"
    "feff02faff06f6ff0af2ff0eeeff12eaff16e6ff1ae2ff1edeff22daff26d6ff2ad2ff2eceff32caff36c6ff3ac2ff3e"
    "beff42baff46b6ff4ab2ff4eaeff52aaff56a6ff5aa2ff5e9eff629aff6696ff6a92ff6e8eff728aff7686ff7a82ff7e"
    "7eff827aff8676ff8a72ff8e6eff926aff9666ff9a62ff9e5effa25affa656ffaa52ffae4effb24affb646ffba42ffbe"
    "3effc23affc636ffca32ffce2effd22affd626ffda22ffde1effe21affe616ffea12ffee0efff20afff606fffa01fffe"
    "00fcff00f8ff00f4ff00f0ff00ecff00e8ff00e4ff00e0ff00dcff00d8ff00d4ff00d0ff00ccff00c8ff00c4ff00c0ff"
    "00bcff00b8ff00b4ff00b0ff00acff00a8ff00a4ff00a0ff009cff0098ff0094ff0090ff008cff0088ff0084ff0080ff"
    "007cff0078ff0074ff0070ff006cff0068ff0064ff0060ff005cff0058ff0054ff0050ff004cff0048ff0044ff0040ff"
    "003cff0038ff0034ff0030ff002cff0028ff0024ff0020ff001cff0018ff0014ff0010ff000cff0008ff0004ff0000ff"
    "0000fc0000f80000f40000f00000ec0000e80000e40000e00000dc0000d80000d40000d00000cc0000c80000c40000c0"
    "0000bc0000b80000b40000b00000ac0000a80000a40000a000009c00009800009400009000008c000088000084000080"
)
JET_BGR = np.frombuffer(bytes.fromhex(_JET_HEX), np.uint8).reshape(256, 3)


def apply_colormap_jet(gray: np.ndarray) -> np.ndarray:
    """cv2.applyColorMap(gray, cv2.COLORMAP_JET): (H, W) uint8 -> (H, W, 3)
    BGR uint8."""
    gray = np.asarray(gray)
    if gray.dtype != np.uint8:
        raise ValueError("apply_colormap_jet takes a uint8 image")
    return JET_BGR[gray]
