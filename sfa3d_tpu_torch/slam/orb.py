"""An ORB feature detector and descriptor owned by the port: the counterpart
of `cv2.ORB_create(nfeatures=5000)` at cv2's defaults (scaleFactor 1.2,
nlevels 8, edgeThreshold 31, patchSize 31, fastThreshold 20, HARRIS_SCORE,
WTA_K 2), aimed at cv2's output stage by stage:

- the pyramid: each level resized from the one before with cv2's
  fixed-point INTER_LINEAR_EXACT (8-bit coefficients, one rounding), at
  the size cvRound(side / 1.2**level) in float32;
- the per-level feature budget, in float32 as cv2 computes it;
- FAST-9/16 at threshold 20 with non-maximum suppression and cv2's integer
  score (the largest arc minimum of |centre - ring| over nine contiguous
  ring pixels, less one);
- the border filter (31 px), then `retain_best` by FAST score (twice the
  budget), the Harris response (7 x 7 block, k 0.04, integer sums, cv2's
  float32 order of operations), then `retain_best` by Harris to the budget;
  `retain_best` keeps every point tied with the last one kept and leaves
  them in the order of libstdc++'s nth_element and partition, as
  KeyPointsFilter::retainBest does;
- the intensity-centroid angle of the 31 px circular patch through cv2's
  fastAtan2 polynomial in float32;
- the 7 x 7, sigma 2 Gaussian blur of each level as cv2 runs it on a
  pyramid level: its separable float32 filter, reflect-101 borders;
- rBRIEF: 256 intensity comparisons over `BIT_PATTERN_31`, the offsets
  rotated by the keypoint's angle in float32 and rounded half to even;
- the keypoints scaled back to level 0.

The dense stages (pyramid, FAST ring tests, Harris and moment sums, blur,
the 256 comparisons per keypoint) are torch integer ops on the device; the
selections, the Harris and angle float32 formulas and the rotation
cos/sin run on the host in numpy, so the card and the CPU give the same
keypoints and descriptors.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from sfa3d_tpu_torch.device import Device, resolve_device

N_FEATURES = 5000
SCALE_FACTOR = float(np.float32(1.2))  # cv2 takes the factor as a float, 1.2f
N_LEVELS = 8
EDGE_THRESHOLD = 31
PATCH_SIZE = 31
FAST_THRESHOLD = 20
HARRIS_BLOCK = 7
HARRIS_K = np.float32(0.04)

# The 31 x 31 rBRIEF sampling pattern of OpenCV's ORB (`bit_pattern_31_`,
# modules/features2d/src/orb.cpp), 256 point pairs as (x1, y1, x2, y2).
# Copyright (C) 2009-2011, Willow Garage Inc.; OpenCV is distributed under
# the Apache 2 licence (3-clause BSD before 4.5). Read back from the cv2
# library and checked by scripts/torch_orb_pattern.py.
BIT_PATTERN_31 = np.array([
    8, -3, 9, 5, 4, 2, 7, -12, -11, 9, -8, 2, 7, -12, 12, -13,
    2, -13, 2, 12, 1, -7, 1, 6, -2, -10, -2, -4, -13, -13, -11, -8,
    -13, -3, -12, -9, 10, 4, 11, 9, -13, -8, -8, -9, -11, 7, -9, 12,
    7, 7, 12, 6, -4, -5, -3, 0, -13, 2, -12, -3, -9, 0, -7, 5,
    12, -6, 12, -1, -3, 6, -2, 12, -6, -13, -4, -8, 11, -13, 12, -8,
    4, 7, 5, 1, 5, -3, 10, -3, 3, -7, 6, 12, -8, -7, -6, -2,
    -2, 11, -1, -10, -13, 12, -8, 10, -7, 3, -5, -3, -4, 2, -3, 7,
    -10, -12, -6, 11, 5, -12, 6, -7, 5, -6, 7, -1, 1, 0, 4, -5,
    9, 11, 11, -13, 4, 7, 4, 12, 2, -1, 4, 4, -4, -12, -2, 7,
    -8, -5, -7, -10, 4, 11, 9, 12, 0, -8, 1, -13, -13, -2, -8, 2,
    -3, -2, -2, 3, -6, 9, -4, -9, 8, 12, 10, 7, 0, 9, 1, 3,
    7, -5, 11, -10, -13, -6, -11, 0, 10, 7, 12, 1, -6, -3, -6, 12,
    10, -9, 12, -4, -13, 8, -8, -12, -13, 0, -8, -4, 3, 3, 7, 8,
    5, 7, 10, -7, -1, 7, 1, -12, 3, -10, 5, 6, 2, -4, 3, -10,
    -13, 0, -13, 5, -13, -7, -12, 12, -13, 3, -11, 8, -7, 12, -4, 7,
    6, -10, 12, 8, -9, -1, -7, -6, -2, -5, 0, 12, -12, 5, -7, 5,
    3, -10, 8, -13, -7, -7, -4, 5, -3, -2, -1, -7, 2, 9, 5, -11,
    -11, -13, -5, -13, -1, 6, 0, -1, 5, -3, 5, 2, -4, -13, -4, 12,
    -9, -6, -9, 6, -12, -10, -8, -4, 10, 2, 12, -3, 7, 12, 12, 12,
    -7, -13, -6, 5, -4, 9, -3, 4, 7, -1, 12, 2, -7, 6, -5, 1,
    -13, 11, -12, 5, -3, 7, -2, -6, 7, -8, 12, -7, -13, -7, -11, -12,
    1, -3, 12, 12, 2, -6, 3, 0, -4, 3, -2, -13, -1, -13, 1, 9,
    7, 1, 8, -6, 1, -1, 3, 12, 9, 1, 12, 6, -1, -9, -1, 3,
    -13, -13, -10, 5, 7, 7, 10, 12, 12, -5, 12, 9, 6, 3, 7, 11,
    5, -13, 6, 10, 2, -12, 2, 3, 3, 8, 4, -6, 2, 6, 12, -13,
    9, -12, 10, 3, -8, 4, -7, 9, -11, 12, -4, -6, 1, 12, 2, -8,
    6, -9, 7, -4, 2, 3, 3, -2, 6, 3, 11, 0, 3, -3, 8, -8,
    7, 8, 9, 3, -11, -5, -6, -4, -10, 11, -5, 10, -5, -8, -3, 12,
    -10, 5, -9, 0, 8, -1, 12, -6, 4, -6, 6, -11, -10, 12, -8, 7,
    4, -2, 6, 7, -2, 0, -2, 12, -5, -8, -5, 2, 7, -6, 10, 12,
    -9, -13, -8, -8, -5, -13, -5, -2, 8, -8, 9, -13, -9, -11, -9, 0,
    1, -8, 1, -2, 7, -4, 9, 1, -2, 1, -1, -4, 11, -6, 12, -11,
    -12, -9, -6, 4, 3, 7, 7, 12, 5, 5, 10, 8, 0, -4, 2, 8,
    -9, 12, -5, -13, 0, 7, 2, 12, -1, 2, 1, 7, 5, 11, 7, -9,
    3, 5, 6, -8, -13, -4, -8, 9, -5, 9, -3, -3, -4, -7, -3, -12,
    6, 5, 8, 0, -7, 6, -6, 12, -13, 6, -5, -2, 1, -10, 3, 10,
    4, 1, 8, -4, -2, -2, 2, -13, 2, -12, 12, 12, -2, -13, 0, -6,
    4, 1, 9, 3, -6, -10, -3, -5, -3, -13, -1, 1, 7, 5, 12, -11,
    4, -2, 5, -7, -13, 9, -9, -5, 7, 1, 8, 6, 7, -8, 7, 6,
    -7, -4, -7, 1, -8, 11, -7, -8, -13, 6, -12, -8, 2, 4, 3, 9,
    10, -5, 12, 3, -6, -5, -6, 7, 8, -3, 9, -8, 2, -12, 2, 8,
    -11, -2, -10, 3, -12, -13, -7, -9, -11, 0, -10, -5, 5, -3, 11, 8,
    -2, -13, -1, 12, -1, -8, 0, 9, -13, -11, -12, -5, -10, -2, -10, 11,
    -3, 9, -2, -13, 2, -3, 3, 2, -9, -13, -4, 0, -4, 6, -3, -10,
    -4, 12, -2, -7, -6, -11, -4, 9, 6, -3, 6, 11, -13, 11, -5, 5,
    11, 11, 12, 6, 7, -5, 12, -2, -1, 12, 0, 7, -4, -8, -3, -2,
    -7, 1, -6, 7, -13, -12, -8, -13, -7, -2, -6, -8, -8, 5, -6, -9,
    -5, -1, -4, 5, -13, 7, -8, 10, 1, 5, 5, -13, 1, 0, 10, -13,
    9, 12, 10, -1, 5, -8, 10, -9, -1, 11, 1, -13, -9, -3, -6, 2,
    -1, -10, 1, 12, -13, 1, -8, -10, 8, -11, 10, -6, 2, -13, 3, -6,
    7, -13, 12, -9, -10, -10, -5, -7, -10, -8, -8, -13, 4, -6, 8, 5,
    3, 12, 8, -13, -4, 2, -3, -3, 5, -13, 10, -12, 4, -13, 5, -1,
    -9, 9, -4, 3, 0, 3, 3, -9, -12, 1, -6, 1, 3, 2, 4, -8,
    -10, -10, -10, 9, 8, -13, 12, 12, -8, -12, -6, -5, 2, 2, 3, 7,
    10, 6, 11, -8, 6, 8, 8, -12, -7, 10, -6, 5, -3, -9, -3, 9,
    -1, -13, -1, 5, -3, -7, -3, 4, -8, -2, -8, 3, 4, 2, 12, 12,
    2, -5, 3, 11, 6, -9, 11, -13, 3, -1, 7, 12, 11, -1, 12, 4,
    -3, 0, -3, 6, 4, -11, 4, 12, 2, -4, 2, 1, -10, -6, -8, 1,
    -13, 7, -11, 1, -13, 12, -11, -13, 6, 0, 11, -13, 0, -1, 1, 4,
    -13, 3, -9, -2, -9, 8, -6, -3, -13, -6, -8, -2, 5, -9, 8, 10,
    2, 7, 3, -9, -1, -6, -1, -1, 9, 5, 11, -2, 11, -3, 12, -8,
    3, 0, 3, 5, -1, 4, 0, 10, 3, -6, 4, 5, -13, 0, -10, 5,
    5, 8, 12, 11, 8, 9, 9, -6, 7, -4, 8, -12, -10, 4, -10, 9,
    7, 3, 12, 4, 9, -7, 10, -2, 7, 0, 12, -2, -1, -6, 0, -11,
], np.int32).reshape(512, 2)

# FAST-9/16's Bresenham ring of radius 3, as (dx, dy), in cv2's order
FAST_RING = ((0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
             (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2), (-1, 3))


def cv_round(x) -> np.ndarray:
    """cvRound: to the nearest integer, ties to even."""
    return np.rint(x).astype(np.int64)


# --- the pyramid -------------------------------------------------------------


def level_scales(n_levels: int = N_LEVELS, scale_factor: float = SCALE_FACTOR) -> np.ndarray:
    """(float)pow(scale_factor, level) per level, float32."""
    return np.array([np.float32(math.pow(scale_factor, level)) for level in range(n_levels)], np.float32)


def level_sizes(height: int, width: int, n_levels: int = N_LEVELS) -> List[Tuple[int, int]]:
    """(height, width) per level: cvRound(side * (1.f / scale)) in float32."""
    sizes = []
    for scale in level_scales(n_levels):
        inv = np.float32(1.0) / scale
        sizes.append((int(cv_round(np.float32(height) * inv)), int(cv_round(np.float32(width) * inv))))
    return sizes


def features_per_level(n_features: int = N_FEATURES, n_levels: int = N_LEVELS,
                       scale_factor: float = SCALE_FACTOR) -> List[int]:
    """The per-level feature budget, a geometric series in float32 whose last
    level takes what is left."""
    factor = np.float32(1.0 / scale_factor)
    one = np.float32(1.0)
    desired = np.float32(n_features) * (one - factor) / (one - np.float32(math.pow(float(factor), n_levels)))
    out, total = [], 0
    for _ in range(n_levels - 1):
        out.append(int(cv_round(desired)))
        total += out[-1]
        desired = np.float32(desired * factor)
    out.append(max(n_features - total, 0))
    return out


def _linear_exact_taps(src: int, dst: int):
    """Per output index: the source offset and the two 8-bit fixed-point
    weights of INTER_LINEAR_EXACT (positions in float64 as cv2's softdouble;
    outside the source, the edge sample at weight 256)."""
    scale = 1.0 / (dst / src)
    fval = scale * (np.arange(dst, dtype=np.float64) + 0.5) - 0.5
    ival = np.floor(fval).astype(np.int64)
    inside = (ival >= 0) & (ival < src - 1)
    c1 = np.where(inside, cv_round((fval - ival) * 256.0), 0)
    ofs = np.where(inside, ival, np.where(ival < 0, 0, src - 1))
    return ofs, np.minimum(ofs + 1, src - 1), 256 - c1, c1


def resize_linear_exact(img: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """cv2.resize(img, (width, height), interpolation=INTER_LINEAR_EXACT) of
    an (H, W) uint8 tensor: the rows interpolated to 8 fractional bits
    exactly, then the columns, one rounding at the end."""
    dev = img.device
    x0, x1, wx0, wx1 = (torch.as_tensor(a, device=dev) for a in _linear_exact_taps(img.shape[1], width))
    y0, y1, wy0, wy1 = (torch.as_tensor(a, device=dev) for a in _linear_exact_taps(img.shape[0], height))
    src = img.to(torch.int32)
    h = src[:, x0] * wx0.to(torch.int32) + src[:, x1] * wx1.to(torch.int32)
    out = h[y0] * wy0.to(torch.int32)[:, None] + h[y1] * wy1.to(torch.int32)[:, None]
    return ((out + 32768) >> 16).clamp_(0, 255).to(torch.uint8)


def build_pyramid(grey: torch.Tensor, n_levels: int = N_LEVELS) -> List[torch.Tensor]:
    """Level 0 is the image; each next level is resized from the one before."""
    levels = [grey]
    for h, w in level_sizes(grey.shape[0], grey.shape[1], n_levels)[1:]:
        levels.append(resize_linear_exact(levels[-1], h, w))
    return levels


# --- FAST --------------------------------------------------------------------


def _arc_min9(d: torch.Tensor) -> torch.Tensor:
    """(16, ...) ring values -> the largest, over the 16 arcs of 9 contiguous
    ring pixels, of the arc's minimum."""
    ext = torch.cat([d, d[:8]])
    m2 = torch.minimum(ext[:-1], ext[1:])
    m4 = torch.minimum(m2[:-2], m2[2:])
    m8 = torch.minimum(m4[:-4], m4[4:])
    return torch.minimum(m8[:16], ext[8:24]).amax(0)


def fast_score_map(img: torch.Tensor, threshold: int = FAST_THRESHOLD) -> torch.Tensor:
    """(H, W) int16 FAST-9/16 scores, 0 where there is no corner: a pixel is
    a corner when nine contiguous ring pixels are all brighter than centre +
    t or all darker than centre - t, and its score is cv2's cornerScore, the
    largest arc minimum of the signed differences (either sign) less one.
    Rows and columns within 3 px of the border are never corners."""
    H, W = img.shape
    out = torch.zeros((H, W), dtype=torch.int16, device=img.device)
    if H < 7 or W < 7:
        return out
    src = img.to(torch.int16)
    v = src[3:H - 3, 3:W - 3]
    d = torch.stack([v - src[3 + dy:H - 3 + dy, 3 + dx:W - 3 + dx] for dx, dy in FAST_RING])
    raw = torch.maximum(_arc_min9(d), _arc_min9(-d))
    out[3:H - 3, 3:W - 3] = torch.where(raw > threshold, raw - 1, torch.zeros_like(raw))
    return out


def fast_corners(img: torch.Tensor, threshold: int = FAST_THRESHOLD):
    """cv2.FastFeatureDetector_create(threshold, True).detect(img): the
    corners whose score is larger than each of their 8 neighbours' (0 for
    non-corners), in raster order. Returns host arrays (x, y, score)."""
    s = fast_score_map(img, threshold)
    p = torch.nn.functional.pad(s[None, None].to(torch.int32), (1, 1, 1, 1))[0, 0]
    H, W = s.shape
    centre = p[1:H + 1, 1:W + 1]
    keep = centre > 0
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            if dy != 1 or dx != 1:
                keep &= centre > p[dy:dy + H, dx:dx + W]
    ys, xs = torch.nonzero(keep, as_tuple=True)
    scores = centre[ys, xs]
    return xs.cpu().numpy(), ys.cpu().numpy(), scores.cpu().numpy()


# --- selection, Harris, angle ---------------------------------------------------


class _Greater:
    """libstdc++'s std::nth_element and std::partition, step for step, on a
    list of point indices ordered by `key` under KeypointResponseGreater
    (a.response > b.response): they fix the order of the points cv2 keeps."""

    def __init__(self, key):
        self.key = key

    def __call__(self, i, j) -> bool:
        return self.key[i] > self.key[j]

    def _adjust_heap(self, a, first, hole, length, value):
        top = hole
        child = hole
        while child < (length - 1) // 2:
            child = 2 * (child + 1)
            if self(a[first + child], a[first + child - 1]):
                child -= 1
            a[first + hole] = a[first + child]
            hole = child
        if length % 2 == 0 and child == (length - 2) // 2:
            child = 2 * (child + 1)
            a[first + hole] = a[first + child - 1]
            hole = child - 1
        parent = (hole - 1) // 2
        while hole > top and self(a[first + parent], value):
            a[first + hole] = a[first + parent]
            hole = parent
            parent = (hole - 1) // 2
        a[first + hole] = value

    def _heap_select(self, a, first, middle, last):
        length = middle - first
        if length >= 2:
            for parent in range((length - 2) // 2, -1, -1):
                self._adjust_heap(a, first, parent, length, a[first + parent])
        for i in range(middle, last):
            if self(a[i], a[first]):
                value = a[i]
                a[i] = a[first]
                self._adjust_heap(a, first, 0, length, value)

    def _insertion_sort(self, a, first, last):
        for i in range(first + 1, last):
            value = a[i]
            if self(value, a[first]):
                a[first + 1:i + 1] = a[first:i]
                a[first] = value
            else:
                j = i
                while self(value, a[j - 1]):
                    a[j] = a[j - 1]
                    j -= 1
                a[j] = value

    def _median_to_first(self, a, result, x, y, z):
        if self(a[x], a[y]):
            pick = y if self(a[y], a[z]) else (z if self(a[x], a[z]) else x)
        elif self(a[x], a[z]):
            pick = x
        else:
            pick = z if self(a[y], a[z]) else y
        a[result], a[pick] = a[pick], a[result]

    def _partition_pivot(self, a, first, last):
        self._median_to_first(a, first, first + 1, first + (last - first) // 2, last - 1)
        pivot, lo, hi = a[first], first + 1, last
        while True:
            while self(a[lo], pivot):
                lo += 1
            hi -= 1
            while self(pivot, a[hi]):
                hi -= 1
            if not lo < hi:
                return lo
            a[lo], a[hi] = a[hi], a[lo]
            lo += 1

    def nth_element(self, a, nth):
        first, last = 0, len(a)
        if first == last or nth == last:
            return
        depth = 2 * (last.bit_length() - 1)
        while last - first > 3:
            if depth == 0:
                self._heap_select(a, first, nth + 1, last)
                a[first], a[nth] = a[nth], a[first]
                return
            depth -= 1
            cut = self._partition_pivot(a, first, last)
            if cut <= nth:
                first = cut
            else:
                last = cut
        self._insertion_sort(a, first, last)

    @staticmethod
    def partition(a, first, pred) -> int:
        last = len(a)
        while True:
            while True:
                if first == last:
                    return first
                if not pred(a[first]):
                    break
                first += 1
            last -= 1
            while True:
                if first == last:
                    return first
                if pred(a[last]):
                    break
                last -= 1
            a[first], a[last] = a[last], a[first]
            first += 1


def retain_best(responses: np.ndarray, n: int) -> np.ndarray:
    """KeyPointsFilter::retainBest: the indices of the points kept, in the
    order cv2 leaves them. With more than n points, std::nth_element puts
    the n best first, and std::partition then gathers every later point
    tied with the n-th, so all ties with the last one kept stay."""
    order = list(range(responses.shape[0]))
    if n < 0 or len(order) <= n:
        return np.asarray(order, np.int64)
    if n == 0:
        return np.zeros(0, np.int64)
    key = [float(r) for r in responses]
    greater = _Greater(key)
    greater.nth_element(order, n - 1)
    boundary = key[order[n - 1]]
    end = greater.partition(order, n, lambda i: key[i] >= boundary)
    return np.asarray(order[:end], np.int64)


def _patches(img: torch.Tensor, xs: np.ndarray, ys: np.ndarray, radius: int) -> torch.Tensor:
    """(K, 2r+1, 2r+1) int32 windows of img centred on (x, y)."""
    off = torch.arange(-radius, radius + 1, device=img.device)
    yy = torch.as_tensor(ys, device=img.device)[:, None, None] + off[None, :, None]
    xx = torch.as_tensor(xs, device=img.device)[:, None, None] + off[None, None, :]
    return img[yy, xx].to(torch.int32)


def harris_sums(img: torch.Tensor, xs: np.ndarray, ys: np.ndarray) -> np.ndarray:
    """(K, 3) int64 (sum Ix^2, sum Iy^2, sum Ix*Iy) over the 7 x 7 block at
    each point, with cv2's 3 x 3 Sobel-like integer gradients."""
    if len(xs) == 0:
        return np.zeros((0, 3), np.int64)
    p = _patches(img, xs, ys, HARRIS_BLOCK // 2 + 1)  # (K, 9, 9)
    c = slice(1, -1)
    ix = (p[:, c, 2:] - p[:, c, :-2]) * 2 + (p[:, :-2, 2:] - p[:, :-2, :-2]) + (p[:, 2:, 2:] - p[:, 2:, :-2])
    iy = (p[:, 2:, c] - p[:, :-2, c]) * 2 + (p[:, 2:, :-2] - p[:, :-2, :-2]) + (p[:, 2:, 2:] - p[:, :-2, 2:])
    sums = torch.stack([(ix * ix).sum((1, 2)), (iy * iy).sum((1, 2)), (ix * iy).sum((1, 2))], dim=1)
    return sums.cpu().numpy().astype(np.int64)


def harris_response(sums: np.ndarray) -> np.ndarray:
    """cv2's float32 Harris response from the integer sums:
    ((a*b - c*c) - k*(a+b)*(a+b)) * scale**4, scale = 1 / (4 * 7 * 255)."""
    f = np.float32
    a, b, c = (sums[:, i].astype(np.float32) for i in range(3))
    scale = f(1.0) / f(4 * HARRIS_BLOCK * 255.0)
    scale4 = f(f(f(scale * scale) * scale) * scale)
    ab = f(a + b)
    return ((a * b - c * c) - (HARRIS_K * ab) * ab) * scale4


def _umax(half: int = PATCH_SIZE // 2) -> np.ndarray:
    """The half-width of each row of ORB's circular patch (symmetric)."""
    umax = np.zeros(half + 2, np.int64)
    vmax = int(math.floor(half * float(np.sqrt(np.float32(2.0))) / 2 + 1))
    vmin = int(math.ceil(half * float(np.sqrt(np.float32(2.0))) / 2))
    for v in range(vmax + 1):
        umax[v] = cv_round(math.sqrt(float(half * half - v * v)))
    v0 = 0
    for v in range(half, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return umax


def _moment_weights(device) -> Tuple[torch.Tensor, torch.Tensor]:
    half = PATCH_SIZE // 2
    umax = _umax(half)
    off = np.arange(-half, half + 1)
    inside = np.abs(off[None, :]) <= umax[np.abs(off)][:, None]
    wu = torch.as_tensor(np.where(inside, off[None, :], 0), dtype=torch.int32, device=device)
    wv = torch.as_tensor(np.where(inside, off[:, None], 0), dtype=torch.int32, device=device)
    return wu, wv


def fast_atan2(y: np.ndarray, x: np.ndarray) -> np.ndarray:
    """cv::fastAtan2 in float32: degrees in [0, 360) from a degree-7
    polynomial."""
    f = np.float32
    deg = f(180 / math.pi)
    p1, p3 = f(f(0.9997878412794807) * deg), f(f(-0.3258083974640975) * deg)
    p5, p7 = f(f(0.1555786518463281) * deg), f(f(-0.04432655554792128) * deg)
    eps = f(np.finfo(np.float64).eps)
    y, x = np.asarray(y, np.float32), np.asarray(x, np.float32)
    ax, ay = np.abs(x), np.abs(y)
    flat = ax >= ay
    c = np.where(flat, ay / (ax + eps), ax / (ay + eps)).astype(np.float32)
    c2 = c * c
    poly = (((p7 * c2 + p5) * c2 + p3) * c2 + p1) * c
    a = np.where(flat, poly, f(90.0) - poly)
    a = np.where(x < 0, f(180.0) - a, a)
    return np.where(y < 0, f(360.0) - a, a).astype(np.float32)


def ic_angles(img: torch.Tensor, xs: np.ndarray, ys: np.ndarray) -> np.ndarray:
    """The intensity-centroid orientation (degrees, float32) of the circular
    31 px patch at each point."""
    if len(xs) == 0:
        return np.zeros(0, np.float32)
    p = _patches(img, xs, ys, PATCH_SIZE // 2)
    wu, wv = _moment_weights(img.device)
    m = torch.stack([(p * wv).sum((1, 2)), (p * wu).sum((1, 2))], dim=1).cpu().numpy()
    return fast_atan2(m[:, 0].astype(np.float32), m[:, 1].astype(np.float32))


# --- the descriptor ------------------------------------------------------------


def gaussian_taps(ksize: int = 7, sigma: float = 2.0) -> np.ndarray:
    """cv2.getGaussianKernel(ksize, sigma, CV_32F): exp(-x^2 / (2 sigma^2))
    normalized to sum 1 in float64, then rounded to float32."""
    n2 = (ksize - 1) // 2
    scale2 = -0.125 / (sigma * sigma)
    side = [math.exp(float(x * x) * scale2) for x in range(1 - ksize, 0, 2)][:n2]
    mul = 1.0 / (sum(side) * 2.0 + 1.0)
    side = [v * mul for v in side]
    return np.array(side + [mul] + side[::-1], np.float32)


def gaussian_blur(img: torch.Tensor) -> torch.Tensor:
    """GaussianBlur(img, (7, 7), 2, 2, BORDER_REFLECT_101) of an (H, W) uint8
    tensor as cv2 runs it on a pyramid level (a sub-matrix, so not its
    8-bit fixed-point path but the separable float32 filter): each row pass
    a fused multiply-add chain over the taps from left to right, each
    column pass the centre tap times the centre row plus the symmetric row
    pairs outwards, every step rounded to float32; then rounded half to
    even and saturated to 255. A fused multiply-add is exact in float64
    here (a float32 tap times an 8-bit or float32 value, plus a float32
    sum), so the chain runs in float64 with a float32 rounding per step."""
    taps = gaussian_taps()
    r = len(taps) // 2
    H, W = img.shape
    x = torch.nn.functional.pad(img[None, None].to(torch.float32), (r, r, r, r), mode="reflect")[0, 0]
    x = x.to(torch.float64)
    f32, f64 = torch.float32, torch.float64
    rows = (x[:, 0:W] * float(taps[0])).to(f32)
    for i in range(1, len(taps)):
        rows = (x[:, i:i + W] * float(taps[i]) + rows.to(f64)).to(f32)
    out = (rows[r:r + H].to(f64) * float(taps[r])).to(f32)
    for k in range(1, r + 1):
        pair = rows[r + k:r + k + H] + rows[r - k:r - k + H]
        out = (pair.to(f64) * float(taps[r + k]) + out.to(f64)).to(f32)
    return torch.round(out).clamp_(0, 255).to(torch.uint8)


def rotation(angles: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(cos, sin) of each angle (degrees) in float32, as cv2's descriptor
    stage takes them: the angle scaled by (float)(pi / 180) in float32."""
    rad = np.asarray(angles, np.float32) * np.float32(math.pi / 180.0)
    return np.cos(rad.astype(np.float64)).astype(np.float32), np.sin(rad.astype(np.float64)).astype(np.float32)


def rbrief(blurred: torch.Tensor, xs: np.ndarray, ys: np.ndarray, angles: np.ndarray) -> torch.Tensor:
    """(K, 32) uint8 rBRIEF descriptors on a blurred level at integer centres
    (x, y): bit j of byte i compares the pattern's pair 8 i + j, each offset
    rotated in float32 (x a - y b, x b + y a) and rounded half to even."""
    dev = blurred.device
    if len(xs) == 0:
        return torch.zeros((0, 32), dtype=torch.uint8, device=dev)
    a, b = (torch.as_tensor(v, device=dev)[:, None] for v in rotation(angles))
    px = torch.as_tensor(BIT_PATTERN_31[:, 0], dtype=torch.float32, device=dev)[None]
    py = torch.as_tensor(BIT_PATTERN_31[:, 1], dtype=torch.float32, device=dev)[None]
    ix = torch.round(px * a - py * b).to(torch.int64)
    iy = torch.round(px * b + py * a).to(torch.int64)
    cx = torch.as_tensor(xs, device=dev)[:, None]
    cy = torch.as_tensor(ys, device=dev)[:, None]
    vals = blurred[cy + iy, cx + ix]
    bits = (vals[:, 0::2] < vals[:, 1::2]).to(torch.int32).reshape(-1, 32, 8)
    weights = (1 << torch.arange(8, device=dev, dtype=torch.int32))
    return (bits * weights).sum(-1).to(torch.uint8)


# --- the detector ----------------------------------------------------------------


def _as_grey(grey, device: torch.device) -> torch.Tensor:
    t = torch.as_tensor(np.ascontiguousarray(grey)) if not isinstance(grey, torch.Tensor) else grey
    if t.dtype != torch.uint8 or t.dim() != 2:
        raise ValueError(f"expected an (H, W) uint8 grey image; got {t.dtype} {tuple(t.shape)}")
    return t.to(device)


def _in_border(xs, ys, height: int, width: int, border: int = EDGE_THRESHOLD) -> np.ndarray:
    """KeyPointsFilter::runByImageBorder as a mask: x in [b, W - b), y in
    [b, H - b); nothing survives on an image at most 2 b on a side."""
    if height <= 2 * border or width <= 2 * border:
        return np.zeros(len(xs), bool)
    return (xs >= border) & (xs < width - border) & (ys >= border) & (ys < height - border)


def detect_and_compute(grey, n_features: int = N_FEATURES, device: Device = None,
                       timings: Dict[str, float] = None):
    """ORB keypoints and descriptors of an (H, W) uint8 image, as
    `cv2.ORB_create(n_features).detectAndCompute(grey, None)` gives them.

    Returns (keypoints, descriptors): keypoints is a dict of host arrays,
    `pt` (K, 2) float32 level-0 (x, y), `octave` (K,) int32, `angle`,
    `response` and `size` (K,) float32, grouped by level; descriptors is a
    (K, 32) uint8 tensor on the device (cuda unless "cpu"). With `timings`
    (a dict), the host milliseconds of each level's detection land there
    as `level{i}` and the descriptors' as `describe`."""
    dev = resolve_device(device)
    img = _as_grey(grey, dev)
    scales = level_scales()
    budget = features_per_level(n_features)
    pyramid = build_pyramid(img)
    per_level = []
    for level, lvl in enumerate(pyramid):
        t0 = time.perf_counter()
        xs, ys, score = fast_corners(lvl)
        inside = _in_border(xs, ys, lvl.shape[0], lvl.shape[1])
        xs, ys, score = xs[inside], ys[inside], score[inside]
        keep = retain_best(score.astype(np.float32), 2 * budget[level])
        xs, ys = xs[keep], ys[keep]
        per_level.append((xs, ys, harris_response(harris_sums(lvl, xs, ys))))
        if timings is not None:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            timings[f"level{level}"] = (time.perf_counter() - t0) * 1000.0
    t0 = time.perf_counter()
    pts, octave, angle, response, size, descs = [], [], [], [], [], []
    for level, (xs, ys, resp) in enumerate(per_level):
        keep = retain_best(resp, budget[level])
        xs, ys, resp = xs[keep], ys[keep], resp[keep]
        ang = ic_angles(pyramid[level], xs, ys)
        scale = scales[level]
        pts.append(np.stack([xs.astype(np.float32) * scale, ys.astype(np.float32) * scale], axis=1))
        octave.append(np.full(len(xs), level, np.int32))
        angle.append(ang)
        response.append(resp.astype(np.float32))
        size.append(np.full(len(xs), np.float32(PATCH_SIZE) * scale, np.float32))
        descs.append(_describe_level(pyramid[level], pts[-1], scale, ang))
    keypoints = {"pt": np.concatenate(pts).reshape(-1, 2), "octave": np.concatenate(octave),
                 "angle": np.concatenate(angle), "response": np.concatenate(response),
                 "size": np.concatenate(size)}
    descriptors = torch.cat(descs)
    if timings is not None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        timings["describe"] = (time.perf_counter() - t0) * 1000.0
    return keypoints, descriptors


def _describe_level(level_img: torch.Tensor, pts0: np.ndarray, scale: np.float32, angles) -> torch.Tensor:
    """Descriptors of level-0 points on their level: the centre is
    cvRound(pt * (1.f / scale)) in float32, the level is blurred first."""
    inv = np.float32(1.0) / scale
    cx = cv_round(pts0[:, 0].astype(np.float32) * inv)
    cy = cv_round(pts0[:, 1].astype(np.float32) * inv)
    return rbrief(gaussian_blur(level_img), cx, cy, angles)


def compute(grey, pts, octaves, angles, device: Device = None):
    """The descriptor stage alone, `orb.compute(grey, keypoints)`: given
    level-0 points (K, 2), octaves and angles (degrees), the points within
    31 px of the image border are dropped (as cv2 drops them) and the rest
    described. Returns (kept mask (K,) host bool, (K', 32) uint8 descriptors
    on the device), in the input's order."""
    dev = resolve_device(device)
    img = _as_grey(grey, dev)
    pts = np.asarray(pts, np.float32).reshape(-1, 2)
    octaves = np.asarray(octaves, np.int64)
    angles = np.asarray(angles, np.float32)
    keep = _in_border(pts[:, 0], pts[:, 1], img.shape[0], img.shape[1])
    n_levels = int(octaves.max()) + 1 if len(octaves) else 1
    pyramid = build_pyramid(img, n_levels)
    scales = level_scales(n_levels)
    out = torch.zeros((len(pts), 32), dtype=torch.uint8, device=dev)
    for level in range(n_levels):
        sel = np.flatnonzero(keep & (octaves == level))
        if len(sel):
            out[torch.as_tensor(sel, device=dev)] = _describe_level(pyramid[level], pts[sel], scales[level], angles[sel])
    return keep, out[torch.as_tensor(np.flatnonzero(keep), device=dev)]
