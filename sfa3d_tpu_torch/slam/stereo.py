"""Targetless stereo self-calibration, the port of `sfa3d_tpu/slam/stereo.py`.

The port's ORB (`slam/orb.py`) on both images, a brute-force Hamming
matcher with cross-check on the device, then fundamental-matrix RANSAC, the
essential matrix and pose recovery (`slam/epipolar.py`), and cv2's gates:
a proper rotation and a cheirality fraction of at least 70%. The calibration
file writer appends the estimated stereo extrinsics as comments.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from sfa3d_tpu_torch.device import Device, resolve_device

# the matcher reduces the (query, train) distances a block of query rows at
# a time; one block's distances (int32, and the float32 product beneath
# them) hold at most this many bytes
MATCH_BLOCK_BYTES = 64 << 20


@dataclass
class StereoCalibResult:
    success: bool
    R: Optional[np.ndarray]
    t: Optional[np.ndarray]
    n_matches: int
    n_inliers: int
    cheirality_fraction: float
    reason: str = ""


def _bits(des: torch.Tensor) -> torch.Tensor:
    """(K, 32) uint8 descriptors -> (K, 256) float32 0/1 bits."""
    shifts = torch.arange(8, device=des.device, dtype=torch.uint8)
    return ((des[:, :, None] >> shifts) & 1).reshape(des.shape[0], -1).to(torch.float32)


def _distances(qb: torch.Tensor, qn: torch.Tensor, tb: torch.Tensor, tn: torch.Tensor) -> torch.Tensor:
    """(Q, T) int32 distances of bit vectors (Q, 256) and (T, 256) whose
    popcounts are qn and tn: |a xor b| = |a| + |b| - 2 |a and b|, the last
    term one float32 matrix product of the 0/1 bits (every partial sum is
    an integer below 2**24, so the product is exact on any device, TF32
    included)."""
    return (qn[:, None] + tn[None, :] - 2.0 * (qb @ tb.T)).to(torch.int32)


def hamming_distances(query: torch.Tensor, train: torch.Tensor) -> torch.Tensor:
    """(Q, T) int32 Hamming distances of (Q, 32) and (T, 32) uint8
    descriptors."""
    qb, tb = _bits(query), _bits(train)
    return _distances(qb, qb.sum(1), tb, tb.sum(1))


def match_descriptors(des1: torch.Tensor, des2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """cv2.BFMatcher(NORM_HAMMING, crossCheck=True).match(des1, des2), sorted
    by distance as Python's stable sort does: (query indices, train indices,
    distances), each (M,) on the descriptors' device. A pair matches when
    each is the other's nearest, the first index on equal distances. The
    distances are reduced a block of query rows at a time (each block
    within MATCH_BLOCK_BYTES): a row argmin per block and a running column
    minimum, which keeps the earlier block on equal distances."""
    qb, tb = _bits(des1), _bits(des2)
    qn, tn = qb.sum(1), tb.sum(1)
    n_query, n_train = qb.shape[0], tb.shape[0]
    dev = qb.device
    best_train = torch.empty(n_query, dtype=torch.int64, device=dev)
    best_dist = torch.empty(n_query, dtype=torch.int32, device=dev)
    col_dist = torch.full((n_train,), torch.iinfo(torch.int32).max, dtype=torch.int32, device=dev)
    best_query = torch.zeros(n_train, dtype=torch.int64, device=dev)
    rows = max(1, MATCH_BLOCK_BYTES // max(1, 4 * n_train))
    for start in range(0, n_query, rows):
        d = _distances(qb[start:start + rows], qn[start:start + rows], tb, tn)
        bt = torch.argmin(d, dim=1)  # the first of equal distances
        best_train[start:start + rows] = bt
        best_dist[start:start + rows] = d.gather(1, bt[:, None])[:, 0]
        bq = torch.argmin(d, dim=0)
        dq = d.gather(0, bq[None, :])[0]
        closer = dq < col_dist  # strict: an earlier block wins a tie
        col_dist = torch.where(closer, dq, col_dist)
        best_query = torch.where(closer, bq + start, best_query)
    q = torch.arange(n_query, device=dev)
    mutual = best_query[best_train] == q
    qi, ti, dist = q[mutual], best_train[mutual], best_dist[mutual]
    order = torch.sort(dist, stable=True).indices
    return qi[order], ti[order], dist[order]


def match_orb_features(img_left: np.ndarray, img_right: np.ndarray, n_features: int = 5000,
                       device: Device = None, timings: Dict[str, float] = None
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """ORB(n_features) on both grey images and cross-checked Hamming
    matching on the device (cuda unless "cpu"). Returns the matched (N, 2)
    float32 pixel arrays, left and right, sorted by match distance. With
    `timings` (a dict), the host milliseconds of each ORB level
    (`orb_left_level{i}`, ...), the descriptors and the match land there."""
    from sfa3d_tpu_torch.slam.orb import detect_and_compute

    dev = resolve_device(device)
    sides = {}
    for name, img in (("left", img_left), ("right", img_right)):
        stage = {} if timings is not None else None
        sides[name] = detect_and_compute(img, n_features, device=dev, timings=stage)
        if timings is not None:
            timings.update({f"orb_{name}_{k}": v for k, v in stage.items()})
    (kp1, des1), (kp2, des2) = sides["left"], sides["right"]
    if len(kp1["pt"]) < 8 or len(kp2["pt"]) < 8:
        return np.zeros((0, 2), np.float32), np.zeros((0, 2), np.float32)
    t0 = time.perf_counter()
    qi, ti, _ = match_descriptors(des1, des2)
    qi, ti = qi.cpu().numpy(), ti.cpu().numpy()
    if timings is not None:
        timings["match"] = (time.perf_counter() - t0) * 1000.0
    return kp1["pt"][qi].astype(np.float32), kp2["pt"][ti].astype(np.float32)


def perform_targetless_stereo_calibration(
    img_left: np.ndarray,
    img_right: np.ndarray,
    K: np.ndarray,
    *,
    min_matches: int = 50,
    min_cheirality: float = 0.7,
    max_pairs: int = 1024,
    seed: int = 0,
    sample_idx=None,
    device: Device = None,
    timings: Dict[str, float] = None,
) -> StereoCalibResult:
    """ORB -> F (RANSAC) -> E -> pose recovery -> a proper rotation and a
    cheirality fraction of at least `min_cheirality`, on the device (cuda
    unless "cpu"). The first `max_pairs` matches, by distance, go into a
    padded RANSAC whose minimal sets are `sample_idx` or drawn from `seed`.
    With `timings` (a dict), the host milliseconds of each stage land there
    (`match_orb_features`'s, then `f_ransac` and `recover_pose`)."""
    from sfa3d_tpu_torch.slam.epipolar import (
        essential_from_fundamental,
        estimate_fundamental_ransac,
        recover_pose,
    )

    dev = resolve_device(device)
    p1, p2 = match_orb_features(img_left, img_right, device=dev, timings=timings)
    n_matches = len(p1)
    if n_matches < min_matches:
        return StereoCalibResult(False, None, None, n_matches, 0, 0.0,
                                 f"too few matches ({n_matches} < {min_matches})")

    a = np.zeros((max_pairs, 2), np.float32)
    b = np.zeros((max_pairs, 2), np.float32)
    valid = np.zeros((max_pairs,), bool)
    m = min(n_matches, max_pairs)
    a[:m], b[:m], valid[:m] = p1[:m], p2[:m], True

    t0 = time.perf_counter()
    F, inliers = estimate_fundamental_ransac(a, b, valid, seed=seed, sample_idx=sample_idx,
                                             threshold=3.0, device=dev)
    n_inliers = int(inliers.sum())
    if timings is not None:
        timings["f_ransac"] = (time.perf_counter() - t0) * 1000.0
    if n_inliers < 8:
        return StereoCalibResult(False, None, None, n_matches, n_inliers, 0.0,
                                 "fundamental estimation failed")

    t0 = time.perf_counter()
    K = np.asarray(K, np.float32)
    E = essential_from_fundamental(F, K, K)
    R, t, frac = recover_pose(E, a, b, K, inliers)
    R, t, frac = R.cpu().numpy().astype(np.float64), t.cpu().numpy().astype(np.float64), float(frac)
    if timings is not None:
        timings["recover_pose"] = (time.perf_counter() - t0) * 1000.0

    # rotation validity: orthonormal with det +1
    ortho_err = np.abs(R @ R.T - np.eye(3)).max()
    if ortho_err > 1e-3 or abs(np.linalg.det(R) - 1.0) > 1e-3:
        return StereoCalibResult(False, None, None, n_matches, n_inliers, frac,
                                 "estimated rotation not a valid SO(3) matrix")
    if frac < min_cheirality:
        return StereoCalibResult(False, None, None, n_matches, n_inliers, frac,
                                 f"cheirality {frac:.2f} < {min_cheirality}")
    return StereoCalibResult(True, R, t, n_matches, n_inliers, frac)


def save_estimated_calibration(filepath: str, base_calib: Dict[str, np.ndarray], result: StereoCalibResult):
    """The KITTI calibration file with the estimated R_stereo / t_stereo
    appended as comments when the calibration succeeded."""
    from sfa3d_tpu_torch.geometry.calibration import save_calibration_kitti_format

    extra = {}
    if result.success:
        extra["R_stereo_estimated"] = result.R
        extra["t_stereo_estimated"] = result.t
    save_calibration_kitti_format(filepath, base_calib, extra)
