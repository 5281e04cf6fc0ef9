"""Epipolar geometry in PyTorch, the port of `sfa3d_tpu/slam/epipolar.py`:
fundamental-matrix RANSAC, the essential matrix, triangulation and pose
recovery.

Every RANSAC hypothesis is a weighted, Hartley-normalized 8-point solve,
all of them in one batched `torch.linalg.eigh` / `svd` stack; inliers are
scored by the Sampson distance; E = K2^T F K1 is projected onto the
(1, 1, 0) singular values; `recover_pose` picks among E's four (R, t)
decompositions by the cheirality count of a batched DLT triangulation.
The minimal sets are an argument or come from `pnp.draw_samples` (a CPU
generator), as in `slam/pnp.py`. Ties keep the first index, as jnp.argmax
does. As in `slam/pnp.py`, the estimators solve in float64 and return the
inputs' floating type: in float32 the batched SVDs of E and of the 3 x 3
rank projection stray by up to 1e-3 from the float64 solution, by another
amount on each device.
"""

from __future__ import annotations

from typing import Tuple

import torch

from sfa3d_tpu_torch.device import Device, resolve_device
from sfa3d_tpu_torch.slam.pnp import as_float, as_tensor, draw_samples, sample_weights


def _normalize_points(pts: torch.Tensor, weights: torch.Tensor):
    """Hartley normalization of (N, 2) points under weights (..., N): zero
    mean, mean distance sqrt(2). Returns ((..., N, 2) points, (..., 3, 3) T)."""
    wsum = torch.clamp_min(weights.sum(-1), 1.0)
    mean = (pts * weights[..., None]).sum(-2) / wsum[..., None]
    diff = pts - mean[..., None, :]
    d = torch.sqrt((diff * diff).sum(-1))
    sqrt2 = torch.sqrt(torch.tensor(2.0, dtype=pts.dtype, device=pts.device))
    scale = sqrt2 / torch.clamp_min((d * weights).sum(-1) / wsum, 1e-9)
    zero, one = torch.zeros_like(scale), torch.ones_like(scale)
    T = torch.stack([
        torch.stack([scale, zero, -scale * mean[..., 0]], -1),
        torch.stack([zero, scale, -scale * mean[..., 1]], -1),
        torch.stack([zero, zero, one], -1),
    ], -2)
    return diff * scale[..., None, None], T


def _eight_point(p1: torch.Tensor, p2: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Weighted normalized 8-point fundamental matrix: (N, 2) + (N, 2) under
    weights (..., N) -> (..., 3, 3), scaled so F[2, 2] = 1."""
    n1, T1 = _normalize_points(p1, weights)
    n2, T2 = _normalize_points(p2, weights)
    x1, y1 = n1[..., 0], n1[..., 1]
    x2, y2 = n2[..., 0], n2[..., 1]
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, torch.ones_like(x1)], dim=-1)
    A = A * weights[..., None]
    _, eigvecs = torch.linalg.eigh(A.mT @ A)
    F = eigvecs[..., :, 0].reshape(weights.shape[:-1] + (3, 3))
    # rank-2 enforcement
    U, S, Vt = torch.linalg.svd(F)
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], dim=-1)
    F = (U * S[..., None, :]) @ Vt
    F = T2.mT @ F @ T1
    f22 = F[..., 2, 2]
    return F / torch.where(torch.abs(f22) > 1e-12, f22, torch.ones_like(f22))[..., None, None]


def sampson_distance(F: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """First-order epipolar error per correspondence: F (..., 3, 3) ->
    (..., N)."""
    ones = torch.ones((p1.shape[0], 1), dtype=p1.dtype, device=p1.device)
    x1 = torch.cat([p1, ones], dim=1)
    x2 = torch.cat([p2, ones], dim=1)
    Fx1 = x1 @ F.mT
    Ftx2 = x2 @ F
    num = (x2 * Fx1).sum(-1) ** 2
    den = Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2
    return num / torch.clamp_min(den, 1e-12)


def estimate_fundamental_ransac(
    p1,
    p2,
    valid,
    *,
    seed: int = 0,
    sample_idx=None,
    threshold: float = 3.0,
    iterations: int = 256,
    sample_size: int = 8,
    device: Device = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, 2) x (N, 2) padded matches -> (F (3, 3), inlier mask (N,)): the
    cv2.findFundamentalMat(FM_RANSAC) analogue with a fixed iteration count.
    The minimal sets are `sample_idx` ((iterations, sample_size) slots) or
    drawn by `pnp.draw_samples` from `seed`. Runs on cuda unless
    device="cpu"."""
    dev = resolve_device(device)
    p1 = as_float(p1, dev)
    dtype = p1.dtype  # the result's; the solve is float64
    p1 = p1.double()
    p2 = as_float(p2, dev, dtype).double()
    valid = as_tensor(valid).to(dev, torch.bool)
    if sample_idx is None:
        sample_idx = draw_samples(valid, iterations, sample_size, seed)
    sample_idx = as_tensor(sample_idx).to(dev, torch.int64)

    Fs = _eight_point(p1, p2, sample_weights(sample_idx, valid, torch.float64))
    masks = (sampson_distance(Fs, p1, p2) < threshold ** 2) & valid
    counts = masks.sum(dim=1)
    best = torch.argmax(counts)  # the first of equal counts, as jnp.argmax
    # the final solve on the winning inliers, kept unless it loses inliers
    F = _eight_point(p1, p2, masks[best].double())
    mask = (sampson_distance(F, p1, p2) < threshold ** 2) & valid
    keep = mask.sum() >= counts[best]
    return torch.where(keep, F, Fs[best]).to(dtype), torch.where(keep, mask, masks[best])


def essential_from_fundamental(F, K1, K2) -> torch.Tensor:
    """E = K2^T F K1 projected onto the singular values (1, 1, 0), solved in
    float64 and returned in F's type. Runs on F's device."""
    F = as_tensor(F)
    dtype = F.dtype
    F = F.double()
    K1 = as_float(K1, F.device, dtype).double()
    K2 = as_float(K2, F.device, dtype).double()
    E = K2.T @ F @ K1
    U, _, Vt = torch.linalg.svd(E)
    d = torch.tensor([1.0, 1.0, 0.0], dtype=torch.float64, device=F.device)
    return ((U * d) @ Vt).to(dtype)


def triangulate_points(P1: torch.Tensor, P2: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Batched DLT triangulation: projections (..., 3, 4) x 2 and (N, 2)
    normalized points x 2 -> (..., N, 3) points."""
    a, b = p1[..., :, :, None], p2[..., :, :, None]  # (N, 2, 1)
    P1, P2 = P1[..., None, :, :], P2[..., None, :, :]
    A = torch.stack([
        a[..., 0, :] * P1[..., 2, :] - P1[..., 0, :],
        a[..., 1, :] * P1[..., 2, :] - P1[..., 1, :],
        b[..., 0, :] * P2[..., 2, :] - P2[..., 0, :],
        b[..., 1, :] * P2[..., 2, :] - P2[..., 1, :],
    ], dim=-2)  # (..., N, 4, 4)
    _, eigvecs = torch.linalg.eigh(A.mT @ A)
    X = eigvecs[..., :, 0]
    w = X[..., 3]
    # the clamp keeps the sign: a tiny negative w made +eps would flip the
    # point across both cameras and corrupt the cheirality vote
    eps = torch.where(w < 0, -1e-12, 1e-12).to(w.dtype)
    return X[..., :3] / torch.where(torch.abs(w) > 1e-12, w, eps)[..., None]


def recover_pose(E, p1, p2, K, valid) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """cv2.recoverPose analogue: of the four (R, t) decompositions of E (in
    the order (R1, t), (R1, -t), (R2, t), (R2, -t)) the one with the most
    points in front of both cameras. Returns (R (3, 3), unit t (3,),
    cheirality fraction in [0, 1]) on E's device, R and t in E's type
    (solved in float64)."""
    E = as_tensor(E)
    dev, out_dtype, dtype = E.device, E.dtype, torch.float64
    E = E.double()
    p1, p2, K = (as_float(a, dev, out_dtype).double() for a in (p1, p2, K))
    valid = as_tensor(valid).to(dev, torch.bool)
    U, _, Vt = torch.linalg.svd(E)
    # proper rotations
    U = U * torch.sign(torch.linalg.det(U))
    Vt = Vt * torch.sign(torch.linalg.det(Vt))
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dtype=dtype, device=dev)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[:, 2]

    Kinv = torch.linalg.inv(K)
    ones = torch.ones((p1.shape[0], 1), dtype=dtype, device=dev)
    n1 = (torch.cat([p1, ones], 1) @ Kinv.T)[:, :2]
    n2 = (torch.cat([p2, ones], 1) @ Kinv.T)[:, :2]

    cands_R = torch.stack([R1, R1, R2, R2])
    cands_t = torch.stack([t, -t, t, -t])
    P1 = torch.cat([torch.eye(3, dtype=dtype, device=dev), torch.zeros((3, 1), dtype=dtype, device=dev)], 1)
    P2 = torch.cat([cands_R, cands_t[:, :, None]], dim=2)
    X = triangulate_points(P1.expand(4, 3, 4), P2, n1, n2)  # (4, N, 3)
    z1 = X[..., 2]
    z2 = (X @ cands_R[:, 2, :, None])[..., 0] + cands_t[:, 2:3]
    scores = ((z1 > 0) & (z2 > 0) & valid).sum(dim=1)
    best = torch.argmax(scores)  # the first of equal counts, as jnp.argmax
    frac = scores[best].to(torch.float32) / torch.clamp_min(valid.sum(), 1).to(torch.float32)
    return cands_R[best].to(out_dtype), cands_t[best].to(out_dtype), frac
