"""RANSAC PnP camera-pose estimation in PyTorch, the port of
`sfa3d_tpu/slam/pnp.py`.

A fixed-iteration RANSAC where every hypothesis is solved at once: one
batched 6-point DLT (`torch.linalg.eigh` of an (iterations, 12, 12)
normal-matrix stack, then an SVD projection onto SO(3)), one batched
reprojection pass to count inliers, and a final DLT over the winner's
inliers, kept only if it loses none. Nothing reads a device value back
until the caller does.

The estimator solves in float64 whatever the inputs' type and returns the
inputs' type: the 12 x 12 normal matrix of the unnormalized DLT is so
ill-conditioned (landmarks tens of metres deep) that float32 moves the
pose by centimetres to metres, and by another amount on every device.

The minimal sets are an argument (`sample_idx`, iterations x sample_size
slot indices). Without it, `draw_samples` draws each set without
replacement over the valid slots from a CPU `torch.Generator` seeded with
`seed`, so the card and the CPU test the same hypotheses.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from sfa3d_tpu_torch.device import Device, resolve_device


def as_tensor(x) -> torch.Tensor:
    """A tensor of x (a tensor as it is; anything else copied from numpy)."""
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))


def as_float(x, device: torch.device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A tensor on `device`, floating (float32 unless the input is float64
    or `dtype` says otherwise)."""
    t = as_tensor(x)
    if dtype is None:
        dtype = torch.float64 if t.dtype == torch.float64 else torch.float32
    return t.to(device=device, dtype=dtype)


def draw_samples(valid, iterations: int, sample_size: int, seed: int) -> torch.Tensor:
    """(iterations, sample_size) int64 slot indices, each row drawn without
    replacement from the valid slots, from a CPU generator seeded with
    `seed` (the same sets on every device)."""
    slots = torch.from_numpy(np.flatnonzero(as_tensor(valid).cpu().numpy().astype(bool)))
    if slots.numel() < sample_size:
        raise ValueError(f"{slots.numel()} valid slots; a minimal set needs {sample_size}")
    gen = torch.Generator().manual_seed(int(seed))
    order = torch.rand((iterations, slots.numel()), generator=gen).argsort(dim=1)[:, :sample_size]
    return slots[order]


def sample_weights(sample_idx: torch.Tensor, valid: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(iterations, N) 0/1 weights: 1 at each hypothesis' sampled valid slots."""
    w = torch.zeros((sample_idx.shape[0], valid.shape[0]), dtype=dtype, device=valid.device)
    w.scatter_(1, sample_idx, 1.0)
    return w * valid.to(dtype)


def _dlt_pose(pts3d: torch.Tensor, pts2d_norm: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Weighted DLT for the 3x4 pose [R|t] from normalized image points.

    pts3d: (N, 3), pts2d_norm: (N, 2) (K^-1-normalized), weights: (..., N).
    Returns (..., 3, 4) with the rotation block projected onto SO(3) and
    the scale fixed so det(R) = 1."""
    n = pts3d.shape[0]
    X = torch.cat([pts3d, torch.ones((n, 1), dtype=pts3d.dtype, device=pts3d.device)], dim=1)
    u = pts2d_norm[:, 0:1]
    v = pts2d_norm[:, 1:2]
    zeros = torch.zeros((n, 4), dtype=pts3d.dtype, device=pts3d.device)
    r1 = torch.cat([X, zeros, -u * X], dim=1)  # (N, 12): [X 0 -u*X]
    r2 = torch.cat([zeros, X, -v * X], dim=1)  # [0 X -v*X]
    w = weights[..., :, None]
    A = torch.cat([r1 * w, r2 * w], dim=-2)
    # smallest right singular vector of A == eigenvector of A^T A with the
    # smallest eigenvalue
    _, eigvecs = torch.linalg.eigh(A.mT @ A)
    p = eigvecs[..., :, 0].reshape(weights.shape[:-1] + (3, 4))
    # scale and sign: ||r3|| = 1, the points in front of the camera by a
    # weighted vote (so LAPACK's eigenvector sign does not matter)
    r3 = p[..., 2, :3]
    scale = torch.sqrt((r3 * r3).sum(-1))
    p = p / torch.clamp_min(scale, 1e-12)[..., None, None]
    depth = (p[..., 2:3, :3] @ pts3d.T)[..., 0, :] + p[..., 2, 3:4]
    vote = (torch.sign(depth) * weights).sum(-1)
    p = p * torch.where(vote >= 0, 1.0, -1.0).to(p.dtype)[..., None, None]
    # project the rotation block onto SO(3)
    U, _, Vt = torch.linalg.svd(p[..., :3])
    det = torch.linalg.det(U @ Vt)
    d = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    R = (U * d[..., None, :]) @ Vt
    # rescale the translation consistently with the orthonormalized R
    s = (p[..., :3] * R).sum((-2, -1)) / 3.0
    t = p[..., 3] / torch.clamp_min(s, 1e-12)[..., None]
    return torch.cat([R, t[..., None]], dim=-1)


def _reproject_error(pose: torch.Tensor, pts3d: torch.Tensor, pts2d: torch.Tensor,
                     K: torch.Tensor) -> torch.Tensor:
    """Pixel reprojection error per point for poses (..., 3, 4) -> (..., N);
    points behind the camera get 1e9."""
    cam = pts3d @ pose[..., :3].mT + pose[..., None, :, 3]
    uvw = cam @ K.T
    uv = uvw[..., :2] / torch.clamp_min(uvw[..., 2:3], 1e-9)
    diff = uv - pts2d
    err = torch.sqrt((diff * diff).sum(-1))
    return torch.where(cam[..., 2] <= 0, torch.full_like(err, 1e9), err)


def ransac_pnp(
    pts3d,
    pts2d,
    K,
    valid,
    *,
    seed: int = 0,
    sample_idx=None,
    reprojection_error: float = 8.0,
    iterations: int = 128,
    sample_size: int = 6,
    device: Device = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Estimate the camera pose from padded 3D<->2D correspondences.

    Args:
      pts3d: (N, 3) world points; pts2d: (N, 2) pixels; K: (3, 3)
      intrinsics; valid: (N,) padding mask. The pose is returned in the
      inputs' floating type (float64 stays float64, anything else becomes
      float32); the solve runs in float64 either way.
      seed: the generator seed of `draw_samples` when `sample_idx` (an
      (iterations, sample_size) index array) is not given.
      device: cuda unless "cpu" is asked for.

    Returns (pose (3, 4) [R|t], inlier mask (N,), n_inliers scalar), on the
    device.
    """
    dev = resolve_device(device)
    pts3d = as_float(pts3d, dev)
    dtype = pts3d.dtype  # the result's; the solve is float64
    pts3d = pts3d.double()
    pts2d = as_float(pts2d, dev, dtype).double()
    K = as_float(K, dev, dtype).double()
    valid = as_tensor(valid).to(dev, torch.bool)
    n = pts3d.shape[0]
    if sample_idx is None:
        sample_idx = draw_samples(valid, iterations, sample_size, seed)
    sample_idx = as_tensor(sample_idx).to(dev, torch.int64)

    Kinv = torch.linalg.inv(K)
    ones = torch.ones((n, 1), dtype=torch.float64, device=dev)
    norm = (torch.cat([pts2d, ones], dim=1) @ Kinv.T)[:, :2]

    poses = _dlt_pose(pts3d, norm, sample_weights(sample_idx, valid, torch.float64))  # (iters, 3, 4)
    errs = _reproject_error(poses, pts3d, pts2d, K)
    inlier_masks = (errs < reprojection_error) & valid
    counts = inlier_masks.sum(dim=1)
    best = torch.argmax(counts)  # the first of equal counts, as jnp.argmax

    # refine on the winning inlier set; keep it only if it loses no inliers
    best_mask = inlier_masks[best]
    refined = _dlt_pose(pts3d, norm, best_mask.double())
    ref_mask = (_reproject_error(refined, pts3d, pts2d, K) < reprojection_error) & valid
    use_refined = ref_mask.sum() >= counts[best]
    pose = torch.where(use_refined, refined, poses[best])
    mask = torch.where(use_refined, ref_mask, best_mask)
    return pose.to(dtype), mask, mask.sum()


def rodrigues(rvec, device: Device = None) -> torch.Tensor:
    """Axis-angle -> rotation matrix in float32 (cv2.Rodrigues)."""
    rvec = torch.as_tensor(np.asarray(rvec, np.float32).reshape(3), device=resolve_device(device))
    theta = torch.sqrt((rvec * rvec).sum())
    k = rvec / torch.clamp_min(theta, 1e-12)
    z = torch.zeros((), dtype=torch.float32, device=rvec.device)
    Kx = torch.stack([torch.stack([z, -k[2], k[1]]), torch.stack([k[2], z, -k[0]]),
                      torch.stack([-k[1], k[0], z])])
    eye = torch.eye(3, dtype=torch.float32, device=rvec.device)
    R = eye + torch.sin(theta) * Kx + (1 - torch.cos(theta)) * (Kx @ Kx)
    return torch.where(theta < 1e-8, eye, R)
