"""The 3D tracker's greedy association loop as a hand-written CUDA kernel
(`csrc/track_associate.cu`) with a plain PyTorch twin.

The JAX tracker runs it as a `lax.fori_loop` over the frame's K detections
(`sfa3d_tpu/tracking/tracker.py:131-142`). Written as an eager PyTorch loop,
each of the K dependent steps would be several small launches for every
stream and frame, so the entry here is one launch per tracker step.

  track_associate  (B, K, T) float32 gated IoU (-1 where a detection may
                   not take a track) + (B, K) int32 score order + iou_min
                   -> det_match (B, K) int32 (track slot or -1),
                      trk_used (B, T) bool

Step i takes detection d = order[i], the unused track of largest IoU (the
lowest index on ties, NaN above every number: `jnp.argmax`), and matches
them when that IoU is >= iou_min. CUDA tensors launch the kernel (one warp
per frame) or raise; CPU tensors take `track_associate_plain`. The wrapper
keeps a `launches` counter.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from sfa3d_tpu_torch._build import finish_launch, load_library

SMEM_LIMIT = 48 * 1024  # the default dynamic shared memory of a block

_c_ptr, _c_i32, _c_i64, _c_f32 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64, ctypes.c_float
_SIGNATURES = {
    "track_associate_cuda": (
        ctypes.c_int, (_c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_i64, _c_i32, _c_i32, _c_f32, _c_i32, _c_ptr),
    ),
}


def track_associate_smem(k: int, t: int) -> int:
    """Bytes of shared memory the kernel takes for one frame: the K-entry
    order and T used flags."""
    return 4 * k + t


def _check(iou: torch.Tensor, order: torch.Tensor) -> None:
    if iou.dim() != 3 or order.shape != iou.shape[:2]:
        raise ValueError(
            f"track_associate: expected iou (B, K, T) and order (B, K); got {tuple(iou.shape)} and {tuple(order.shape)}"
        )
    if iou.dtype != torch.float32 or order.dtype != torch.int32:
        raise TypeError(f"track_associate: iou must be float32 and order int32; got {iou.dtype}, {order.dtype}")
    if order.device != iou.device:
        raise ValueError(f"track_associate: iou lies on {iou.device}, order on {order.device}")
    if iou.shape[2] == 0:
        raise ValueError("track_associate needs at least one track slot")


def track_associate_plain(iou: torch.Tensor, order: torch.Tensor, iou_min: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the K steps as a Python loop, vectorised over
    frames. Returns (det_match int32, trk_used bool)."""
    _check(iou, order)
    b, k, t = iou.shape
    rows = torch.arange(b, device=iou.device)
    det_match = torch.full((b, k), -1, dtype=torch.int32, device=iou.device)
    trk_used = torch.zeros((b, t), dtype=torch.bool, device=iou.device)
    order = order.long()
    for i in range(k):
        d = order[:, i]
        row = torch.where(trk_used, -1.0, iou[rows, d])
        j = torch.argmax(row, dim=1)
        hit = row[rows, j] >= iou_min
        det_match[rows, d] = torch.where(hit, j, -1).to(torch.int32)
        trk_used[rows, j] |= hit
    return det_match, trk_used


def track_associate(iou: torch.Tensor, order: torch.Tensor, iou_min: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, K, T) float32 gated IoU + (B, K) int32 order -> (det_match (B, K)
    int32, trk_used (B, T) bool). CUDA tensors launch
    `track_associate_kernel` (one launch); CPU tensors take
    `track_associate_plain`."""
    _check(iou, order)
    if iou.device.type == "cpu":
        return track_associate_plain(iou, order, iou_min)
    dev = iou.device
    if dev.type != "cuda":
        raise ValueError(f"track_associate runs on cuda or cpu, not {dev}")
    if not (iou.is_contiguous() and order.is_contiguous()):
        raise ValueError("track_associate needs contiguous inputs")
    b, k, t = iou.shape
    if track_associate_smem(k, t) > SMEM_LIMIT:
        raise ValueError(f"track_associate: K = {k}, T = {t} take more than {SMEM_LIMIT} bytes of shared memory")
    det_match = order.new_empty((b, k))
    trk_used = iou.new_empty((b, t), dtype=torch.bool)
    if b == 0:
        return det_match, trk_used
    lib = load_library("track_associate", _SIGNATURES)
    err = lib.track_associate_cuda(
        iou.data_ptr(), order.data_ptr(), det_match.data_ptr(), trk_used.data_ptr(), b, k, t,
        float(iou_min), dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    finish_launch(track_associate, "track_associate", err)
    return det_match, trk_used


track_associate.launches = 0
