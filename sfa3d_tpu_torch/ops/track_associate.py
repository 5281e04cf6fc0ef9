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
them when that IoU is >= iou_min. CUDA tensors launch one of two designs of
the kernel, chosen by shape against the card's shared memory
(`track_associate_design`), or raise; CPU tensors take
`track_associate_plain`. The matrix design (T <= 256) keys the frame's IoU
matrix into shared memory and walks only the candidate rows
(`track_associate_candidate_rows`); the row design, for larger shapes, reads
a row from global memory each step. The wrapper keeps a `launches` counter
(both designs count under it).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from sfa3d_tpu_torch._build import finish_launch, load_library

MATRIX_SLOTS_PER_LANE = 8  # the matrix design's columns a lane holds in registers: T <= 256

_c_ptr, _c_i32, _c_i64, _c_f32 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64, ctypes.c_float
_ARGS = (_c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_i64, _c_i32, _c_i32, _c_f32, _c_i32, _c_ptr)
_SIGNATURES = {
    "track_associate_smem_limit": (ctypes.c_int, (_c_i32, ctypes.POINTER(_c_i32))),
    "track_associate_cuda": (ctypes.c_int, _ARGS),  # the matrix design
    "track_associate_row_cuda": (ctypes.c_int, _ARGS),
}
_smem_limits = {}  # device index -> the dynamic shared memory a block may opt in to


def track_associate_matrix_smem(k: int, t: int) -> int:
    """Bytes of shared memory the matrix design takes for one frame: per
    detection row 32 * ceil(T / 32) keys, its place in the order, its
    result and its candidate flag."""
    return k * (128 * -(-t // 32) + 9)


def track_associate_row_smem(k: int, t: int) -> int:
    """Bytes of shared memory the row design takes for one frame: the
    K-entry order and T used flags."""
    return 4 * k + t


def track_associate_design(k: int, t: int, smem_limit: int) -> str:
    """The design a CUDA launch takes at K detections and T track slots on a
    card whose blocks may use `smem_limit` bytes of shared memory: "matrix"
    while T <= 32 * MATRIX_SLOTS_PER_LANE and its keys fit (at an H100's
    232,448: K <= 877 at T = 64, K <= 225 at T = 256), else "row". Raises
    ValueError when neither fits."""
    if t <= 32 * MATRIX_SLOTS_PER_LANE and track_associate_matrix_smem(k, t) <= smem_limit:
        return "matrix"
    if track_associate_row_smem(k, t) <= smem_limit:
        return "row"
    raise ValueError(
        f"track_associate: K = {k}, T = {t} take more than the {smem_limit} bytes of shared memory a block may use"
    )


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


def track_associate_candidate_rows(iou: torch.Tensor, iou_min: float) -> torch.Tensor:
    """(B, K) bool: the detection rows that can match, those with an entry
    >= iou_min (a NaN never is), or every row when -1 >= iou_min (a used
    track's -1 then matches). The matrix design's chain walks only these
    rows; every other row's step matches nothing and marks nothing."""
    cand = (iou >= iou_min).any(2)
    return cand | (-1.0 >= iou_min)


def _device_smem_limit(lib: ctypes.CDLL, dev: torch.device) -> int:
    """The dynamic shared memory a block may opt in to on `dev`, asked of
    the library once per device."""
    limit = _smem_limits.get(dev.index)
    if limit is None:
        v = _c_i32(0)
        err = lib.track_associate_smem_limit(dev.index, ctypes.byref(v))
        if err != 0:
            raise RuntimeError(f"cudaDeviceGetAttribute failed on {dev}: cudaError {err}")
        limit = _smem_limits[dev.index] = v.value
    return limit


def _cuda_setup(iou: torch.Tensor, order: torch.Tensor) -> Tuple[ctypes.CDLL, torch.device]:
    """The library and device of a launch; raises for a device that is not
    CUDA (the CPU never gets here) or an input that is not contiguous."""
    dev = iou.device
    if dev.type != "cuda":
        raise ValueError(f"track_associate runs on cuda or cpu, not {dev}")
    if not (iou.is_contiguous() and order.is_contiguous()):
        raise ValueError("track_associate needs contiguous inputs")
    return load_library("track_associate", _SIGNATURES), dev


def _launch(lib: ctypes.CDLL, dev: torch.device, design: str, iou: torch.Tensor, order: torch.Tensor,
            iou_min: float) -> Tuple[int, torch.Tensor, torch.Tensor]:
    """One launch of `design` ("matrix" or "row"): (CUDA error, det_match,
    trk_used). The caller has checked the inputs and the design's fit;
    B >= 1."""
    b, k, t = iou.shape
    det_match = order.new_empty((b, k))
    trk_used = iou.new_empty((b, t), dtype=torch.bool)
    fn = lib.track_associate_cuda if design == "matrix" else lib.track_associate_row_cuda
    err = fn(iou.data_ptr(), order.data_ptr(), det_match.data_ptr(), trk_used.data_ptr(), b, k, t,
             float(iou_min), dev.index, torch.cuda.current_stream(dev).cuda_stream)
    return err, det_match, trk_used


def track_associate(iou: torch.Tensor, order: torch.Tensor, iou_min: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, K, T) float32 gated IoU + (B, K) int32 order -> (det_match (B, K)
    int32, trk_used (B, T) bool). CUDA tensors launch one kernel:
    `track_associate_matrix_kernel` or `track_associate_row_kernel`, as
    `track_associate_design` picks by (K, T) from the card's shared memory;
    CPU tensors take `track_associate_plain`."""
    _check(iou, order)
    if iou.device.type == "cpu":
        return track_associate_plain(iou, order, iou_min)
    lib, dev = _cuda_setup(iou, order)
    b, k, t = iou.shape
    design = track_associate_design(k, t, _device_smem_limit(lib, dev))
    if b == 0:
        return order.new_empty((0, k)), iou.new_empty((0, t), dtype=torch.bool)
    err, det_match, trk_used = _launch(lib, dev, design, iou, order, iou_min)
    finish_launch(track_associate, "track_associate", err)
    return det_match, trk_used


track_associate.launches = 0
