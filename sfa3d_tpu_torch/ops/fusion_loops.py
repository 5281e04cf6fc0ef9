"""The fusion path's sequential loops: hard NMS, Gaussian soft-NMS and the
greedy best-IoU match, as hand-written CUDA kernels (`csrc/fusion_loops.cu`)
with plain PyTorch twins.

The JAX package runs each as a `lax.fori_loop` over K dependent steps
(`sfa3d_tpu/fusion/nms.py:33, :54`, `sfa3d_tpu/fusion/fuse.py:64`). Written
as an eager PyTorch loop each step would be several small launches, so each
entry here is one launch per batch.

  hard_nms_keep      (B, K, 4) xywh boxes in stable score order + (B, K)
                     valid -> (B, K) keep
  soft_nms_gaussian  (B, K, 4) + (B, K) scores + (B, K) valid -> decayed
                     scores (B, K), surviving mask (B, K)
  greedy_match       (B, Ky, 4) + (B, Ky) valid, (B, Ks, 4) + (B, Ks) valid
                     -> match_idx (B, Ky) int32 (-1: none), sfa_matched (B, Ks)

Each kernel computes what does not depend on an earlier step first, in
parallel, into shared memory (hard NMS: the suppression bitmask; soft-NMS:
the decay of every pair; the match: a key per pair that is 0 unless the
pair can match), then runs the dependent steps in one warp (the match: only
the YOLO rows that have a candidate). Soft-NMS and the match have two
designs each, chosen here by shape against the card's shared memory: up to
`soft_nms_matrix_slots` (239 on an H100) the decay-matrix kernel runs, and
while Ky <= `greedy_match_matrix_rows(Ks)` the key-matrix kernel; above
that, a block kernel with one thread per slot that recomputes a row of IoUs
and takes a block argmax per step.

Each entry is a `torch.library.custom_op` (`sfa3d_torch::<entry>`, with a
shape-only fake implementation), so `torch.export` keeps it one op. It
launches a kernel for CUDA tensors (or raises) and takes its plain version
(`*_plain`: a Python loop over the K steps, vectorised over frames) only
for tensors on the CPU. Each keeps a `launches` counter of real CUDA
launches (both designs of an entry count under its one counter).
`_<entry>_impl` is an op's real implementation, callable past the
dispatcher. A frame holds
at most 1024 slots (the K of hard NMS and soft-NMS, Ky and Ks of the
match); the wrappers raise above that.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from sfa3d_tpu_torch._build import check_op_device, finish_launch, load_library
from sfa3d_tpu_torch.fusion.iou import pairwise_iou_xywh

MAX_SLOTS = 1024  # slots per frame: one per thread of a block, 32 words of 32 bits
MATRIX_SLOTS_PER_LANE = 8  # the matrix kernels' registers: soft-NMS K, match Ks <= 256

_c_ptr, _c_i32, _c_i64, _c_f32 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64, ctypes.c_float
_SOFT_NMS_ARGS = (_c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_i64, _c_i32, _c_f32, _c_f32, _c_i32, _c_ptr)
_MATCH_ARGS = (_c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_i64, _c_i32, _c_i32, _c_f32, _c_i32, _c_ptr)
_SIGNATURES = {
    "fusion_smem_limit": (ctypes.c_int, (_c_i32, ctypes.POINTER(_c_i32))),
    "hard_nms_keep_cuda": (
        ctypes.c_int, (_c_ptr, _c_ptr, _c_ptr, _c_i64, _c_i32, _c_f32, _c_i32, _c_ptr),
    ),
    "soft_nms_gaussian_cuda": (ctypes.c_int, _SOFT_NMS_ARGS),  # the matrix design
    "soft_nms_gaussian_block_cuda": (ctypes.c_int, _SOFT_NMS_ARGS),
    "greedy_match_cuda": (ctypes.c_int, _MATCH_ARGS),  # the matrix design
    "greedy_match_block_cuda": (ctypes.c_int, _MATCH_ARGS),
}
_smem_limits = {}  # device index -> the dynamic shared memory a block may opt in to


def inv_sigma(sigma: float) -> float:
    """float32(1 / sigma): XLA compiles the decay's `/ sigma` by a constant
    sigma as this multiplication, and so do both versions here."""
    return float(np.float32(1.0 / sigma))


def _check_set(boxes: torch.Tensor, valid: torch.Tensor, *, what: str) -> None:
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or valid.shape != boxes.shape[:2]:
        raise ValueError(
            f"{what}: expected boxes (B, K, 4) and valid (B, K); got "
            f"{tuple(boxes.shape)} and {tuple(valid.shape)}"
        )
    if boxes.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(f"{what}: boxes must be float32 and valid bool; got {boxes.dtype}, {valid.dtype}")
    if valid.device != boxes.device:
        raise ValueError(f"{what}: boxes lie on {boxes.device}, valid on {valid.device}")


def _cuda_launch_setup(name: str, slots: int, tensors) -> Tuple[ctypes.CDLL, torch.device]:
    """The library and device for a launch; raises for a device that is not
    CUDA (the CPU never gets here), a tensor that is not contiguous, or more
    than MAX_SLOTS slots."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {dev}")
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: inputs lie on {[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous inputs")
    if slots > MAX_SLOTS:
        raise ValueError(f"{name} takes at most {MAX_SLOTS} slots per frame; got {slots}")
    return load_library("fusion_loops", _SIGNATURES), dev


def _device_smem_limit(lib: ctypes.CDLL, dev: torch.device) -> int:
    """The dynamic shared memory a block may opt in to on `dev`, asked of
    the library once per device."""
    limit = _smem_limits.get(dev.index)
    if limit is None:
        v = _c_i32(0)
        err = lib.fusion_smem_limit(dev.index, ctypes.byref(v))
        if err != 0:
            raise RuntimeError(f"cudaDeviceGetAttribute failed on {dev}: cudaError {err}")
        limit = _smem_limits[dev.index] = v.value
    return limit


def soft_nms_matrix_smem(k: int) -> int:
    """Bytes of shared memory the soft-NMS matrix kernel takes at K slots:
    the K x K decay matrix in whole float4s, 32 valid words, K boxes."""
    return 16 * -(-k * k // 4) + 128 + 16 * k


def soft_nms_matrix_slots(smem_limit: int) -> int:
    """The largest K whose soft-NMS matrix kernel fits `smem_limit` bytes of
    shared memory, and at most 32 * MATRIX_SLOTS_PER_LANE: 239 at an H100's
    232,448."""
    k = MATRIX_SLOTS_PER_LANE * 32
    while k > 0 and soft_nms_matrix_smem(k) > smem_limit:
        k -= 1
    return k


def greedy_match_matrix_smem(ky: int, ks: int) -> int:
    """Bytes of shared memory the match's matrix kernel takes: per YOLO row,
    32 * ceil(Ks / 32) keys, its place in the candidate list and its result
    (int16 each) and its flag."""
    return ky * (128 * -(-ks // 32) + 5)


def greedy_match_matrix_rows(ks: int, smem_limit: int) -> int:
    """The largest Ky (at most MAX_SLOTS) whose match key matrix fits
    `smem_limit` bytes of shared memory at Ks SFA slots; 0 above Ks = 32 *
    MATRIX_SLOTS_PER_LANE. At an H100's 232,448: 890 at Ks = 50, 225 at
    Ks = 256."""
    if ks > 32 * MATRIX_SLOTS_PER_LANE:
        return 0
    return min(MAX_SLOTS, smem_limit // greedy_match_matrix_smem(1, ks))


# ---------------------------------------------------------------------------
# hard NMS
# ---------------------------------------------------------------------------


def hard_nms_keep_plain(boxes: torch.Tensor, valid: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Plain PyTorch version: step i keeps slot i when it is valid and no
    kept slot j < i has iou(i, j) > iou_threshold (strictly)."""
    _check_set(boxes, valid, what="hard_nms_keep")
    iou = pairwise_iou_xywh(boxes, boxes)
    b, k = valid.shape
    keep = torch.zeros((b, k), dtype=torch.bool, device=boxes.device)
    for i in range(k):
        hit = (keep[:, :i] & (iou[:, i, :i] > iou_threshold)).any(dim=1)
        keep[:, i] = valid[:, i] & ~hit
    return keep


def _hard_nms_keep_impl(boxes: torch.Tensor, valid: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    _check_set(boxes, valid, what="hard_nms_keep")
    if boxes.device.type == "cpu":
        return hard_nms_keep_plain(boxes, valid, iou_threshold)
    b, k = valid.shape
    lib, dev = _cuda_launch_setup("hard_nms_keep", k, (boxes, valid))
    keep = valid.new_empty((b, k))
    if b == 0 or k == 0:
        return keep
    err = lib.hard_nms_keep_cuda(
        boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(), b, k, iou_threshold,
        dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    finish_launch(hard_nms_keep, "hard_nms_keep", err)
    return keep


_hard_nms_keep_op = torch.library.custom_op("sfa3d_torch::hard_nms_keep", _hard_nms_keep_impl, mutates_args=())


@_hard_nms_keep_op.register_fake
def _(boxes, valid, iou_threshold):
    _check_set(boxes, valid, what="hard_nms_keep")
    check_op_device("hard_nms_keep", boxes)
    return valid.new_empty(valid.shape)


def hard_nms_keep(boxes: torch.Tensor, valid: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """(B, K, 4) float32 xywh boxes, already in stable descending score
    order, + (B, K) bool valid -> (B, K) bool keep, in the same order,
    through the custom op `sfa3d_torch::hard_nms_keep`. CUDA tensors launch
    `hard_nms_keep_kernel` (one launch, one cluster of blocks per frame: the
    suppression bitmask, then a one-warp scan); CPU tensors take
    `hard_nms_keep_plain`."""
    return _hard_nms_keep_op(boxes, valid, iou_threshold)


# ---------------------------------------------------------------------------
# Gaussian soft-NMS
# ---------------------------------------------------------------------------


def soft_nms_gaussian_plain(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
                            sigma: float = 0.5, score_thresh: float = 0.001):
    """Plain PyTorch version: K steps of select-the-highest-unprocessed
    (first index on ties), freeze it, decay every other unprocessed score by
    exp(-(iou * iou) * float32(1 / sigma)). Returns (scores, surviving)."""
    _check_set(boxes, valid, what="soft_nms_gaussian")
    iou = pairwise_iou_xywh(boxes, boxes)
    b, k = valid.shape
    inv = inv_sigma(sigma)
    rows = torch.arange(b, device=boxes.device)
    slots = torch.arange(k, device=boxes.device)
    s = torch.where(valid, scores, -torch.inf)
    processed = ~valid
    for _ in range(k):
        cand = torch.where(processed, -torch.inf, s)
        m = torch.argmax(cand, dim=1)
        any_left = torch.isfinite(cand[rows, m])
        q = iou[rows, m]
        decay = torch.exp(-(q * q) * inv)
        unprocessed = ~processed & (slots[None, :] != m[:, None])
        s = torch.where(unprocessed & any_left[:, None], s * decay, s)
        processed[rows, m] |= any_left
    out = torch.where(valid, s, 0.0)
    return out, valid & (out > score_thresh)


def _check_soft_nms(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor) -> None:
    _check_set(boxes, valid, what="soft_nms_gaussian")
    if scores.shape != valid.shape or scores.dtype != torch.float32:
        raise ValueError(f"soft_nms_gaussian: scores must be float32 {tuple(valid.shape)}")


def _soft_nms_gaussian_impl(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
                          sigma: float, score_thresh: float) -> Tuple[torch.Tensor, torch.Tensor]:
    _check_soft_nms(boxes, scores, valid)
    if boxes.device.type == "cpu":
        return soft_nms_gaussian_plain(boxes, scores, valid, sigma, score_thresh)
    b, k = valid.shape
    lib, dev = _cuda_launch_setup("soft_nms_gaussian", k, (boxes, scores, valid))
    out = scores.new_empty((b, k))
    surv = valid.new_empty((b, k))
    if b == 0 or k == 0:
        return out, surv
    matrix = k <= soft_nms_matrix_slots(_device_smem_limit(lib, dev))
    launch = lib.soft_nms_gaussian_cuda if matrix else lib.soft_nms_gaussian_block_cuda
    err = launch(
        boxes.data_ptr(), scores.data_ptr(), valid.data_ptr(), out.data_ptr(), surv.data_ptr(),
        b, k, inv_sigma(sigma), score_thresh, dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    finish_launch(soft_nms_gaussian, "soft_nms_gaussian", err)
    return out, surv


_soft_nms_gaussian_op = torch.library.custom_op("sfa3d_torch::soft_nms_gaussian", _soft_nms_gaussian_impl, mutates_args=())


@_soft_nms_gaussian_op.register_fake
def _(boxes, scores, valid, sigma, score_thresh):
    _check_soft_nms(boxes, scores, valid)
    check_op_device("soft_nms_gaussian", boxes)
    return scores.new_empty(scores.shape), valid.new_empty(valid.shape)


def soft_nms_gaussian(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
                      sigma: float = 0.5, score_thresh: float = 0.001):
    """(B, K, 4) float32 xywh boxes + (B, K) float32 scores + (B, K) bool
    valid -> (decayed scores (B, K), surviving mask (B, K)), in slot order,
    through the custom op `sfa3d_torch::soft_nms_gaussian`. CUDA tensors
    launch one kernel: `soft_nms_matrix_kernel` when K <=
    `soft_nms_matrix_slots` of the card's shared memory, else
    `soft_nms_block_kernel`. CPU tensors take `soft_nms_gaussian_plain`."""
    return _soft_nms_gaussian_op(boxes, scores, valid, sigma, score_thresh)


# ---------------------------------------------------------------------------
# greedy best-IoU match
# ---------------------------------------------------------------------------


def greedy_match_plain(yolo_boxes: torch.Tensor, yolo_valid: torch.Tensor,
                       sfa_boxes: torch.Tensor, sfa_valid: torch.Tensor,
                       iou_threshold: float):
    """Plain PyTorch version: YOLO rows in order; row i takes the unmatched
    SFA box of largest IoU (first index on ties) when that IoU is
    >= iou_threshold and > 0. Returns (match_idx int32, sfa_matched)."""
    _check_set(yolo_boxes, yolo_valid, what="greedy_match")
    _check_set(sfa_boxes, sfa_valid, what="greedy_match")
    iou = pairwise_iou_xywh(yolo_boxes, sfa_boxes)
    iou = torch.where(yolo_valid[:, :, None] & sfa_valid[:, None, :], iou, -1.0)
    b, ky = yolo_valid.shape
    rows = torch.arange(b, device=iou.device)
    match_idx = torch.full((b, ky), -1, dtype=torch.int32, device=iou.device)
    sfa_matched = torch.zeros_like(sfa_valid)
    for i in range(ky):
        row = torch.where(sfa_matched, -1.0, iou[:, i])
        j = torch.argmax(row, dim=1)
        best = row[rows, j]
        ok = (best >= iou_threshold) & (best > 0)
        match_idx[:, i] = torch.where(ok, j, -1).to(torch.int32)
        sfa_matched[rows, j] |= ok
    return match_idx, sfa_matched


def greedy_match_candidate_rows(yolo_boxes: torch.Tensor, yolo_valid: torch.Tensor,
                                sfa_boxes: torch.Tensor, sfa_valid: torch.Tensor,
                                iou_threshold: float) -> torch.Tensor:
    """(B,) int64: the YOLO rows of each frame that have a candidate, a valid
    SFA box whose IoU is >= iou_threshold and > 0 (the rows the matrix
    kernel's chain walks; every other row matches nothing)."""
    iou = pairwise_iou_xywh(yolo_boxes, sfa_boxes)
    pair = yolo_valid[:, :, None] & sfa_valid[:, None, :] & (iou >= iou_threshold) & (iou > 0)
    return pair.any(2).sum(1)


def _check_match(yolo_boxes, yolo_valid, sfa_boxes, sfa_valid) -> None:
    _check_set(yolo_boxes, yolo_valid, what="greedy_match")
    _check_set(sfa_boxes, sfa_valid, what="greedy_match")
    if yolo_boxes.shape[0] != sfa_boxes.shape[0]:
        raise ValueError(f"greedy_match: {yolo_boxes.shape[0]} YOLO frames, {sfa_boxes.shape[0]} SFA frames")
    if sfa_boxes.shape[1] == 0:
        raise ValueError("greedy_match needs at least one SFA slot")


def _greedy_match_impl(yolo_boxes: torch.Tensor, yolo_valid: torch.Tensor, sfa_boxes: torch.Tensor,
                     sfa_valid: torch.Tensor, iou_threshold: float) -> Tuple[torch.Tensor, torch.Tensor]:
    _check_match(yolo_boxes, yolo_valid, sfa_boxes, sfa_valid)
    if yolo_boxes.device.type == "cpu":
        return greedy_match_plain(yolo_boxes, yolo_valid, sfa_boxes, sfa_valid, iou_threshold)
    b, ky = yolo_valid.shape
    ks = sfa_valid.shape[1]
    lib, dev = _cuda_launch_setup(
        "greedy_match", max(ky, ks), (yolo_boxes, yolo_valid, sfa_boxes, sfa_valid)
    )
    match_idx = yolo_valid.new_empty((b, ky), dtype=torch.int32)
    sfa_matched = sfa_valid.new_empty((b, ks))
    if b == 0:
        return match_idx, sfa_matched
    matrix = ky <= greedy_match_matrix_rows(ks, _device_smem_limit(lib, dev))
    launch = lib.greedy_match_cuda if matrix else lib.greedy_match_block_cuda
    err = launch(
        yolo_boxes.data_ptr(), yolo_valid.data_ptr(), sfa_boxes.data_ptr(), sfa_valid.data_ptr(),
        match_idx.data_ptr(), sfa_matched.data_ptr(), b, ky, ks, iou_threshold,
        dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    finish_launch(greedy_match, "greedy_match", err)
    return match_idx, sfa_matched


_greedy_match_op = torch.library.custom_op("sfa3d_torch::greedy_match", _greedy_match_impl, mutates_args=())


@_greedy_match_op.register_fake
def _(yolo_boxes, yolo_valid, sfa_boxes, sfa_valid, iou_threshold):
    _check_match(yolo_boxes, yolo_valid, sfa_boxes, sfa_valid)
    check_op_device("greedy_match", yolo_boxes)
    return yolo_valid.new_empty(yolo_valid.shape, dtype=torch.int32), sfa_valid.new_empty(sfa_valid.shape)


def greedy_match(yolo_boxes: torch.Tensor, yolo_valid: torch.Tensor,
                 sfa_boxes: torch.Tensor, sfa_valid: torch.Tensor, iou_threshold: float):
    """(B, Ky, 4) + (B, Ky) YOLO boxes and valid, (B, Ks, 4) + (B, Ks) SFA
    boxes and valid -> (match_idx (B, Ky) int32, index into the SFA boxes or
    -1; sfa_matched (B, Ks) bool), through the custom op
    `sfa3d_torch::greedy_match`. CUDA tensors launch one kernel:
    `greedy_match_kernel` (the key matrix) when Ky <=
    `greedy_match_matrix_rows(Ks)` of the card's shared memory, else
    `greedy_match_block_kernel`. CPU tensors take `greedy_match_plain`."""
    return _greedy_match_op(yolo_boxes, yolo_valid, sfa_boxes, sfa_valid, iou_threshold)


hard_nms_keep.launches = 0
soft_nms_gaussian.launches = 0
greedy_match.launches = 0
