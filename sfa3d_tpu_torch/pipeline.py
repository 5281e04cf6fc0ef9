"""End-to-end frame pipelines in PyTorch, the port of `sfa3d_tpu/pipeline.py`.

raw padded points -> BEV raster (hand-written CUDA tile kernel) -> KFPN ->
clamped sigmoid -> peak decode -> metric 7-DOF boxes, all on one device and
under `torch.inference_mode()`. Public tensors keep the JAX layout (NHWC
raster and heads); the model runs NCHW inside.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from sfa3d_tpu_torch.device import Device, resolve_device
from sfa3d_tpu_torch.models import clamped_sigmoid
from sfa3d_tpu_torch.ops.bev import points_to_bev_nchw
from sfa3d_tpu_torch.ops.decode import decode, detections_to_real, post_processing


def _model_device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _check_model_device(model: torch.nn.Module, device: torch.device) -> None:
    have = _model_device(model)
    if have.type != device.type or (device.index is not None and have != device):
        raise ValueError(f"model lies on {have} but the call asks for {device}")


def _heads_nhwc(model, bev_nchw: torch.Tensor) -> Dict[str, torch.Tensor]:
    return {k: v.permute(0, 2, 3, 1) for k, v in model(bev_nchw).items()}


def forward_heads(model, bev: torch.Tensor) -> Dict[str, torch.Tensor]:
    """(B, H, W, 3) BEV batch -> raw head dict, each (B, H/4, W/4, C), on
    the model's device (the JAX `model.apply(variables, bev)`)."""
    bev = torch.as_tensor(bev, device=_model_device(model))
    with torch.inference_mode():
        return _heads_nhwc(model, bev.permute(0, 3, 1, 2))


def _decode_heads(outputs, K: int, peak_thresh: float):
    dets = decode(
        clamped_sigmoid(outputs["hm_cen"]),
        clamped_sigmoid(outputs["cen_offset"]),
        outputs["direction"].float(),
        outputs["z_coor"].float(),
        outputs["dim"].float(),
        K=K,
    )
    boxes_bev, mask = post_processing(dets, peak_thresh=peak_thresh)
    boxes_real, mask = detections_to_real(boxes_bev, mask)
    return dets, boxes_bev, boxes_real, mask


def detect_frames(
    model,
    points,
    valid,
    *,
    K: int = 50,
    peak_thresh: float = 0.2,
    return_heads: bool = False,
    device: Device = None,
) -> Dict[str, torch.Tensor]:
    """Raw padded scans -> detections, on `device` (default cuda; raises
    without a GPU unless device="cpu"). The model must already lie there.

    Args:
      points: (B, N, 4) float32 velodyne scans (unfiltered, unshifted z),
        numpy or tensor.
      valid:  (B, N) bool padding mask.
      return_heads: also return the raw head dict.

    Returns a dict of tensors on `device`:
      bev:        (B, 608, 608, 3) raster
      detections: (B, K, 10) raw decode rows
      boxes_bev:  (B, K, 9)  [cls, score, x, y, z, h, w, l, yaw] BEV pixels
      boxes_real: (B, K, 8)  [cls, x, y, z, h, w, l, yaw] metric velodyne
      mask:       (B, K) bool validity (score > peak_thresh)
      heads:      raw head dict (only when return_heads)
    """
    dev = resolve_device(device)
    _check_model_device(model, dev)
    with torch.inference_mode():
        points = torch.as_tensor(points).to(dev, non_blocking=True)
        valid = torch.as_tensor(valid).to(dev, non_blocking=True)
        bev = points_to_bev_nchw(points, valid)
        outputs = _heads_nhwc(model, bev)
        dets, boxes_bev, boxes_real, mask = _decode_heads(outputs, K, peak_thresh)
    out = {
        "bev": bev.permute(0, 2, 3, 1),
        "detections": dets,
        "boxes_bev": boxes_bev,
        "boxes_real": boxes_real,
        "mask": mask,
    }
    if return_heads:
        out["heads"] = outputs
    return out


def detect_bev(
    model,
    bev,
    *,
    K: int = 50,
    peak_thresh: float = 0.2,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, H, W, 3) BEV batch -> (detections, boxes_bev, boxes_real, mask),
    on the model's device."""
    with torch.inference_mode():
        outputs = forward_heads(model, bev)
        return _decode_heads(outputs, K, peak_thresh)


def init_detector(model, generator: Optional[torch.Generator] = None,
                  device: Device = None):
    """Initialise `model`'s weights from `generator` (the JAX package's init
    distributions), move it to `device` (default cuda; raises without a GPU
    unless device="cpu") and put it in eval mode. Returns the model."""
    dev = resolve_device(device)
    model.init_weights(generator)
    return model.to(dev).eval()
