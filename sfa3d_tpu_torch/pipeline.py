"""End-to-end frame pipelines in PyTorch, the port of `sfa3d_tpu/pipeline.py`.

raw padded points -> BEV raster (hand-written CUDA tile kernel) -> KFPN ->
clamped sigmoid -> peak decode -> metric 7-DOF boxes, all on one device and
under `torch.inference_mode()`. Public tensors keep the JAX layout (NHWC
raster and heads); the model runs NCHW inside.

A network set to bfloat16 (`models::to_inference_dtype`: bfloat16
convolutions, float32 BatchNorm, the level softmax in float32; the JAX
package's bfloat16 model) returns bfloat16 heads; the raster before it and
the decode after it stay float32, as in JAX (`clamped_sigmoid` in at
least float32, the other heads cast).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from sfa3d_tpu_torch.device import Device, resolve_device
from sfa3d_tpu_torch.models import clamped_sigmoid
from sfa3d_tpu_torch.ops.bev import points_to_bev_nchw
from sfa3d_tpu_torch.ops.decode import decode, detections_to_real, post_processing
from sfa3d_tpu_torch.spatial import row_sharded_forward


def _model_device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _check_model_device(model: torch.nn.Module, device: torch.device) -> None:
    have = _model_device(model)
    if have.type != device.type or (device.index is not None and have != device):
        raise ValueError(f"model lies on {have} but the call asks for {device}")


def _heads_nhwc(model, bev_nchw: torch.Tensor, mesh=None) -> Dict[str, torch.Tensor]:
    """The heads of a (B, 3, H, W) BEV batch, NHWC; on a data x spatial
    mesh computed on this rank's rows and gathered whole."""
    if mesh is None or mesh.spatial_size == 1:
        heads = model(bev_nchw)
    else:
        heads = row_sharded_forward(model, bev_nchw, mesh)
    return {k: v.permute(0, 2, 3, 1) for k, v in heads.items()}


def forward_heads(model, bev: torch.Tensor) -> Dict[str, torch.Tensor]:
    """(B, H, W, 3) BEV batch -> raw head dict, each (B, H/4, W/4, C), on
    the model's device (the JAX `model.apply(variables, bev)`; bfloat16
    heads from a bfloat16 network)."""
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
        bev, outputs, out = detect_program(model, points, valid, K, peak_thresh)
    out = {"bev": bev.permute(0, 2, 3, 1), **out}
    if return_heads:
        out["heads"] = outputs
    return out


def detect_program(model, points: torch.Tensor, valid: torch.Tensor, K: int,
                   peak_thresh: float):
    """`detect_frames`' program on tensors already on the model's device:
    raster, heads, decode -> (bev (B, 3, H, W), the raw head dict, {
    'detections', 'boxes_bev', 'boxes_real', 'mask'}). The exported
    detector (`runtime/export.py`) traces this same function."""
    bev = points_to_bev_nchw(points, valid)
    outputs = _heads_nhwc(model, bev)
    dets, boxes_bev, boxes_real, mask = _decode_heads(outputs, K, peak_thresh)
    return bev, outputs, {"detections": dets, "boxes_bev": boxes_bev,
                          "boxes_real": boxes_real, "mask": mask}


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
