"""Per-frame camera-LiDAR fusion (the host orchestration), the port of
`sfa3d_tpu/fusion/pipeline.py`.

Project the 3D detections into the image, confidence-gate both sets, fuse
with the selected strategy, then NMS the fused set. The tensor work runs on
`device` (default cuda; raises without a GPU unless device="cpu"); the
YOLO padding and the final ragged unpack run on the host.
"""

from __future__ import annotations

import warnings
from typing import Dict

import numpy as np
import torch

from sfa3d_tpu_torch.device import Device, resolve_device
from sfa3d_tpu_torch.fusion.batch import FUSION_MODES, _fuse_one
from sfa3d_tpu_torch.fusion.boxes2d import project_boxes_to_image


def fuse_frame(
    yolo_boxes_xywh,
    yolo_scores,
    yolo_classes,
    sfa_boxes_real,
    sfa_scores,
    sfa_mask,
    calib,
    img_shape,
    *,
    mode: str = "bayesian",
    confidence_threshold: float = 0.25,
    fusion_iou_threshold: float = 0.7,
    nms_threshold: float = 0.5,
    use_gaussian_nms: bool = False,
    gaussian_sigma: float = 0.5,
    sfa_conf_gate: float = 0.3,
    max_yolo: int = 64,  # == fusion.DEFAULT_MAX_YOLO
    device: Device = None,
) -> Dict[str, np.ndarray]:
    """Fuse one frame's detections.

    Args:
      yolo_*: host lists/arrays from YOLOv8Detector (original image pixels).
      sfa_boxes_real: (K, 8) metric rows [cls, x, y, z, h, w, l, yaw],
      sfa_scores/sfa_mask: (K,) from the SFA3D decode.
      calib: KittiCalibration (V2C/R0/P2).
      img_shape: (H, W) of the camera image.

    Returns 'boxes' (N, 4) int xywh, 'scores' (N,), 'classes' (N,),
    'source' (N,) {0: yolo, 1: sfa3d, 2: fused} after unpadding.
    """
    if mode not in FUSION_MODES:
        raise ValueError(f"mode must be one of {FUSION_MODES}")
    dev = resolve_device(device)
    img_h, img_w = int(img_shape[0]), int(img_shape[1])

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), device=dev).to(dtype)

    sfa_real = t(sfa_boxes_real)
    sfa_conf = t(sfa_scores)
    sfa2d, sfa_valid = project_boxes_to_image(
        sfa_real, sfa_conf, t(sfa_mask, torch.bool), t(calib.V2C), t(calib.R0), t(calib.P2),
        img_h=img_h, img_w=img_w, conf_gate=sfa_conf_gate,
    )

    # YOLO set: pad to fixed slots
    ky = max_yolo
    yb = np.zeros((ky, 4), np.float32)
    ys = np.zeros((ky,), np.float32)
    yc = np.zeros((ky,), np.int32)
    yv = np.zeros((ky,), bool)
    n = min(len(yolo_boxes_xywh), ky)
    if len(yolo_boxes_xywh) > ky:
        warnings.warn(
            f"fuse_frame: {len(yolo_boxes_xywh)} YOLO detections exceed the "
            f"{ky} fixed slots; keeping the first {ky} (sort by confidence "
            "or raise max_yolo)",
            RuntimeWarning,
            stacklevel=2,
        )
    if n:
        yb[:n] = np.asarray(yolo_boxes_xywh, np.float32)[:n]
        ys[:n] = np.asarray(yolo_scores, np.float32)[:n]
        yc[:n] = np.asarray(yolo_classes, np.int32)[:n]
        yv[:n] = True
    fused, source = _fuse_one(
        t(yb), t(ys), t(yc, torch.int32), t(yv, torch.bool),
        sfa2d, sfa_conf, sfa_real[:, 0].to(torch.int32), sfa_valid,
        mode=mode, confidence_threshold=confidence_threshold,
        fusion_iou_threshold=fusion_iou_threshold, nms_threshold=nms_threshold,
        use_gaussian_nms=use_gaussian_nms, gaussian_sigma=gaussian_sigma,
    )
    valid = fused.valid.cpu().numpy()
    return {
        "boxes": fused.boxes.cpu().numpy()[valid].astype(int),
        "scores": fused.scores.cpu().numpy()[valid],
        "classes": fused.classes.cpu().numpy()[valid],
        "source": source.cpu().numpy()[valid],
    }
