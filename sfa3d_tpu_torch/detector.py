"""High-level detector facade of the port, the counterpart of
`sfa3d_tpu/detector.py`.

    from sfa3d_tpu_torch import Detector

    det = Detector()                                   # random init, on cuda
    det = Detector(checkpoint="Model_fpn_resnet_18_epoch_300.pth")
    det = Detector(device="cpu")                       # explicit CPU run

    boxes = det.detect(points)        # (N, 4) raw velodyne points
    boxes = det.detect_file("000001.bin")

Returns a list of dicts {'class_id', 'class_name', 'score', 'x', 'y', 'z',
'h', 'w', 'l', 'yaw'} in the metric velodyne frame.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from sfa3d_tpu_torch.config import kitti as cnf
from sfa3d_tpu_torch.device import Device, resolve_device


def format_detections(out: Dict, i: int) -> List[Dict]:
    """detect_frames output (numpy or tensors) -> list of detection dicts
    for frame i."""
    host = {k: torch.as_tensor(out[k]).cpu().numpy()
            for k in ("mask", "boxes_real", "detections")}
    mask = host["mask"][i]
    real = host["boxes_real"][i]
    scores = host["detections"][i, :, 0]
    dets = []
    for row, score in zip(real[mask], scores[mask]):
        cls = int(row[0])
        dets.append(
            {
                "class_id": cls,
                "class_name": cnf.ID_TO_CLASS_NAME.get(cls, str(cls)),
                "score": float(score),
                "x": float(row[1]), "y": float(row[2]), "z": float(row[3]),
                "h": float(row[4]), "w": float(row[5]), "l": float(row[6]),
                "yaw": float(row[7]),
            }
        )
    return dets


class Detector:
    """LiDAR detector on one device. `device` defaults to cuda and raises
    without a GPU; pass device="cpu" for a CPU run. Random weights come
    from `torch.Generator().manual_seed(seed)`."""

    def __init__(
        self,
        arch: str = "fpn_resnet_18",
        checkpoint: Optional[str] = None,
        K: int = 50,
        peak_thresh: float = 0.2,
        dtype: str = "float32",
        device: Device = None,
        seed: int = 0,
    ):
        from sfa3d_tpu_torch.models import create_model
        from sfa3d_tpu_torch.pipeline import init_detector

        if dtype != "float32":
            raise ValueError(f"sfa3d_tpu_torch.Detector runs float32 only; got dtype={dtype!r}")
        self.device = resolve_device(device)
        self.K = K
        self.peak_thresh = peak_thresh
        self.arch = arch
        model = create_model(arch)
        if checkpoint is None:
            self.model = init_detector(model, torch.Generator().manual_seed(seed), self.device)
        elif checkpoint.endswith(".pth"):
            from sfa3d_tpu_torch.models.port import load_torch_checkpoint

            model.load_state_dict(load_torch_checkpoint(checkpoint), strict=True)
            self.model = model.to(self.device).eval()
        elif os.path.isdir(checkpoint):
            raise NotImplementedError(
                f"{checkpoint}: Orbax checkpoint directories need orbax/JAX and "
                "are not loadable by sfa3d_tpu_torch yet; export a .pth with "
                "sfa3d_tpu.models.port.save_torch_checkpoint"
            )
        else:
            raise FileNotFoundError(f"checkpoint not found or not a .pth file: {checkpoint}")

    def detect_batch(self, pts: np.ndarray, valid: np.ndarray) -> Dict[str, np.ndarray]:
        """(B, P, 4) padded scans + (B, P) masks -> host dict with the small
        output arrays only ('mask', 'boxes_real', 'detections'). The raster
        stays on the device."""
        from sfa3d_tpu_torch.pipeline import detect_frames

        out = detect_frames(
            self.model, pts, valid, K=self.K, peak_thresh=self.peak_thresh,
            device=self.device,
        )
        return {k: out[k].cpu().numpy() for k in ("mask", "boxes_real", "detections")}

    def detect(self, points: np.ndarray) -> List[Dict]:
        """(N, 4) raw velodyne scan -> list of detection dicts."""
        from sfa3d_tpu_torch.ops.bev import filter_and_pad_points

        pts, valid = filter_and_pad_points(points, max_points=cnf.MAX_POINTS_FILTERED)
        return format_detections(self.detect_batch(pts[None], valid[None]), 0)

    def detect_file(self, velodyne_bin: str) -> List[Dict]:
        points = np.fromfile(velodyne_bin, dtype=np.float32).reshape(-1, 4)
        return self.detect(points)
