"""High-level detector facades of the port, the counterpart of
`sfa3d_tpu/detector.py`.

    from sfa3d_tpu_torch import Detector, FusedDetector

    det = Detector()                                   # random init, on cuda
    det = Detector(checkpoint="Model_fpn_resnet_18_epoch_300.pth")
    det = Detector(checkpoint=".../Model_fpn_resnet_18_epoch_2.pth",
                   use_ema=True)                       # a port training checkpoint's EMA weights
    det = Detector(device="cpu")                       # explicit CPU run

    boxes = det.detect(points)        # (N, 4) raw velodyne points
    boxes = det.detect_file("000001.bin")

`Detector` returns a list of dicts {'class_id', 'class_name', 'score', 'x',
'y', 'z', 'h', 'w', 'l', 'yaw'} in the metric velodyne frame.
`FusedDetector` runs the camera + LiDAR fusion program on a scan, an RGB
image and its calibration. `ArtifactDetector` and `ArtifactFusedDetector`
give the same surfaces over an exported program (`runtime/export.py`).
`write_kitti_results` writes `format_detections` records as a KITTI
submission-format label file.
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


def write_kitti_results(dets: List[Dict], calib, path: str) -> None:
    """Write detections (`format_detections` records) as a KITTI
    submission-format label file: one camera-frame row per detection with
    its score appended, the layout the official devkit evaluates."""
    from sfa3d_tpu_torch.geometry.transforms import lidar_to_camera_box

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for d in dets:
            box = np.asarray([[d["x"], d["y"], d["z"], d["h"], d["w"], d["l"], d["yaw"]]])
            x, y, z, h, w, l, ry = np.asarray(lidar_to_camera_box(box, calib.V2C, calib.R0, calib.P2))[0]
            f.write(
                f"{d['class_name']} 0.00 0 0.00 0 0 50 50 "
                f"{h:.2f} {w:.2f} {l:.2f} {x:.2f} {y:.2f} {z:.2f} "
                f"{ry:.2f} {d['score']:.4f}\n"
            )


class Detector:
    """LiDAR detector on one device. `device` defaults to cuda and raises
    without a GPU; pass device="cpu" for a CPU run. Random weights come
    from `torch.Generator().manual_seed(seed)`. A `.pth` checkpoint is a
    reference state_dict or a training checkpoint of the port (use_ema
    selects its EMA weights).

    dtype="float32" (the default) is the parity mode: detections within
    1e-3 of the JAX package's float32 path. dtype="bfloat16" runs the
    network as the JAX package's bfloat16 model: its convolutions take
    bfloat16 weights, cast once here (`models::to_inference_dtype`), and
    its BatchNorms stay float32; the detections move by millimetres to
    decimetres (`scripts/torch_bf16_audit.py` measures the envelope). Any
    other dtype raises ValueError."""

    def __init__(
        self,
        arch: str = "fpn_resnet_18",
        checkpoint: Optional[str] = None,
        K: int = 50,
        peak_thresh: float = 0.2,
        dtype: str = "float32",
        device: Device = None,
        seed: int = 0,
        use_ema: bool = False,
    ):
        from sfa3d_tpu_torch.models import check_compute_dtype, create_model, to_inference_dtype
        from sfa3d_tpu_torch.pipeline import init_detector

        self.dtype = check_compute_dtype(dtype)
        self.device = resolve_device(device)
        self.K = K
        self.peak_thresh = peak_thresh
        self.arch = arch
        model = create_model(arch)
        if use_ema and (checkpoint is None or not checkpoint.endswith(".pth")):
            raise ValueError("use_ema needs a training checkpoint (.pth) of the port")
        if checkpoint is None:
            self.model = init_detector(model, torch.Generator().manual_seed(seed), self.device)
        elif checkpoint.endswith(".pth"):
            from sfa3d_tpu_torch.models.port import load_torch_checkpoint

            model.load_state_dict(load_torch_checkpoint(checkpoint, use_ema=use_ema), strict=True)
            self.model = model.to(self.device).eval()
        elif os.path.isdir(checkpoint):
            raise NotImplementedError(
                f"{checkpoint}: Orbax checkpoint directories need orbax/JAX and "
                "are not loadable by sfa3d_tpu_torch yet; export a .pth with "
                "sfa3d_tpu.models.port.save_torch_checkpoint"
            )
        else:
            raise FileNotFoundError(f"checkpoint not found or not a .pth file: {checkpoint}")
        to_inference_dtype(self.model, self.dtype)

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


class ArtifactDetector:
    """Detector facade over an exported program (`runtime/export.py`): the
    `detect` / `detect_batch` / `detect_file` surface of `Detector`, with
    the compute from the artifact, not from model code or a checkpoint. It
    backs `BatchingDetectorServer` (`cli serve --artifact model.sfa3dt`).
    Numpy in, numpy out; the device is the one in the manifest.

    Requires a `kind == 'detector'` artifact; symbolic-batch artifacts (the
    export default) serve every bucket size, while fixed-batch artifacts
    are served by padding every device batch up to their one size
    (BatchingDetectorServer does this and clamps max_batch)."""

    def __init__(self, path: str):
        from sfa3d_tpu_torch.runtime.export import load_exported

        self.artifact = load_exported(path)
        m = self.artifact.manifest
        if m.get("kind") != "detector":
            raise ValueError(
                f"{path}: artifact kind {m.get('kind')!r} cannot back the "
                "LiDAR detector server (need kind='detector'; fused "
                "artifacts take images+calib per request — use "
                "ArtifactFusedDetector; `cli serve --artifact` dispatches "
                "on kind)"
            )
        self.K = m["K"]
        self.peak_thresh = m["peak_thresh"]
        self.max_points = m["max_points"]
        self.fixed_batch = m["batch"]  # None == symbolic
        self.device = self.artifact.device

    def detect_batch(self, pts: np.ndarray, valid: np.ndarray) -> Dict[str, np.ndarray]:
        if pts.shape[1] != self.max_points:
            raise ValueError(
                f"artifact was exported for max_points={self.max_points}, "
                f"got scans padded to {pts.shape[1]}"
            )
        if self.fixed_batch is not None and pts.shape[0] != self.fixed_batch:
            raise ValueError(
                f"fixed-batch artifact (batch={self.fixed_batch}) cannot "
                f"run batch {pts.shape[0]}; re-export without --batch for a "
                "symbolic-batch artifact"
            )
        out = self.artifact.call(np.asarray(pts, np.float32), np.asarray(valid, bool))
        return {k: out[k].cpu().numpy() for k in ("mask", "boxes_real", "detections")}

    def detect(self, points: np.ndarray) -> List[Dict]:
        from sfa3d_tpu_torch.ops.bev import filter_and_pad_points

        pts, valid = filter_and_pad_points(points, max_points=self.max_points)
        return format_detections(self.detect_batch(pts[None], valid[None]), 0)

    def detect_file(self, velodyne_bin: str) -> List[Dict]:
        points = np.fromfile(velodyne_bin, dtype=np.float32).reshape(-1, 4)
        return self.detect(points)


class ArtifactFusedDetector:
    """FusedDetector facade over a fused exported program (`cli export
    --fused`): the `run_batch` seam that `BatchingFusedServer` drives, with
    the weights, the fusion settings and the camera's letterbox geometry
    baked into one file. The letterbox scale and pad are constants of the
    program, so run_batch takes the per-request hw / scale / pad and drops
    them; frames must have the baked `img_hw` (checked at submit).
    `imgsz` is the square letterbox canvas. Numpy in, numpy out."""

    def __init__(self, path: str):
        from sfa3d_tpu_torch.runtime.export import load_exported

        self.artifact = load_exported(path)
        m = self.artifact.manifest
        if m.get("kind") != "fused":
            raise ValueError(
                f"{path}: artifact kind {m.get('kind')!r} cannot back the "
                "fused pipeline (need kind='fused'; export with "
                "`cli export --fused`)"
            )
        self.imgsz = m["letterbox"]
        self.max_points = m["max_points"]
        self.img_hw = tuple(m["img_hw"])
        self.fixed_batch = m["batch"]  # None == symbolic
        self.device = self.artifact.device

    def run_batch(self, pts, valid, img, V2C, R0, P2, hw=None, scale=None, pad=None) -> Dict[str, np.ndarray]:
        """The fused program on one batch -> host dict of numpy arrays;
        hw / scale / pad are baked into the artifact and ignored here."""
        f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
        out = self.artifact.call(f32(pts), np.asarray(valid, bool), f32(img), f32(V2C), f32(R0), f32(P2))
        return {k: v.cpu().numpy() for k, v in out.items()}

    def detect(self, points: np.ndarray, image_rgb: np.ndarray, calib) -> Dict[str, np.ndarray]:
        """One frame through the artifact (FusedDetector.detect's reply)."""
        from sfa3d_tpu_torch.models.yolov8 import letterbox
        from sfa3d_tpu_torch.ops.bev import filter_and_pad_points

        h, w = image_rgb.shape[:2]
        if (h, w) != self.img_hw:
            raise ValueError(
                f"frame is {h}x{w} but the artifact bakes img_hw="
                f"{list(self.img_hw)}; re-export for this camera"
            )
        pts, valid = filter_and_pad_points(points, max_points=self.max_points)
        img, _, _ = letterbox(image_rgb, self.imgsz)
        out = self.run_batch(
            pts[None], valid[None], img[None],
            np.asarray(calib.V2C, np.float32)[None],
            np.asarray(calib.R0, np.float32)[None],
            np.asarray(calib.P2, np.float32)[None],
        )
        return fused_reply(out, 0)


def fused_reply(out: Dict[str, np.ndarray], i: int) -> Dict[str, np.ndarray]:
    """Host output of the fused program -> frame i's reply: 'boxes' (N, 4)
    int xywh image pixels, 'scores', 'classes', 'source' (0=yolo,
    1=sfa3d, 2=fused), 'boxes_3d' (M, 8) metric rows."""
    v = out["valid"][i]
    m3 = out["mask_3d"][i]
    return {
        "boxes": out["boxes"][i][v].astype(int),
        "scores": out["scores"][i][v],
        "classes": out["classes"][i][v],
        "source": out["source"][i][v],
        "boxes_3d": out["boxes_real"][i][m3],
    }


class FusedDetector:
    """The camera + LiDAR fusion path behind one call (SFA3D + YOLOv8 +
    fusion + NMS, `fusion/batch.py`), on one device.

        fd = FusedDetector()                               # random weights, cuda
        fd = FusedDetector(checkpoint="....pth",           # SFA3D weights
                           yolo_checkpoint="yolov8n.pt")   # ultralytics-layout .pt
        fd = FusedDetector(device="cpu", imgsz=(224, 640)) # CPU, KITTI canvas
        out = fd.detect(points, image_rgb, calib)

    Returns {'boxes' (N, 4) int xywh image pixels, 'scores', 'classes',
    'source' (0=yolo, 1=sfa3d, 2=fused), 'boxes_3d' (M, 8) metric rows}.

    `device` defaults to cuda and raises without a GPU. With no checkpoint
    the KFPN weights come from `torch.Generator().manual_seed(seed)` and
    the YOLO weights from `manual_seed(seed + 1)`. A YOLO checkpoint sizes
    the model from its own shapes; `yolo_scale` only picks the scale of
    random weights ('n' by default) and must agree with a checkpoint.
    `imgsz` is the letterbox canvas: an int (square) or (h, w). `dtype`
    is `Detector`'s: "bfloat16" runs KFPN and YOLOv8 in bfloat16, and the
    stages after the networks in float32.
    """

    def __init__(
        self,
        arch: str = "fpn_resnet_18",
        checkpoint: Optional[str] = None,
        yolo_scale: Optional[str] = None,
        yolo_checkpoint: Optional[str] = None,
        mode: str = "bayesian",
        use_gaussian_nms: bool = True,
        K: int = 50,
        max_yolo: int = 64,  # == fusion.DEFAULT_MAX_YOLO
        peak_thresh: float = 0.2,
        confidence_threshold: float = 0.25,
        fusion_iou_threshold: float = 0.7,
        gaussian_sigma: float = 0.5,
        imgsz=640,
        dtype: str = "float32",
        device: Device = None,
        seed: int = 0,
    ):
        from sfa3d_tpu_torch.fusion.batch import build_fused_pipeline
        from sfa3d_tpu_torch.models import to_inference_dtype
        from sfa3d_tpu_torch.models.yolov8 import YOLOv8, load_yolo_checkpoint

        base = Detector(arch=arch, checkpoint=checkpoint, K=K, peak_thresh=peak_thresh,
                        dtype=dtype, device=device, seed=seed)
        self.device = base.device
        self.kfpn = base.model
        self.imgsz = imgsz
        if yolo_checkpoint:
            yolo = load_yolo_checkpoint(yolo_checkpoint)
            if yolo_scale is not None and yolo_scale != yolo.scale:
                raise ValueError(
                    f"{yolo_checkpoint} holds a YOLOv8{yolo.scale}, not the yolo_scale={yolo_scale!r} asked for"
                )
        else:
            yolo = YOLOv8(scale=yolo_scale or "n").init_weights(torch.Generator().manual_seed(seed + 1))
        self.yolo = to_inference_dtype(yolo.to(self.device).eval(), base.dtype)
        self._run = build_fused_pipeline(
            self.kfpn, self.yolo, K=K, max_yolo=max_yolo, mode=mode,
            use_gaussian_nms=use_gaussian_nms, peak_thresh=peak_thresh,
            confidence_threshold=confidence_threshold,
            fusion_iou_threshold=fusion_iou_threshold,
            gaussian_sigma=gaussian_sigma, device=self.device,
        )

    def run_batch(self, pts, valid, img, V2C, R0, P2, hw, scale, pad) -> Dict[str, np.ndarray]:
        """One batch of padded scans, letterboxed images and calibrations
        through the fused program -> host dict of numpy arrays."""
        out = self._run(pts, valid, img, V2C, R0, P2, hw, scale, pad)
        return {k: v.cpu().numpy() for k, v in out.items()}

    def detect(self, points: np.ndarray, image_rgb: np.ndarray, calib) -> Dict[str, np.ndarray]:
        """One frame: (N, 4) raw velodyne scan + HxWx3 RGB image + calibration."""
        from sfa3d_tpu_torch.models.yolov8 import letterbox
        from sfa3d_tpu_torch.ops.bev import filter_and_pad_points

        pts, valid = filter_and_pad_points(points, max_points=cnf.MAX_POINTS_FILTERED)
        img, r, (pad_w, pad_h) = letterbox(image_rgb, self.imgsz)
        h, w = image_rgb.shape[:2]
        out = self.run_batch(
            pts[None], valid[None], img[None],
            np.asarray(calib.V2C, np.float32)[None],
            np.asarray(calib.R0, np.float32)[None],
            np.asarray(calib.P2, np.float32)[None],
            np.float32([[h, w]]), np.float32([r]), np.float32([[pad_w, pad_h]]),
        )
        return fused_reply(out, 0)
