"""The whole camera + LiDAR fusion program, batched over frames on one
device: the port of `sfa3d_tpu/fusion/batch.py::build_fused_pipeline`.

SFA3D on the LiDAR scan (BEV raster -> KFPN -> decode -> metric boxes),
YOLOv8 on the camera image (backbone -> DFL decode -> per-class NMS), 3D to
2D projection, confidence gating, fusion and NMS. JAX's `vmap` over frames
is the batch axis written out: every stage runs once per batch, and each of
the three sequential loops (the YOLO NMS, the greedy match, the soft-NMS or
hard NMS of the fused set) is one launch of a CUDA loop kernel for the
whole batch (`ops/fusion_loops.py`). The raster is the BEV tile kernel
(`ops/bev_counts.py::bev_raster_reduce`).

Frame inputs per batch element:
  points (P, 4) + valid (P,)   raw padded velodyne scan
  image (H, W, 3) float [0,1]  letterboxed RGB (host letterbox, models/yolov8.py)
  V2C (3, 4), R0 (3, 3), P2 (3, 4)   calibration
  img_hw (2,)                  ORIGINAL camera image (h, w) in pixels
  lb_scale (), lb_pad (2,)     letterbox scale r and (pad_w, pad_h)

Fused outputs are in original camera pixels, fixed (max_yolo + K) slots.

With a (data x spatial) mesh (`parallel/mesh.py::make_mesh_2d`), JAX's
`mesh=` program: each rank takes its data index's frames of the batch,
rasterizes them (one raster launch), keeps its spatial index's BEV rows
and letterboxed image rows, and runs both conv towers on them inside
`spatial.py::row_sharded`; the KFPN heads and the YOLO levels are gathered
whole, and the decode, projection, YOLO selection, match and soft-NMS run
on the rank's frames, so every rank of a spatial group returns the same
frames: its data shard's.

Networks set to bfloat16 (`models::to_inference_dtype`) run as the JAX
program's bfloat16 models: their BatchNorms, the level softmax, the heads'
decode and the DFL softmax take float32, and every stage after the
networks (letterbox maths, projection, fusion, the loop kernels) sees
float32.
"""

from __future__ import annotations

from typing import Dict

import torch

from sfa3d_tpu_torch.device import Device, resolve_device
from sfa3d_tpu_torch.fusion.boxes2d import project_boxes_to_image
from sfa3d_tpu_torch.fusion.fuse import (
    DetectionSet,
    filter_by_confidence,
    fuse_bayesian,
    fuse_union_nms,
    fuse_weighted,
)
from sfa3d_tpu_torch.fusion.nms import hard_nms, soft_nms_gaussian
from sfa3d_tpu_torch.models.yolov8 import decode_predictions, forward_levels, select_detections
from sfa3d_tpu_torch.ops.bev import points_to_bev_nchw
from sfa3d_tpu_torch.parallel.mesh import shard_batch
from sfa3d_tpu_torch.pipeline import _check_model_device, _decode_heads, _heads_nhwc
from sfa3d_tpu_torch.spatial import row_sharded, shard_rows

FUSION_MODES = ("nms", "weighted", "bayesian")


def _unletterbox_xywh(boxes_xyxy, scale, pad, img_hw):
    """Letterboxed xyxy (B, K, 4) -> original-pixel int-truncated xywh,
    with per-frame scale (B,), pad (B, 2) and img_hw (B, 2). The divisions
    are true divisions, as in JAX (scale is a traced input there)."""
    scale = scale[:, None]
    x1 = (boxes_xyxy[..., 0] - pad[:, 0:1]) / scale
    y1 = (boxes_xyxy[..., 1] - pad[:, 1:2]) / scale
    x2 = (boxes_xyxy[..., 2] - pad[:, 0:1]) / scale
    y2 = (boxes_xyxy[..., 3] - pad[:, 1:2]) / scale
    h, w = img_hw[:, 0:1], img_hw[:, 1:2]
    x1, x2 = torch.minimum(torch.clamp_min(x1, 0), w), torch.minimum(torch.clamp_min(x2, 0), w)
    y1, y2 = torch.minimum(torch.clamp_min(y1, 0), h), torch.minimum(torch.clamp_min(y2, 0), h)
    x1, y1, x2, y2 = map(torch.trunc, (x1, y1, x2, y2))
    return torch.stack([x1, y1, x2 - x1, y2 - y1], dim=-1)


def _fuse_one(
    yolo_boxes,
    yolo_scores,
    yolo_classes,
    yolo_valid,
    sfa_boxes2d,
    sfa_scores,
    sfa_classes,
    sfa_valid,
    *,
    mode: str,
    confidence_threshold: float,
    fusion_iou_threshold: float,
    nms_threshold: float,
    use_gaussian_nms: bool,
    gaussian_sigma: float,
):
    """The strategy dispatch: gate both sets, fuse with `mode`, NMS the
    result -> (fused DetectionSet, source). Batched (B, K, ...) or one frame;
    `fusion/pipeline.py::fuse_frame` runs the same dispatch."""
    yolo_set = filter_by_confidence(
        DetectionSet(yolo_boxes, yolo_scores, yolo_classes, yolo_valid), confidence_threshold
    )
    sfa_set = filter_by_confidence(
        DetectionSet(sfa_boxes2d, sfa_scores, sfa_classes, sfa_valid), confidence_threshold
    )
    if mode == "nms":
        fused, source = fuse_union_nms(yolo_set, sfa_set, nms_threshold)
    elif mode == "weighted":
        fused, source = fuse_weighted(yolo_set, sfa_set, fusion_iou_threshold)
        keep = hard_nms(fused.boxes, fused.scores, fused.valid, nms_threshold)
        fused = fused._replace(valid=fused.valid & keep)
    else:
        fused, source = fuse_bayesian(yolo_set, sfa_set, fusion_iou_threshold)
        if use_gaussian_nms:
            new_scores, surv = soft_nms_gaussian(fused.boxes, fused.scores, fused.valid,
                                                 sigma=gaussian_sigma)
            fused = fused._replace(scores=new_scores, valid=surv)
        else:
            keep = hard_nms(fused.boxes, fused.scores, fused.valid, nms_threshold)
            fused = fused._replace(valid=fused.valid & keep)
    return fused, source


class FusedProgram(torch.nn.Module):
    """The batched fusion program on tensors already on the models' device:
    forward(points, valid, images, V2C, R0, P2, img_hw, lb_scale, lb_pad)
    -> the dict `build_fused_pipeline`'s run returns. It holds both models,
    so the exported fused artifact (`runtime/export.py::export_fused`)
    traces it with their weights. With `mesh` (a data x spatial mesh) the
    inputs are the rank's data shard and both networks run on its rows."""

    def __init__(
        self,
        kfpn_model,
        yolo_model,
        *,
        K: int = 50,
        max_yolo: int = 64,  # == fusion.DEFAULT_MAX_YOLO
        mode: str = "bayesian",
        use_gaussian_nms: bool = True,
        peak_thresh: float = 0.2,
        sfa_conf_gate: float = 0.2,
        yolo_conf: float = 0.25,
        yolo_iou: float = 0.45,
        confidence_threshold: float = 0.25,
        fusion_iou_threshold: float = 0.7,
        nms_threshold: float = 0.5,
        gaussian_sigma: float = 0.5,
        return_bev: bool = False,
        bev_size=(608, 608),
        mesh=None,
    ):
        super().__init__()
        if mode not in FUSION_MODES:
            raise ValueError(f"unknown fusion mode: {mode!r}")
        self.kfpn, self.yolo, self.mesh = kfpn_model, yolo_model, mesh
        self.K, self.max_yolo, self.peak_thresh = K, max_yolo, peak_thresh
        self.sfa_conf_gate, self.yolo_conf, self.yolo_iou = sfa_conf_gate, yolo_conf, yolo_iou
        self.return_bev, self.bev_size = return_bev, tuple(bev_size)
        self.fuse_kw = dict(
            mode=mode,
            confidence_threshold=confidence_threshold,
            fusion_iou_threshold=fusion_iou_threshold,
            nms_threshold=nms_threshold,
            use_gaussian_nms=use_gaussian_nms,
            gaussian_sigma=gaussian_sigma,
        )

    def kfpn_heads(self, bev: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(B, 3, H, W) BEV -> the KFPN's NHWC heads of the B frames, whole:
        with a mesh computed on the rank's rows and gathered."""
        return _heads_nhwc(self.kfpn, bev, self.mesh)

    def yolo_levels(self, images: torch.Tensor):
        """(B, H, W, 3) letterboxed images -> YOLOv8's NHWC levels, whole:
        with a mesh computed on the rank's rows and gathered."""
        if self.mesh is None:
            return forward_levels(self.yolo, images)
        with row_sharded(self.mesh, *images.shape[1:3]):
            return forward_levels(self.yolo, shard_rows(self.mesh, images, axis=1))

    def forward(self, points, valid, images, V2C, R0, P2, img_hw, lb_scale, lb_pad) -> Dict[str, torch.Tensor]:
        # --- SFA3D (LiDAR) branch ---
        bev = points_to_bev_nchw(points, valid, bev_height=self.bev_size[0], bev_width=self.bev_size[1])
        _, boxes_bev, boxes_real, mask = _decode_heads(self.kfpn_heads(bev), self.K, self.peak_thresh)
        sfa_scores = boxes_bev[..., 1]
        sfa2d, sfa_valid = project_boxes_to_image(
            boxes_real, sfa_scores, mask, V2C, R0, P2,
            img_h=img_hw[:, 0], img_w=img_hw[:, 1], conf_gate=self.sfa_conf_gate,
        )

        # --- YOLOv8 (camera) branch ---
        yboxes_all, yscores_all = decode_predictions(self.yolo_levels(images))
        yb_xyxy, ys, yc, yv = select_detections(
            yboxes_all, yscores_all, conf_thresh=self.yolo_conf, iou_thresh=self.yolo_iou,
            max_det=self.max_yolo,
        )
        yb = _unletterbox_xywh(yb_xyxy, lb_scale, lb_pad, img_hw)

        # --- fuse ---
        fused, source = _fuse_one(
            yb, ys, yc, yv, sfa2d, sfa_scores, boxes_real[..., 0].to(torch.int32), sfa_valid,
            **self.fuse_kw,
        )
        out = {
            "boxes": fused.boxes,
            "scores": fused.scores,
            "classes": fused.classes,
            "valid": fused.valid,
            "source": source,
            "boxes_real": boxes_real,
            "mask_3d": mask,
        }
        if self.return_bev:
            out["bev"] = bev.permute(0, 2, 3, 1)
        return out


def build_fused_pipeline(kfpn_model, yolo_model, *, device: Device = None, mesh=None, **program_kwargs):
    """Build the batched fusion step. `program_kwargs` are `FusedProgram`'s
    (K, max_yolo, mode, use_gaussian_nms, peak_thresh, sfa_conf_gate,
    yolo_conf, yolo_iou, confidence_threshold, fusion_iou_threshold,
    nms_threshold, gaussian_sigma, return_bev, bev_size).

    `mesh`: an optional data x spatial mesh (`parallel/mesh.py::make_mesh_2d`),
    the counterpart of JAX's `mesh=`. Every rank passes the whole batch
    (which must divide over 'data') and gets its data shard's frames back,
    each rank of a spatial group the same; the models lie on the mesh's
    device.

    Returns run(points, valid, images, V2C, R0, P2, img_hw, lb_scale, lb_pad)
    -> dict of tensors on `device` with:
      boxes (B, max_yolo+K, 4) int-valued xywh in original camera pixels
      scores / classes / valid / source (B, max_yolo+K)
      boxes_real (B, K, 8) metric 3D rows + mask_3d (B, K)  (SFA3D branch)
      bev (B, H, W, 3)  only with return_bev
    `source`: 0 = YOLO pass-through, 1 = SFA3D pass-through, 2 = fused.

    The models carry their weights and must lie on `device` (default cuda:
    `run` raises without a GPU unless device="cpu"). Inputs may be numpy or
    tensors. `bev_size` shrinks the raster for small checks; the metric
    decode constants assume 608x608.
    """
    program = FusedProgram(kfpn_model, yolo_model, mesh=mesh, **program_kwargs)

    def run(points, valid, images, V2C, R0, P2, img_hw, lb_scale, lb_pad) -> Dict[str, torch.Tensor]:
        dev = resolve_device(device) if mesh is None else mesh.device
        _check_model_device(kfpn_model, dev)
        _check_model_device(yolo_model, dev)
        if mesh is not None:
            points, valid, images, V2C, R0, P2, img_hw, lb_scale, lb_pad = (
                shard_batch(mesh, torch.as_tensor(a)) for a in (points, valid, images, V2C, R0, P2, img_hw,
                                                               lb_scale, lb_pad))

        def f32(a):
            return torch.as_tensor(a).to(dev, torch.float32, non_blocking=True)

        with torch.inference_mode():
            points, images = f32(points), f32(images)
            valid = torch.as_tensor(valid).to(dev, torch.bool, non_blocking=True)
            V2C, R0, P2, img_hw, lb_scale, lb_pad = map(f32, (V2C, R0, P2, img_hw, lb_scale, lb_pad))
            return program(points, valid, images, V2C, R0, P2, img_hw, lb_scale, lb_pad)

    return run
