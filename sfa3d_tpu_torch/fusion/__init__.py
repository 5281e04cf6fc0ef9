"""Camera-LiDAR late fusion in PyTorch, the port of `sfa3d_tpu/fusion/`.

Fixed-K masked tensor programs with a batch axis written out:
- pairwise IoU                          (fusion/iou.py)
- 3D detections -> camera 2D AABBs      (fusion/boxes2d.py)
- hard / soft (Gaussian) NMS            (fusion/nms.py, CUDA loop kernels)
- union+NMS, confidence-weighted and Bayesian inverse-variance fusion
                                        (fusion/fuse.py)
- the batched camera+LiDAR program      (fusion/batch.py)
- the per-frame host orchestration      (fusion/pipeline.py)

Names are re-exported lazily, so importing one submodule does not import
the others.
"""

# one capacity constant for YOLO detection slots, shared by the host
# per-frame pipeline and the batched program so the two agree
DEFAULT_MAX_YOLO = 64

_EXPORTS = {
    "pairwise_iou_xywh": "iou",
    "iou_xywh": "iou",
    "project_boxes_to_image": "boxes2d",
    "hard_nms": "nms",
    "soft_nms_gaussian": "nms",
    "DetectionSet": "fuse",
    "filter_by_confidence": "fuse",
    "greedy_match": "fuse",
    "fuse_weighted": "fuse",
    "fuse_bayesian": "fuse",
    "fuse_union_nms": "fuse",
    "confidence_to_variance": "fuse",
    "fuse_gaussian_parameters": "fuse",
    "rescore_3d_from_camera": "fuse",
    "build_fused_pipeline": "batch",
    "fuse_frame": "pipeline",
    "FUSION_MODES": "pipeline",
}

__all__ = ["DEFAULT_MAX_YOLO", *_EXPORTS]


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
    raise AttributeError(name)
