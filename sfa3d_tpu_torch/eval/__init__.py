"""Evaluation of the port: KITTI 3D / BEV AP (`kitti_eval`) and 2D mAP
(`map2d`)."""

from sfa3d_tpu_torch.eval.kitti_eval import evaluate_kitti_ap, evaluate_kitti_ap_by_difficulty
from sfa3d_tpu_torch.eval.map2d import evaluate_map2d

__all__ = ["evaluate_kitti_ap", "evaluate_kitti_ap_by_difficulty", "evaluate_map2d"]
