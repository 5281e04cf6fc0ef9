"""The YOLOv8 training epoch and eval pass, the port of
`sfa3d_tpu/parallel/yolo_step.py`, on one device or data-parallel over the
ranks of a `parallel/mesh.py` mesh.

The whole split lives on the device as uint8 (`data/yolo2d.py` layout) and
an epoch is S optimizer steps over an (S, B) index: each step gathers its
B frames there, casts them as XLA compiles the JAX step's `/ 255.0` (a
multiplication by float32(1 / 255)), mirrors the frames drawn for hflip
(and their boxes about the canvas width), runs forward, `yolo_loss`,
backward and one AdamW update (`runtime/schedules.py::yolo_adamw`, the
learning rate from the schedule at the step count before the update), with
the BatchNorm statistics carried from step to step. With ema_decay > 0 the
parameter EMA then advances in the JAX YOLO step's form
e * d + p * (1 - d), d = ema_decay_at(step + 1) in float32. Each step's
parts are profiler ranges: yolo.forward_loss, yolo.backward, yolo.adamw,
yolo.ema.

With a mesh of more than one rank (`mesh=`), as under JAX's mesh, every
rank holds the whole split and takes the same global (S, B) index and
hflip draws; each step, rank r takes columns [r * B / world, (r + 1) * B
/ world) of the step's row, runs forward and loss inside
`data_parallel(mesh)` (global BatchNorm statistics, the global
target-score normalizer), and the gradients are summed over the ranks
before the AdamW update (`mesh.py::all_reduce_grads`). The per-step losses
are all-reduced once at the end of the epoch, so the metrics are the
global batch's on every rank.

The eval pass runs the model in eval mode (optionally with other
parameters, e.g. the EMA's, over the live BatchNorm statistics),
`decode_predictions` and `select_detections` (conf 0.001, IoU 0.45, 100
detections from the top 512 candidates): one `hard_nms_keep` launch per
batch on the card.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from sfa3d_tpu_torch.collectives import all_reduce_sum, data_parallel
from sfa3d_tpu_torch.losses.yolo_loss import yolo_loss
from sfa3d_tpu_torch.parallel.mesh import Mesh, all_reduce_grads
from sfa3d_tpu_torch.parallel.train_step import TrainState, _check_device, create_train_state, ema_decay_at

__all__ = ["TrainState", "create_train_state", "make_yolo_epoch_fn", "make_yolo_eval_fn", "to_unit_float"]

LOSS_KEYS = ("total", "box", "cls", "dfl", "num_fg")
INV_255 = float(np.float32(1.0 / 255.0))  # XLA's constant for x / 255.0 in float32


def to_unit_float(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 images -> float32 in [0, 1], as XLA compiles `x / 255.0`."""
    return images_u8.to(torch.float32) * INV_255


def _flip_batch(imgs: torch.Tensor, boxes: torch.Tensor, flip: torch.Tensor):
    """Mirror (B, H, W, 3) images and their xyxy boxes about the canvas
    width where `flip` is True (x -> W - x: pixel centres i + 0.5 map to
    W - i - 0.5, as the array reversal does)."""
    w = imgs.shape[2]
    f_imgs = torch.where(flip[:, None, None, None], torch.flip(imgs, dims=[2]), imgs)
    mirrored = torch.stack([w - boxes[..., 2], boxes[..., 1], w - boxes[..., 0], boxes[..., 3]], -1)
    return f_imgs, torch.where(flip[:, None, None], mirrored, boxes)


def _levels_nhwc(model: nn.Module, imgs_nhwc: torch.Tensor, params=None):
    x = imgs_nhwc.permute(0, 3, 1, 2)
    if params is None:
        levels = model(x)
    else:
        levels = torch.func.functional_call(model, params, (x,), strict=False)
    return [(b.permute(0, 2, 3, 1), c.permute(0, 2, 3, 1)) for b, c in levels]


def make_yolo_epoch_fn(model: nn.Module, tx, imgsz, ema_decay: float = 0.0, ema_tau: float = 2000.0,
                       hflip_prob: float = 0.5, device=None, mesh: Optional[Mesh] = None) -> Callable:
    """-> epoch_fn(state, data, idx, flips=None, generator=None) ->
    (state, metrics), run in place on the state's model and optimizer, on
    `device` (default cuda; raises without a GPU unless device="cpu").

    data: {"images" (N, h, w, 3) uint8, "boxes" (N, G, 4) float32
    letterboxed xyxy, "labels" (N, G) int, "mask" (N, G) bool}, on the
    model's device. idx: (S, B) frame indices. flips: an (S, B) bool tensor
    of the frames to mirror; without it they are drawn as
    `torch.rand((S, B), generator=generator) < hflip_prob`. metrics: the
    epoch means of total / box / cls / dfl loss and num_fg, 0-dim tensors
    on the device. With `mesh`, idx and flips are the global ones (the
    same on every rank) and the rank takes its share of each row."""
    _check_device(model, device, mesh)
    synced = mesh is not None and mesh.synced

    def epoch_fn(state: TrainState, data: Dict[str, torch.Tensor], idx, flips=None,
                 generator: Optional[torch.Generator] = None) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        m = state.model
        if m is not model:
            raise ValueError("the state was made over another model")
        dev = data["images"].device
        idx = torch.as_tensor(idx, device=dev).long()
        if flips is None:
            flips = torch.rand(tuple(idx.shape), generator=generator) < hflip_prob
        flips = torch.as_tensor(flips, device=dev)
        if flips.shape != idx.shape:
            raise ValueError(f"flips {tuple(flips.shape)} do not match idx {tuple(idx.shape)}")
        if synced:  # this rank's columns of the global index and draws
            if idx.shape[1] % mesh.world_size:
                raise ValueError(f"a per-step batch of {idx.shape[1]} does not divide over {mesh.world_size} ranks")
            k = idx.shape[1] // mesh.world_size
            idx, flips = idx[:, mesh.rank * k:(mesh.rank + 1) * k], flips[:, mesh.rank * k:(mesh.rank + 1) * k]
        dtype = next(m.parameters()).dtype
        m.train()
        per_step = []
        for s in range(idx.shape[0]):
            ix = idx[s]
            state.optimizer.zero_grad(set_to_none=True)
            with record_function("yolo.forward_loss"), data_parallel(mesh):
                imgs, boxes = _flip_batch(to_unit_float(data["images"][ix]), data["boxes"][ix], flips[s])
                losses = yolo_loss(_levels_nhwc(m, imgs.to(dtype)), boxes, data["labels"][ix], data["mask"][ix],
                                   imgsz=imgsz)
            with record_function("yolo.backward"):
                losses["total"].backward()
                if synced:
                    all_reduce_grads(m.parameters(), mesh)
            with record_function("yolo.adamw"):
                state.tx.apply_schedule(state.optimizer, state.step)
                state.optimizer.step()
            if ema_decay > 0.0:
                if state.ema_params is None:
                    raise ValueError("ema_decay > 0 requires create_train_state(..., ema=True)")
                d = ema_decay_at(state.step + 1, ema_decay, ema_tau)
                keep, take = float(d), float(np.float32(1.0) - d)
                with torch.no_grad(), record_function("yolo.ema"):
                    for k, e in state.ema_params.items():
                        e.copy_(e * keep + m.get_parameter(k).detach().to(e.dtype) * take)
            state.step += 1
            per_step.append(torch.stack([losses[k].detach().to(torch.float64) for k in LOSS_KEYS]))
        table = torch.stack(per_step)
        if synced:  # the per-rank shares -> the global batch's losses
            table = all_reduce_sum(table, mesh.process_group)
        means = table.mean(0)
        return state, {k: means[i] for i, k in enumerate(LOSS_KEYS)}

    return epoch_fn


def make_yolo_eval_fn(model: nn.Module, conf_thresh: float = 0.001, iou_thresh: float = 0.45,
                      max_det: int = 100, pre_nms: int = 512, device=None) -> Callable:
    """-> eval_fn(images_u8 (B, h, w, 3), params=None) -> (boxes (B,
    max_det, 4) xyxy, scores (B, max_det), classes (B, max_det) int32,
    valid (B, max_det)) after class-offset NMS, on the model's device.
    `params` (name -> tensor, e.g. the EMA weights) replaces the model's
    parameters for the pass; BatchNorm uses the model's running
    statistics. The confidence floor defaults to 0.001: AP needs the whole
    precision-recall curve."""
    from sfa3d_tpu_torch.models.yolov8 import decode_predictions, select_detections

    _check_device(model, device)

    def eval_fn(images_u8, params: Optional[Dict[str, torch.Tensor]] = None):
        dev = next(model.parameters()).device
        model.eval()
        with torch.no_grad():
            imgs = to_unit_float(torch.as_tensor(images_u8, device=dev))
            boxes, scores = decode_predictions(_levels_nhwc(model, imgs.to(next(model.parameters()).dtype),
                                                            params))
            return select_detections(boxes, scores, conf_thresh=conf_thresh, iou_thresh=iou_thresh,
                                     max_det=max_det, pre_nms=pre_nms)

    return eval_fn
