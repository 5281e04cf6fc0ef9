"""The training and eval steps: the port of
`sfa3d_tpu/parallel/train_step.py`, on one device or data-parallel over
the ranks of a `parallel/mesh.py` mesh.

One step takes a batch of S micro-batches ("subdivisions"), each of B
frames, and makes one optimizer update:
- each micro-batch runs forward and `backward()`, so the gradients SUM over
  the micro-batches (the JAX step's `lax.scan` adds them; there is no mean);
- BatchNorm runs in training mode and its running statistics thread from
  one micro-batch to the next, as the JAX scan carries `batch_stats`;
- the logged loss terms are the mean over the micro-batches;
- the learning rate (and a scheduled momentum) is set from the schedule at
  the step count before the update, as optax evaluates it;
- with ema_decay > 0 the parameter EMA advances after the update with
  d = ema_decay_at(step + 1) in float32, as e + (1 - d) * (p - e).

With a mesh of more than one rank (`mesh=`), each rank takes its B / world
frames of every micro-batch and the step is JAX's data-sharded step:
- forward and loss run inside `collectives.py::data_parallel(mesh)`, so BatchNorm takes the
  global batch's statistics and the losses the global normalizers (each
  rank's loss is its share of the global loss);
- after the last micro-batch's backward the gradients, summed over the
  micro-batches, are summed over the ranks by one explicit all-reduce of
  flat buckets (`mesh.py::all_reduce_grads`): the update is JAX's global
  gradient, the same on every rank, and so are the parameters, the EMA
  (which advances on every rank) and the BatchNorm statistics;
- the loss terms are all-reduced once at the end, so every rank returns
  JAX's global numbers.
An explicit all-reduce and not `DistributedDataParallel`: DDP averages
(the sum would need a comm hook or a loss scaled by the world size), needs
`no_sync()` on all but the last micro-batch and `broadcast_buffers=False`
(rank 0's buffers would overwrite the synced running statistics), and its
bucket all-reduces fire during the backward among the BatchNorm's own
backward all-reduces; after the backward, the order of the collectives is
the same on every rank by construction. The cost is no overlap of the
gradient all-reduce with the backward. At world size 1 (or without a
mesh) no collective runs and the step is the one-device step.

`compute_dtype="bfloat16"` runs forward and backward under
`models/__init__.py::compute_autocast`, `torch.autocast(dtype=
torch.bfloat16)` with float32 parameters (the JAX default's bfloat16
activations), the context inference runs under too; "float32" is strict
float32 (and a float64 model stays float64).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from sfa3d_tpu_torch.collectives import all_reduce_sum, data_parallel
from sfa3d_tpu_torch.device import Device, resolve_device
from sfa3d_tpu_torch.losses import compute_loss
from sfa3d_tpu_torch.models import check_compute_dtype, compute_autocast
from sfa3d_tpu_torch.parallel.mesh import Mesh, all_reduce_grads
from sfa3d_tpu_torch.runtime.schedules import OptimizerSpec

STAT_KEYS = ("total_loss", "hm_cen_loss", "cen_offset_loss", "dim_loss", "direction_loss", "z_coor_loss")


@dataclasses.dataclass
class TrainState:
    """The model (its parameters and BatchNorm statistics), the optimizer
    and its schedules, the number of updates made, and the parameter EMA
    (None when EMA is off)."""

    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    tx: OptimizerSpec
    ema_params: Optional[Dict[str, torch.Tensor]] = None

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())


def create_train_state(model: nn.Module, tx: OptimizerSpec, ema: bool = False) -> TrainState:
    """A fresh state over `model`'s parameters. The EMA starts as a real
    copy of the trainable parameters (a frozen one, such as YOLOv8's fixed
    DFL kernel, has none)."""
    ema_params = ({k: p.detach().clone() for k, p in model.named_parameters() if p.requires_grad}
                  if ema else None)
    return TrainState(step=0, model=model, optimizer=tx.build(model.parameters()), tx=tx,
                      ema_params=ema_params)


def ema_decay_at(step: int, decay: float, tau: float = 2000.0) -> np.float32:
    """Ramped EMA decay d(t) = decay * (1 - exp(-t / tau)), in float32 as
    the JAX step computes it (XLA's division by tau is a multiplication by
    float32(1 / tau))."""
    inv_tau = np.float32(1.0) / np.float32(tau)
    return np.float32(decay) * (np.float32(1.0) - np.exp(-np.float32(step) * inv_tau))


def _heads_nhwc(model: nn.Module, bev_nchw: torch.Tensor) -> Dict[str, torch.Tensor]:
    return {k: v.permute(0, 2, 3, 1) for k, v in model(bev_nchw).items()}


def _check_device(model: nn.Module, device: Device, mesh: Optional[Mesh] = None) -> None:
    """The step runs on `device` (default cuda; raises without a GPU unless
    device="cpu"), or on the mesh's device, where the model must already
    lie."""
    if mesh is not None:
        if device is not None and resolve_device(device) != mesh.device:
            raise ValueError(f"device {device} is not the mesh's device {mesh.device}")
        device = mesh.device
    dev = resolve_device(device)
    have = next(model.parameters()).device
    if have.type != dev.type or (dev.index is not None and have != dev):
        raise ValueError(f"model lies on {have} but the step asks for {dev}")


def global_stats(stats: Dict[str, torch.Tensor], mesh: Optional[Mesh]) -> Dict[str, torch.Tensor]:
    """Per-rank loss shares -> their sum over the ranks (one all-reduce);
    the stats themselves without a mesh or at world size 1."""
    if mesh is None or not mesh.synced:
        return stats
    keys = list(stats)
    summed = all_reduce_sum(torch.stack([stats[k].detach() for k in keys]), mesh.process_group)
    return {k: summed[i] for i, k in enumerate(keys)}


def make_train_step(model: nn.Module, tx: OptimizerSpec, ema_decay: float = 0.0,
                    ema_tau: float = 2000.0, compute_dtype: str = "float32",
                    device: Device = None, mesh: Optional[Mesh] = None) -> Callable:
    """The train step: (state, batch) -> (state, stats), made in place on
    the state's model and optimizer, on `device` (default cuda; raises
    without a GPU unless device="cpu") or, with `mesh`, on the mesh's
    device, data-parallel over its ranks.

    batch: {"bev": (S, B, 3, H, W) raster, "targets": dict of (S, B, ...)
    `build_targets` tensors}, on the model's device; with a mesh, this
    rank's B frames of the global batch (`mesh.py::shard_batch(mesh, batch,
    axis=1)`, or a loader built with process_index / process_count).
    stats: the mean over the S micro-batches of each loss term (of the
    global batch), 0-dim tensors on the device."""
    _check_device(model, device, mesh)
    check_compute_dtype(compute_dtype)
    device_of = next(model.parameters()).device
    synced = mesh is not None and mesh.synced

    def step_fn(state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        m = state.model
        if m is not model:
            raise ValueError("the state was made over another model")
        m.train()
        bev, targets = batch["bev"], batch["targets"]
        n_micro = bev.shape[0]
        state.optimizer.zero_grad(set_to_none=True)
        totals = None
        for s in range(n_micro):
            with data_parallel(mesh):
                with compute_autocast(device_of, compute_dtype):
                    outputs = _heads_nhwc(m, bev[s])
                total, stats = compute_loss(outputs, {k: v[s] for k, v in targets.items()})
            total.backward()
            stats = {k: stats[k].detach() for k in STAT_KEYS}
            totals = stats if totals is None else {k: totals[k] + stats[k] for k in STAT_KEYS}
        if synced:
            all_reduce_grads(m.parameters(), mesh)
        state.tx.apply_schedule(state.optimizer, state.step)
        state.optimizer.step()
        if ema_decay > 0.0:
            if state.ema_params is None:
                raise ValueError("ema_decay > 0 requires create_train_state(..., ema=True)")
            one_minus_d = float(np.float32(1.0) - ema_decay_at(state.step + 1, ema_decay, ema_tau))
            with torch.no_grad():
                for k, e in state.ema_params.items():
                    p = m.get_parameter(k)
                    e.add_(one_minus_d * (p.detach().to(e.dtype) - e))
        state.step += 1
        return state, {k: v / n_micro for k, v in global_stats(totals, mesh).items()}

    return step_fn


def make_eval_step(model: nn.Module, device: Device = None, mesh: Optional[Mesh] = None) -> Callable:
    """Validation loss: BatchNorm on its running statistics, no gradients.
    batch: {"bev": (B, 3, H, W), "targets": dict of (B, ...)} -> stats. On
    `device`, as make_train_step; with a mesh, the batch is this rank's
    slice and the stats are the global batch's (global normalizers, the
    shares summed over the ranks)."""
    _check_device(model, device, mesh)

    def step_fn(state: TrainState, batch) -> Dict[str, torch.Tensor]:
        if state.model is not model:
            raise ValueError("the state was made over another model")
        model.eval()
        with torch.no_grad(), data_parallel(mesh):
            _, stats = compute_loss(_heads_nhwc(model, batch["bev"]), batch["targets"])
        return global_stats(stats, mesh)

    return step_fn
