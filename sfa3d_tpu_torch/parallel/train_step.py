"""The training and eval steps on one device: the port of
`sfa3d_tpu/parallel/train_step.py` (data parallelism is not ported yet).

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

`compute_dtype="bfloat16"` runs forward and backward under
`torch.autocast(dtype=torch.bfloat16)` with float32 parameters (the JAX
default's bfloat16 activations); "float32" is strict float32 (and a
float64 model stays float64).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from sfa3d_tpu_torch.device import Device, resolve_device
from sfa3d_tpu_torch.losses import compute_loss
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
    copy of the parameters."""
    ema_params = ({k: p.detach().clone() for k, p in model.named_parameters()} if ema else None)
    return TrainState(step=0, model=model, optimizer=tx.build(model.parameters()), tx=tx,
                      ema_params=ema_params)


def ema_decay_at(step: int, decay: float, tau: float = 2000.0) -> np.float32:
    """Ramped EMA decay d(t) = decay * (1 - exp(-t / tau)), in float32 as
    the JAX step computes it (XLA's division by tau is a multiplication by
    float32(1 / tau))."""
    inv_tau = np.float32(1.0) / np.float32(tau)
    return np.float32(decay) * (np.float32(1.0) - np.exp(-np.float32(step) * inv_tau))


def _autocast(model: nn.Module, compute_dtype: str):
    if compute_dtype == "float32":
        return contextlib.nullcontext()
    if compute_dtype == "bfloat16":
        dev = next(model.parameters()).device
        return torch.autocast(device_type=dev.type, dtype=torch.bfloat16)
    raise ValueError(f"unknown compute_dtype {compute_dtype!r}; expected 'bfloat16' or 'float32'")


def _heads_nhwc(model: nn.Module, bev_nchw: torch.Tensor) -> Dict[str, torch.Tensor]:
    return {k: v.permute(0, 2, 3, 1) for k, v in model(bev_nchw).items()}


def _check_device(model: nn.Module, device: Device) -> None:
    """The step runs on `device` (default cuda; raises without a GPU unless
    device="cpu"), where the model must already lie."""
    dev = resolve_device(device)
    have = next(model.parameters()).device
    if have.type != dev.type or (dev.index is not None and have != dev):
        raise ValueError(f"model lies on {have} but the step asks for {dev}")


def make_train_step(model: nn.Module, tx: OptimizerSpec, ema_decay: float = 0.0,
                    ema_tau: float = 2000.0, compute_dtype: str = "float32",
                    device: Device = None) -> Callable:
    """The train step: (state, batch) -> (state, stats), made in place on
    the state's model and optimizer, on `device` (default cuda; raises
    without a GPU unless device="cpu").

    batch: {"bev": (S, B, 3, H, W) raster, "targets": dict of (S, B, ...)
    `build_targets` tensors}, on the model's device. stats: the mean over
    the S micro-batches of each loss term, 0-dim tensors on the device."""
    _check_device(model, device)

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
            with _autocast(m, compute_dtype):
                outputs = _heads_nhwc(m, bev[s])
            total, stats = compute_loss(outputs, {k: v[s] for k, v in targets.items()})
            total.backward()
            stats = {k: stats[k].detach() for k in STAT_KEYS}
            totals = stats if totals is None else {k: totals[k] + stats[k] for k in STAT_KEYS}
        state.tx.apply_schedule(state.optimizer, state.step)
        state.optimizer.step()
        if ema_decay > 0.0:
            if state.ema_params is None:
                raise ValueError("ema_decay > 0 requires create_train_state(..., ema=True)")
            one_minus_d = float(np.float32(1.0) - ema_decay_at(state.step + 1, ema_decay, ema_tau))
            with torch.no_grad():
                for k, p in m.named_parameters():
                    e = state.ema_params[k]
                    e.add_(one_minus_d * (p.detach().to(e.dtype) - e))
        state.step += 1
        return state, {k: v / n_micro for k, v in totals.items()}

    return step_fn


def make_eval_step(model: nn.Module, device: Device = None) -> Callable:
    """Validation loss: BatchNorm on its running statistics, no gradients.
    batch: {"bev": (B, 3, H, W), "targets": dict of (B, ...)} -> stats. On
    `device`, as make_train_step."""
    _check_device(model, device)

    def step_fn(state: TrainState, batch) -> Dict[str, torch.Tensor]:
        if state.model is not model:
            raise ValueError("the state was made over another model")
        model.eval()
        with torch.no_grad():
            _, stats = compute_loss(_heads_nhwc(model, batch["bev"]), batch["targets"])
        return stats

    return step_fn
