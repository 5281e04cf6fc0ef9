"""Learning-rate / momentum schedules and the optimizer factory, the port
of `sfa3d_tpu/runtime/schedules.py` (optax there, `torch.optim` here).

- 'multi_step': factors 1 / 0.1 / 0.01 at the configured epoch steps.
- 'cosin':      lr * (((1 + cos(pi * e / N)) / 2) * 0.9 + 0.1).
- 'one_cycle':  lr / 10 -> lr -> lr / 10 -> lr / 100 over the epochs, with
  the inverse momentum cycle over [0.85, 0.95] (SGD), phase ratio 0.45.

Every schedule maps the optimizer's step count (the number of updates
already made, 0 for the first) to a value through the epoch index
min(step // steps_per_epoch, N - 1), as optax evaluates a schedule at its
count before the update. The port computes them in Python floats (float64);
the JAX schedules compute in float32 outside x64 mode, so the two agree
within one float32 rounding (relative 6e-8) there and to float64 rounding
in x64 mode.

Optimizers: SGD with Nesterov momentum (`torch.optim.SGD(nesterov=True)`,
optax.sgd(nesterov=True): the same trace g + m * t and update g + m * t'),
or Adam with weight decay as L2 added to the gradient (torch
`Adam(weight_decay=...)`, not AdamW: optax.chain(add_decayed_weights,
adam)). SGD takes no weight decay, as in the JAX package. The learning rate
(and the momentum for one_cycle) is set from the schedule at the current
step before every `optimizer.step()`: `OptimizerSpec.apply_schedule`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from sfa3d_tpu_torch.config.train import OptimConfig


def _epoch_of(step: int, num_epochs: int, steps_per_epoch: int) -> int:
    return min(int(step) // max(1, steps_per_epoch), num_epochs - 1)


def create_lr_schedule(cfg: OptimConfig, num_epochs: int, steps_per_epoch: int) -> Callable[[int], float]:
    """Step count -> learning rate."""
    phase_epochs = int(0.45 * num_epochs)

    if cfg.lr_type == "multi_step":
        s0, s1 = (tuple(cfg.steps) + (num_epochs, num_epochs))[:2]

        def sched(step):
            e = _epoch_of(step, num_epochs, steps_per_epoch)
            return cfg.lr * (1.0 if e < s0 else 0.1 if e < s1 else 0.01)

    elif cfg.lr_type == "cosin":

        def sched(step):
            e = _epoch_of(step, num_epochs, steps_per_epoch)
            return cfg.lr * (((1.0 + math.cos(e * math.pi / num_epochs)) / 2.0) * 0.9 + 0.1)

    elif cfg.lr_type == "one_cycle":

        def sched(step):
            e = float(_epoch_of(step, num_epochs, steps_per_epoch))
            if e < phase_epochs:
                return cfg.lr * 0.1 + (cfg.lr - cfg.lr * 0.1) * e / max(1, phase_epochs - 1)
            if e < 2 * phase_epochs:
                return cfg.lr - (cfg.lr - cfg.lr * 0.1) * (e - phase_epochs) / max(1, phase_epochs - 1)
            tail_len = max(1, num_epochs - 2 * phase_epochs - 1)
            return cfg.lr * 0.1 + (cfg.lr * 0.01 - cfg.lr * 0.1) * (e - 2 * phase_epochs) / tail_len

    else:
        raise ValueError(f"unknown lr_type: {cfg.lr_type}")
    return sched


def create_momentum_schedule(cfg: OptimConfig, num_epochs: int,
                             steps_per_epoch: int) -> Optional[Callable[[int], float]]:
    """The inverse momentum cycle of one_cycle; None for the other schedules
    (constant momentum)."""
    if cfg.lr_type != "one_cycle":
        return None
    phase_epochs = int(0.45 * num_epochs)
    m_lo, m_hi = 0.85, 0.95

    def sched(step):
        e = float(_epoch_of(step, num_epochs, steps_per_epoch))
        if e < phase_epochs:
            return m_hi + (m_lo - m_hi) * e / max(1, phase_epochs - 1)
        if e < 2 * phase_epochs:
            return m_lo + (m_hi - m_lo) * (e - phase_epochs) / max(1, phase_epochs - 1)
        return m_hi

    return sched


def range_finder_schedule(num_epochs: int, lr_min: float = 1e-7, lr_max: float = 1.0,
                          steps_per_epoch: int = 1) -> Callable[[int], float]:
    """Log-space learning-rate sweep for range tests: epoch e gets
    10 ** lerp(log10 lr_min, log10 lr_max)."""
    lrs = np.logspace(math.log10(lr_min), math.log10(lr_max), num_epochs)

    def sched(step):
        return float(lrs[min(max(int(step) // max(1, steps_per_epoch), 0), num_epochs - 1)])

    return sched


@dataclasses.dataclass
class OptimizerSpec:
    """What `create_optimizer` gives: the optimizer kind, its schedules and
    constants. `build` makes the torch.optim optimizer over parameters;
    `apply_schedule` sets its learning rate (and scheduled momentum) for
    the update at `step`."""

    kind: str  # "sgd" | "adam"
    lr: Callable[[int], float]
    momentum_schedule: Optional[Callable[[int], float]] = None
    momentum: float = 0.949
    weight_decay: float = 0.0

    def build(self, params: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
        if self.kind == "sgd":
            m = self.momentum_schedule(0) if self.momentum_schedule else self.momentum
            return torch.optim.SGD(params, lr=self.lr(0), momentum=m, nesterov=True)
        return torch.optim.Adam(params, lr=self.lr(0), betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=self.weight_decay)

    def apply_schedule(self, optimizer: torch.optim.Optimizer, step: int) -> float:
        lr = self.lr(step)
        for group in optimizer.param_groups:
            group["lr"] = lr
            if self.momentum_schedule is not None:
                group["momentum"] = self.momentum_schedule(step)
        return lr


def create_optimizer(cfg: OptimConfig, num_epochs: int, steps_per_epoch: int) -> OptimizerSpec:
    """Optimizer + schedules of a training run."""
    lr = create_lr_schedule(cfg, num_epochs, steps_per_epoch)
    if cfg.optimizer_type == "sgd":
        return OptimizerSpec("sgd", lr, create_momentum_schedule(cfg, num_epochs, steps_per_epoch),
                             momentum=cfg.momentum)
    if cfg.optimizer_type == "adam":
        return OptimizerSpec("adam", lr, weight_decay=cfg.weight_decay)
    raise ValueError(f"unknown optimizer type: {cfg.optimizer_type}")
