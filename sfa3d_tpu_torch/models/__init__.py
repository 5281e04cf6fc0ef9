"""Models of the port: KFPN on a ResNet backbone, and the clamped sigmoid.
`create_model` takes the reference's arch strings ('fpn_resnet_18')."""

from __future__ import annotations

import torch


def create_model(arch: str = "fpn_resnet_18", head_conv: int = 64):
    """Arch string -> KFPN module (CPU, float32, not yet initialised: see
    `sfa3d_tpu_torch.pipeline.init_detector`). Only the `fpn_resnet_*` archs
    are ported so far."""
    from sfa3d_tpu_torch.models.kfpn import KFPN

    if not arch.startswith("fpn_resnet_"):
        raise ValueError(
            f"unknown or unported arch: {arch!r} (sfa3d_tpu_torch has fpn_resnet_*)"
        )
    return KFPN(num_layers=int(arch.split("_")[-1]), head_conv=head_conv)


def clamped_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """sigmoid clamped to [1e-4, 1 - 1e-4], computed in at least float32.

    The clamp is straight-through: the forward value is the clamped one,
    but the backward keeps the plain sigmoid gradient, so a heatmap logit
    pushed below the clamp can still recover in training (the JAX package's
    `clamped_sigmoid` does the same)."""
    dt = torch.promote_types(x.dtype, torch.float32)
    p = torch.sigmoid(x.to(dt))
    return p + (p.clamp(1e-4, 1.0 - 1e-4) - p).detach()
