"""Models of the port: KFPN and the deconv CenterNet on a ResNet backbone,
and the clamped sigmoid. `create_model` takes the reference's arch strings
('fpn_resnet_18', 'resnet_18')."""

from __future__ import annotations

import torch


def create_model(arch: str = "fpn_resnet_18", head_conv: int = 64):
    """Arch string -> module (CPU, float32, not yet initialised: see
    `sfa3d_tpu_torch.pipeline.init_detector`): `fpn_resnet_*` is KFPN,
    `resnet_*` the deconv CenterNet (the reference's dispatch)."""
    from sfa3d_tpu_torch.models.centernet_deconv import DeconvCenterNet
    from sfa3d_tpu_torch.models.kfpn import KFPN

    family, _, depth = arch.rpartition("_")
    models = {"fpn_resnet": KFPN, "resnet": DeconvCenterNet}
    if family not in models or not depth.isdigit():
        raise ValueError(f"unknown arch: {arch!r} (sfa3d_tpu_torch has fpn_resnet_* and resnet_*)")
    return models[family](num_layers=int(depth), head_conv=head_conv)


def clamped_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """sigmoid clamped to [1e-4, 1 - 1e-4], computed in at least float32.

    The clamp is straight-through: the forward value is the clamped one,
    but the backward keeps the plain sigmoid gradient, so a heatmap logit
    pushed below the clamp can still recover in training (the JAX package's
    `clamped_sigmoid` does the same)."""
    dt = torch.promote_types(x.dtype, torch.float32)
    p = torch.sigmoid(x.to(dt))
    return p + (p.clamp(1e-4, 1.0 - 1e-4) - p).detach()
