"""Models of the port: KFPN and the deconv CenterNet on a ResNet backbone,
the clamped sigmoid, and the compute dtypes: `compute_autocast` for a
training step, `to_inference_dtype` for a served network.
`create_model` takes the reference's arch strings ('fpn_resnet_18',
'resnet_18')."""

from __future__ import annotations

import contextlib

import torch
from torch import nn

COMPUTE_DTYPES = ("float32", "bfloat16")


def create_model(arch: str = "fpn_resnet_18", head_conv: int = 64):
    """Arch string -> module (CPU, float32, not yet initialised: see
    `sfa3d_tpu_torch.pipeline.init_detector`): `fpn_resnet_*` is KFPN,
    `resnet_*` the deconv CenterNet (the reference's dispatch). The JAX
    package's `s2d_stem` / `fused_heads` KFPNs compute the same function as
    the standard one; their variables load into it
    (`models/port.py::state_dict_from_jax`)."""
    from sfa3d_tpu_torch.models.centernet_deconv import DeconvCenterNet
    from sfa3d_tpu_torch.models.kfpn import KFPN

    family, _, depth = arch.rpartition("_")
    if family not in ("fpn_resnet", "resnet") or not depth.isdigit():
        raise ValueError(f"unknown arch: {arch!r} (sfa3d_tpu_torch has fpn_resnet_* and resnet_*)")
    if family == "resnet":
        return DeconvCenterNet(num_layers=int(depth), head_conv=head_conv)
    return KFPN(num_layers=int(depth), head_conv=head_conv)


def get_num_parameters(model: torch.nn.Module) -> int:
    """Total parameter count of a model: its parameters, not its BatchNorm
    statistics (the JAX package counts the `params` tree)."""
    return sum(p.numel() for p in model.parameters())


def check_compute_dtype(compute_dtype: str) -> str:
    """`compute_dtype` if it is one of COMPUTE_DTYPES; raises ValueError
    otherwise."""
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"unknown compute dtype {compute_dtype!r}; expected one of {COMPUTE_DTYPES}")
    return compute_dtype


def compute_autocast(device: torch.device, compute_dtype: str):
    """The context a training step's forward runs in for `compute_dtype`:
    "float32" is the network's own type (strict float32, or float64 for a
    float64 model); "bfloat16" is `torch.autocast(dtype=torch.bfloat16)`
    with the parameters kept float32, the counterpart of the JAX package's
    `dtype=jnp.bfloat16` modules. Any other name raises ValueError.
    Inference takes `to_inference_dtype` instead."""
    if check_compute_dtype(compute_dtype) == "float32":
        return contextlib.nullcontext()
    return torch.autocast(device_type=torch.device(device).type, dtype=torch.bfloat16)


def _input_to_weight_dtype(module: nn.Module, args):
    return (args[0].to(module.weight.dtype), *args[1:])


def to_inference_dtype(model: nn.Module, compute_dtype: str) -> nn.Module:
    """An eval-mode network set up, in place, to compute in `compute_dtype`
    as the JAX package's `dtype=` modules do -> the model. "float32" leaves
    it as it is. "bfloat16" casts the weights and biases of every
    convolution (and transposed convolution) to bfloat16 once, here, and
    has each cast its input to bfloat16, so it returns bfloat16, as a flax
    `Conv(dtype=jnp.bfloat16)`. BatchNorm keeps float32 parameters and
    returns float32 (`FlaxBatchNorm2d`), so the residual stream is float32
    as in JAX; the level softmax (`kfpn.py::apply_kfpn`), `clamped_sigmoid`
    and YOLOv8's DFL decode run in float32 by their own promotion. Any
    other name raises ValueError."""
    if check_compute_dtype(compute_dtype) == "float32":
        return model
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)) and m.weight.dtype != torch.bfloat16:
            m.to(torch.bfloat16)
            m.register_forward_pre_hook(_input_to_weight_dtype)
    return model


def clamped_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """sigmoid clamped to [1e-4, 1 - 1e-4], computed in at least float32.

    The clamp is straight-through: the forward value is the clamped one,
    but the backward keeps the plain sigmoid gradient, so a heatmap logit
    pushed below the clamp can still recover in training (the JAX package's
    `clamped_sigmoid` does the same)."""
    dt = torch.promote_types(x.dtype, torch.float32)
    p = torch.sigmoid(x.to(dt))
    return p + (p.clamp(1e-4, 1.0 - 1e-4) - p).detach()
