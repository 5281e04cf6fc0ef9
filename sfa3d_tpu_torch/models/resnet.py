"""ResNet backbone blocks in PyTorch (NCHW), the port of
`sfa3d_tpu/models/resnet.py`.

Parameter names are the reference PoseResNet's (`conv1`, `bn1`,
`layer1.0.conv1`, `layer2.0.downsample.0`, ...), so a reference
`Model_fpn_resnet_*.pth` state_dict loads with strict=True. BatchNorm uses
eps 1e-5; in eval mode it uses the running statistics, in training mode the
batch's, and it updates the running statistics as flax does
(`FlaxBatchNorm2d`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from sfa3d_tpu_torch.collectives import active_group, all_reduce_sum

BN_EPS = 1e-5
FLAX_MOMENTUM = 0.9  # flax nn.BatchNorm(momentum=0.9): running = 0.9 * running + 0.1 * batch


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d whose training-mode update of the running statistics is
    flax's: running_var takes the BIASED batch variance (torch's own
    BatchNorm2d takes the unbiased one, n / (n - 1) larger: 8/7 for 2 x 2
    cells at batch 2, which layer4 sees on a 64x64 raster), as
    momentum * running + (1 - momentum) * batch with flax's momentum 0.9.

    F.batch_norm normalises with the batch statistics (cuDNN on the card)
    and updates the running statistics in the same pass, with torch's
    momentum 0.1 = 1 - flax's, into C-element copies: the mean is then
    flax's, and the variance is brought from the unbiased to the biased one
    with the old running_var. Under a data-parallel group
    (`collectives.py::data_parallel`) the statistics are the global
    batch's, taken in flax's order (`_global_forward`). Eval mode is
    nn.BatchNorm2d's. The state_dict keys
    (weight, bias, running_mean, running_var, num_batches_tracked) are
    nn.BatchNorm2d's. `eps` and `momentum` are flax's (YOLOv8: 1e-3, 0.97).
    Every mode normalises in at least float32 and returns that type, as
    flax's BatchNorm(dtype=promote(float32, dtype)) in the JAX package's
    bfloat16 models: a bfloat16 input (autocast training, a
    `to_inference_dtype` model) leaves as float32, a float64 one as
    float64."""

    def __init__(self, channels: int, eps: float = BN_EPS, momentum: float = FLAX_MOMENTUM):
        super().__init__(channels, eps=eps, momentum=1 - momentum)
        self.flax_momentum = momentum

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        if not self.training:
            return super().forward(x)
        group = active_group()
        if group is not None:
            return self._global_forward(x, group)
        n = x.numel() // x.shape[1]  # values per channel
        # copies, since autograd keeps what F.batch_norm was given
        mean, var = self.running_mean.clone(), self.running_var.clone()
        out = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1 - self.flax_momentum, self.eps)
        with torch.no_grad():
            # var now holds old + (1 - momentum) * batch_var * n / (n - 1)
            old = self.flax_momentum * self.running_var
            self.running_mean.copy_(mean)
            self.running_var.copy_(old + (var - old) * ((n - 1) / n))
            self.num_batches_tracked.add_(1)
        return out

    def _global_forward(self, x: torch.Tensor, group) -> torch.Tensor:
        """Training mode under a data-parallel group (`parallel/mesh.py`), in
        flax's order: the per-channel sum, sum of squares and count summed
        over the ranks in one differentiable all-reduce (the gradient flows
        through the global statistics, as through XLA's psum), mean and
        biased variance E[x^2] - E[x]^2 clipped at 0, y = (x - mean) *
        (rsqrt(var + eps) * weight) + bias, and the running statistics
        updated with flax's momentum and the biased variance. x is already
        at least float32 (`forward`)."""
        c = x.shape[1]
        count = torch.full((1,), x.numel() // c, dtype=x.dtype, device=x.device)
        sums = all_reduce_sum(torch.cat([x.sum((0, 2, 3)), (x * x).sum((0, 2, 3)), count]), group)
        mean = sums[:c] / sums[2 * c]
        var = torch.clamp_min(sums[c:2 * c] / sums[2 * c] - mean * mean, 0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.to(x.dtype)
        y = (x - mean[None, :, None, None]) * mul[None, :, None, None] + self.bias.to(x.dtype)[None, :, None, None]
        with torch.no_grad():
            m = self.flax_momentum
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean.detach())
            self.running_var.copy_(m * self.running_var + (1 - m) * var.detach())
            self.num_batches_tracked.add_(1)
        return y


def _bn(channels: int) -> FlaxBatchNorm2d:
    return FlaxBatchNorm2d(channels)


def _conv(cin: int, cout: int, kernel: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel, stride=stride, padding=kernel // 2, bias=False)


class ConvBN(nn.Sequential):
    """Bias-free conv + BatchNorm; its children are named `0` and `1`, the
    layout of the reference `downsample` branch."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1):
        super().__init__(_conv(cin, cout, kernel, stride), _bn(cout))


class BasicBlock(nn.Module):
    """Two 3x3 convs + identity/projection shortcut."""

    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: Optional[nn.Module] = None):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 3, stride)
        self.bn1 = _bn(planes)
        self.relu = nn.ReLU(inplace=True)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = _bn(planes)
        self.downsample = downsample

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return self.relu(out + residual)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: Optional[nn.Module] = None):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 1)
        self.bn1 = _bn(planes)
        self.conv2 = _conv(planes, planes, 3, stride)
        self.bn2 = _bn(planes)
        self.conv3 = _conv(planes, planes * self.expansion, 1)
        self.bn3 = _bn(planes * self.expansion)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = downsample

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return self.relu(out + residual)


# arch spec: (block class, per-stage block counts)
RESNET_SPEC = {
    18: (BasicBlock, (2, 2, 2, 2)),
    34: (BasicBlock, (3, 4, 6, 3)),
    50: (Bottleneck, (3, 4, 6, 3)),
    101: (Bottleneck, (3, 4, 23, 3)),
    152: (Bottleneck, (3, 8, 36, 3)),
}


def stage_channels(num_layers: int) -> Tuple[int, int, int, int]:
    block_cls, _ = RESNET_SPEC[num_layers]
    return tuple(c * block_cls.expansion for c in (64, 128, 256, 512))


class ResNetBackbone(nn.Module):
    """7x7 stem + layer1..layer4; `forward` returns the four stage outputs
    (strides 4/8/16/32). NCHW input (B, 3, H, W)."""

    def __init__(self, num_layers: int = 18):
        super().__init__()
        if num_layers not in RESNET_SPEC:
            raise ValueError(f"unsupported ResNet depth {num_layers}; have {sorted(RESNET_SPEC)}")
        block_cls, counts = RESNET_SPEC[num_layers]
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = _bn(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        inplanes = 64
        for stage, (planes, blocks) in enumerate(zip((64, 128, 256, 512), counts)):
            stride = 1 if stage == 0 else 2
            layers = []
            for i in range(blocks):
                s = stride if i == 0 else 1
                out_planes = planes * block_cls.expansion
                ds = ConvBN(inplanes, out_planes, 1, s) if (s != 1 or inplanes != out_planes) else None
                layers.append(block_cls(inplanes, planes, s, ds))
                inplanes = out_planes
            setattr(self, f"layer{stage + 1}", nn.Sequential(*layers))

    def backbone_features(self, x: torch.Tensor):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        out1 = self.layer1(x)
        out2 = self.layer2(out1)
        out3 = self.layer3(out2)
        out4 = self.layer4(out3)
        return out1, out2, out3, out4

    def forward(self, x: torch.Tensor):
        return self.backbone_features(x)
