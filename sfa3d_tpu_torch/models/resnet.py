"""ResNet backbone blocks in PyTorch (NCHW), the port of
`sfa3d_tpu/models/resnet.py`.

Parameter names are the reference PoseResNet's (`conv1`, `bn1`,
`layer1.0.conv1`, `layer2.0.downsample.0`, ...), so a reference
`Model_fpn_resnet_*.pth` state_dict loads with strict=True. BatchNorm uses
eps 1e-5 and torch momentum 0.1 (flax momentum 0.9); in eval mode it uses
the running statistics.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

BN_EPS = 1e-5
BN_MOMENTUM = 0.1  # torch convention == flax momentum 0.9


def _bn(channels: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(channels, eps=BN_EPS, momentum=BN_MOMENTUM)


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
