"""CenterNet-style deconv detector in PyTorch (the reference's `resnet_*`
arch), the port of `sfa3d_tpu/models/centernet_deconv.py`.

ResNet backbone -> three stride-2 ConvTranspose2d (256 channels, kernel 4,
padding 1, no bias), each followed by BatchNorm and ReLU -> one conv tower
per head at the single 1/4 scale.

The module keeps the reference PoseResNet's parameter names (`conv1`,
`layer1.0.conv1`, `deconv_layers.0` / `.1` / `.3` / ..., `hm_cen.0`,
`hm_cen.2`, ...), so a reference `Model_resnet_18_epoch_*.pth` loads with
strict=True. flax's ConvTranspose(kernel 4, stride 2, padding "SAME",
transpose_kernel=True) pads the stride-dilated input by (2, 2) and
correlates with the flipped kernel, which is what torch's
ConvTranspose2d(4, stride=2, padding=1) does: the two are the same
function at any input size (tests/test_torch_deconv.py holds them equal on
odd and even rasters). Inside a `spatial.py::row_sharded` context each
transposed convolution computes its rank's output rows (`RowConvTranspose2d`).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from sfa3d_tpu_torch.models.kfpn import HEADS, HM_BIAS, HeadTower, _lecun_normal_
from sfa3d_tpu_torch.models.resnet import FlaxBatchNorm2d, ResNetBackbone, stage_channels
from sfa3d_tpu_torch.spatial import RowConvTranspose2d

DECONV_CHANNELS = 256
DECONV_STD = 0.001  # the JAX package's N(0, 0.001) init of the deconv kernels


class DeconvCenterNet(ResNetBackbone):
    """`forward` takes a (B, 3, H, W) BEV batch and returns a dict of five
    pre-sigmoid head tensors (B, C_head, H/4, W/4)."""

    def __init__(self, num_layers: int = 18, head_conv: int = 64,
                 heads: Optional[Dict[str, int]] = None):
        super().__init__(num_layers)
        self.heads = dict(HEADS if heads is None else heads)
        self.head_conv = head_conv
        layers, cin = [], stage_channels(num_layers)[-1]
        for _ in range(3):
            layers += [RowConvTranspose2d(cin, DECONV_CHANNELS, 4, stride=2, padding=1, bias=False),
                       FlaxBatchNorm2d(DECONV_CHANNELS), nn.ReLU(inplace=True)]
            cin = DECONV_CHANNELS
        self.deconv_layers = nn.Sequential(*layers)
        for head, out_ch in self.heads.items():
            setattr(self, head, HeadTower(DECONV_CHANNELS, head_conv, out_ch))

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None) -> "DeconvCenterNet":
        """The JAX package's init, drawn from `generator`: lecun-normal conv
        kernels and zero biases, N(0, 0.001) deconv kernels, BatchNorm at
        identity; heatmap towers end in bias -2.19, the other towers' final
        1x1 conv in N(0, 0.001) weights."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                _lecun_normal_(m.weight, generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.ConvTranspose2d):
                m.weight.normal_(0.0, DECONV_STD, generator=generator)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
        for head in self.heads:
            final = getattr(self, head)[2]
            if "hm" in head:
                final.bias.fill_(HM_BIAS)
            else:
                final.weight.normal_(0.0, 0.001, generator=generator)
        return self

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.deconv_layers(self.backbone_features(x)[-1])
        return {head: getattr(self, head)(x) for head in self.heads}
