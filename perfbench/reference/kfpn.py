"""Plain PyTorch KFPN (SFA3D's `fpn_resnet`), the reference of the served
network. It follows SFA3D's `models/fpn_resnet.py` (maudzung/SFA3D): a
ResNet backbone, a top-down pyramid of 1x1 lateral convolutions after a 2x
bilinear upsample (align_corners=True), per level and head a 3x3 + ReLU +
1x1 tower, the coarse level upsampled 2x (nearest), and a softmax over the
three levels that weights their sum. Eval mode: BatchNorm uses its running
statistics.

Its parameter names are SFA3D's (`conv1`, `layer1.0.conv1`,
`conv_up_level1`, `fpn0_hm_cen.0`, ...), so one state dict loads into it and
into the program under test. It imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

HEADS = {"hm_cen": 3, "cen_offset": 2, "direction": 2, "z_coor": 1, "dim": 3}
BLOCKS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3)}


class Block(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(nn.Conv2d(cin, cout, 1, stride, 0, bias=False), nn.BatchNorm2d(cout))

    def forward(self, x):
        skip = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(y)) + skip)


class KFPN(nn.Module):
    def __init__(self, num_layers: int = 18, head_conv: int = 64):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        cin = 64
        for i, (planes, n) in enumerate(zip((64, 128, 256, 512), BLOCKS[num_layers])):
            blocks = []
            for j in range(n):
                blocks.append(Block(cin, planes, 2 if (i > 0 and j == 0) else 1))
                cin = planes
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
        self.conv_up_level1 = nn.Conv2d(512 + 256, 256, 1)
        self.conv_up_level2 = nn.Conv2d(256 + 128, 128, 1)
        self.conv_up_level3 = nn.Conv2d(128 + 64, 64, 1)
        for i, c in enumerate((256, 128, 64)):
            for head, out in HEADS.items():
                setattr(self, f"fpn{i}_{head}", nn.Sequential(
                    nn.Conv2d(c, head_conv, 3, 1, 1), nn.ReLU(), nn.Conv2d(head_conv, out, 1)))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        out1 = self.layer1(x)
        out2 = self.layer2(out1)
        out3 = self.layer3(out2)
        out4 = self.layer4(out3)

        def up(t):
            return F.interpolate(t, scale_factor=2, mode="bilinear", align_corners=True)

        up2 = up(self.conv_up_level1(torch.cat([up(out4), out3], 1)))
        up3 = up(self.conv_up_level2(torch.cat([up2, out2], 1)))
        up4 = self.conv_up_level3(torch.cat([up3, out1], 1))
        heads = {}
        for head in HEADS:
            levels = []
            for i, feat in enumerate((up2, up3, up4)):
                o = getattr(self, f"fpn{i}_{head}")(feat)
                if o.shape[-2:] != up4.shape[-2:]:
                    o = F.interpolate(o, scale_factor=2, mode="nearest")
                levels.append(o)
            stacked = torch.stack(levels, -1)
            heads[head] = (stacked * torch.softmax(stacked, -1)).sum(-1)
        return heads
