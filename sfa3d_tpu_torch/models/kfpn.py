"""Keypoint Feature Pyramid Network (KFPN) in PyTorch, the port of
`sfa3d_tpu/models/kfpn.py`.

ResNet backbone -> top-down pyramid with 1x1 lateral convs and 2x bilinear
(align_corners=True) upsampling -> per-(level, head) conv towers -> softmax
over the three pyramid levels.

The module runs NCHW, like the reference PoseResNet, and keeps its
parameter names (`conv1`, `bn1`, `layer1.0.conv1`, `conv_up_level1`,
`fpn0_hm_cen.0`, `fpn0_hm_cen.2`, ...), so a reference
`Model_fpn_resnet_18_epoch_*.pth` loads with strict=True.
`sfa3d_tpu_torch.pipeline.forward_heads` is the NHWC entry that matches the
JAX `model.apply`. Inside a `spatial.py::row_sharded` context every layer
computes its rank's rows of its output (the lateral 1x1 convs, the
concatenations and the level softmax are row-local).
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from sfa3d_tpu_torch.device import device_constant
from sfa3d_tpu_torch.models.resnet import ResNetBackbone, stage_channels
from sfa3d_tpu_torch.spatial import RowConv2d, active_rows, rows_of_product, upsample_nearest_rows

HEADS: Dict[str, int] = {
    "hm_cen": 3,
    "cen_offset": 2,
    "direction": 2,
    "z_coor": 1,
    "dim": 3,
}

HM_BIAS = -2.19  # focal-loss prior on the heatmap head's final bias


@functools.lru_cache(maxsize=None)
def _align_corners_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) bilinear interpolation weights with align_corners=True,
    output i sampling input i * (n_in - 1) / (n_out - 1). Float32, as the
    JAX package builds them (so a float64 model uses the same rounded
    weights as the JAX one)."""
    A = np.zeros((n_out, n_in), dtype=np.float32)
    if n_out == 1 or n_in == 1:
        A[:, 0] = 1.0
        return A
    scale = (n_in - 1) / (n_out - 1)
    for i in range(n_out):
        src = i * scale
        lo = int(np.floor(src))
        hi = min(lo + 1, n_in - 1)
        frac = src - lo
        A[i, lo] += 1.0 - frac
        A[i, hi] += frac
    return A


@device_constant
def _interp_matrix(n_in: int, n_out: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    # one copy per device and dtype: a host-to-device copy of pageable
    # memory synchronizes the stream, which on every forward would stall
    # the host's launches behind the device's work. Made outside inference
    # mode, so that a copy first made while serving can enter a backward.
    with torch.inference_mode(False):
        return torch.from_numpy(_align_corners_matrix(n_in, n_out)).to(device, dtype)


def upsample2x_align_corners(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, 2H, 2W), bilinear with align_corners=True, as
    two products with the interpolation matrices (the JAX package's form).
    The products run in x's type, under autocast too, as JAX builds the
    matrices in x.dtype: float32 for the backbone's last stage, bfloat16
    for a bfloat16 lateral conv's output.

    Inside a `spatial.py::row_sharded` context x is this rank's rows of the
    map and so is the result: output rows [lo, hi) are rows [lo, hi) of
    the row matrix times the input rows those matrix rows touch, fetched
    from their owners (the split of 2H rows does not line up with that of
    H: 19 rows over 2 ranks are 10 + 9, 38 rows 19 + 19)."""
    sh = active_rows()
    h, w = x.shape[-2:]
    aw = _interp_matrix(w, 2 * w, x.device, x.dtype)
    if sh is None:
        ah = _interp_matrix(h, 2 * h, x.device, x.dtype)
    else:
        h = sh.height(x)
        x, (lo, hi), (a, b) = rows_of_product(x, _align_corners_matrix(h, 2 * h), sh, 2 * w)
        ah = _interp_matrix(h, 2 * h, x.device, x.dtype)[lo:hi, a:b]
    with torch.autocast(x.device.type, enabled=False):
        return torch.matmul(torch.matmul(ah, x), aw.transpose(0, 1))


def _repeat2x(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, 2H, 2W), exact 2x nearest (a repeat); this
    rank's rows of it inside a `row_sharded` context."""
    sh = active_rows()
    return _repeat2x(x) if sh is None else upsample_nearest_rows(x, sh, _repeat2x)


def apply_kfpn(outs: List[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Softmax over pyramid levels, then the weighted sum. Runs in at least
    float32. Any layout: the levels stack on a new last axis.
    Returns (fused, weights)."""
    dt = torch.promote_types(outs[0].dtype, torch.float32)
    stacked = torch.stack(outs, dim=-1).to(dt)
    weights = torch.softmax(stacked, dim=-1)
    fused = (stacked * weights).sum(dim=-1)
    return fused.to(outs[0].dtype), weights


class HeadTower(nn.Sequential):
    """Conv3x3(fpn_c -> head_conv) + ReLU + Conv1x1(head_conv -> out); the
    children `0` and `2` are the reference's parameter names."""

    def __init__(self, in_channels: int, head_conv: int, out_channels: int):
        super().__init__(
            RowConv2d(in_channels, head_conv, 3, padding=1, bias=True),
            nn.ReLU(inplace=True),
            RowConv2d(head_conv, out_channels, 1, bias=True),
        )


def _lecun_normal_(w: torch.Tensor, generator: Optional[torch.Generator]) -> None:
    """flax's default conv init: truncated normal, variance 1/fan_in."""
    fan_in = w.shape[1] * w.shape[2] * w.shape[3]
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


class KFPN(ResNetBackbone):
    """PoseResNet KFPN. `forward` takes a (B, 3, H, W) BEV batch and returns
    a dict of five pre-sigmoid head tensors (B, C_head, H/4, W/4)."""

    def __init__(self, num_layers: int = 18, head_conv: int = 64,
                 heads: Optional[Dict[str, int]] = None):
        super().__init__(num_layers)
        self.heads = dict(HEADS if heads is None else heads)
        self.head_conv = head_conv
        c1, c2, c3, c4 = stage_channels(num_layers)
        self.conv_up_level1 = RowConv2d(c4 + c3, 256, 1, bias=True)
        self.conv_up_level2 = RowConv2d(256 + c2, 128, 1, bias=True)
        self.conv_up_level3 = RowConv2d(128 + c1, 64, 1, bias=True)
        for idx, fpn_c in enumerate((256, 128, 64)):
            for head, out_ch in self.heads.items():
                setattr(self, f"fpn{idx}_{head}", HeadTower(fpn_c, head_conv, out_ch))

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None) -> "KFPN":
        """The JAX package's init, drawn from `generator`: lecun-normal conv
        kernels and zero biases; heatmap towers end in bias -2.19, the other
        towers' final 1x1 conv in N(0, 0.001) weights; BatchNorm at identity
        (scale 1, shift 0, running mean 0, running var 1)."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                _lecun_normal_(m.weight, generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
        for idx in range(3):
            for head in self.heads:
                final = getattr(self, f"fpn{idx}_{head}")[2]
                if "hm" in head:
                    final.bias.fill_(HM_BIAS)
                else:
                    final.weight.normal_(0.0, 0.001, generator=generator)
        return self

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self._heads(x, None)

    def forward_features(self, x: torch.Tensor):
        """The forward that also returns the introspection tensors of the
        JAX package's `KFPN.__call__(..., capture_features=True)`: (heads,
        viz) with viz = {"backbone": (out1, out2, out3, out4), "pyramid":
        (up2, up3, up4), "fpn_outputs": {head: [3 levels after the nearest
        upsample]}, "kfpn_weights": {head: softmax weights}}. The layout is
        the port's: each feature map (B, C, H, W) where JAX's is
        (B, H, W, C), and each weight tensor (B, C, H, W, L) where JAX's is
        (B, H, W, C, L) (the levels stay the last axis). `forward`, the
        program `torch.export` traces, is unchanged by it."""
        viz = {"fpn_outputs": {}, "kfpn_weights": {}}
        return self._heads(x, viz), viz

    def _heads(self, x: torch.Tensor, viz: Optional[dict]) -> Dict[str, torch.Tensor]:
        out1, out2, out3, out4 = self.backbone_features(x)
        up1 = upsample2x_align_corners(out4)
        up2 = upsample2x_align_corners(self.conv_up_level1(torch.cat([up1, out3], 1)))
        up3 = upsample2x_align_corners(self.conv_up_level2(torch.cat([up2, out2], 1)))
        up4 = self.conv_up_level3(torch.cat([up3, out1], 1))
        levels = (up2, up3, up4)  # 1/8, 1/4, 1/4 resolution
        if viz is not None:
            viz["backbone"], viz["pyramid"] = (out1, out2, out3, out4), levels

        ret = {}
        for head in self.heads:
            level_outs = []
            for idx, feat in enumerate(levels):
                o = getattr(self, f"fpn{idx}_{head}")(feat)
                if o.shape[-2:] != up4.shape[-2:]:
                    o = upsample2x_nearest(o)
                level_outs.append(o)
            ret[head], weights = apply_kfpn(level_outs)
            if viz is not None:
                viz["fpn_outputs"][head], viz["kfpn_weights"][head] = level_outs, weights
        return ret
