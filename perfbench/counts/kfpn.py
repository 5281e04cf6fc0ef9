"""Floating-point operations of one KFPN forward on one frame, counted from
the layer shapes of SFA3D's `fpn_resnet` (`reference/kfpn.py`): a
convolution is 2 x k_h x k_w x C_in x C_out x H_out x W_out (one multiply
and one add a weight tap; bias, BatchNorm, ReLU, pooling and the level
softmax are left out, under 1% of it); a 2x bilinear upsample with
align_corners is counted as the program computes it, two products with
interpolation matrices: 2 x C x (2H x H x W + 2H x W x 2W).
"""

from __future__ import annotations

BLOCKS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3)}
HEADS = {"hm_cen": 3, "cen_offset": 2, "direction": 2, "z_coor": 1, "dim": 3}


def conv(cin: int, cout: int, k: int, h_out: int, w_out: int) -> int:
    return 2 * k * k * cin * cout * h_out * w_out


def upsample(c: int, h: int, w: int) -> int:
    return 2 * c * (2 * h * h * w + 2 * h * w * 2 * w)


def flops_per_frame(cfg: dict) -> int:
    H, W = cfg["bev_height"], cfg["bev_width"]
    head_conv, n_layers = cfg["head_conv"], cfg["num_layers"]
    total = conv(3, 64, 7, H // 2, W // 2)
    h, w, cin = H // 4, W // 4, 64
    sizes = []
    for stage, (planes, n) in enumerate(zip((64, 128, 256, 512), BLOCKS[n_layers])):
        for j in range(n):
            stride = 2 if (stage > 0 and j == 0) else 1
            h, w = h // stride, w // stride
            total += conv(cin, planes, 3, h, w) + conv(planes, planes, 3, h, w)
            if stride != 1 or cin != planes:
                total += conv(cin, planes, 1, h, w)
            cin = planes
        sizes.append((h, w))
    (h1, w1), (h2, w2), (h3, w3), (h4, w4) = sizes
    total += upsample(512, h4, w4) + conv(512 + 256, 256, 1, h3, w3)
    total += upsample(256, h3, w3) + conv(256 + 128, 128, 1, h2, w2)
    total += upsample(128, h2, w2) + conv(128 + 64, 64, 1, h1, w1)
    for (c, h, w) in ((256, h2, w2), (128, h1, w1), (64, h1, w1)):
        for out in HEADS.values():
            total += conv(c, head_conv, 3, h, w) + conv(head_conv, out, 1, h, w)
    return total
