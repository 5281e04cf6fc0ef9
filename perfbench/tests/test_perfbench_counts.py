"""The yardstick's counts against hand counts at small sizes."""

import torch
from torch import nn

from perfbench.harness import registry
from perfbench.reference import kfpn as ref_kfpn


def small_cfg(size):
    return {"bev_height": size, "bev_width": size, "head_conv": 64, "num_layers": 18}


def test_one_convolution_by_hand():
    kfpn = registry.load_module("counts", "kfpn")
    # 7x7, 3 -> 64 channels, 16 x 16 outputs: 2 * 49 * 3 * 64 * 256
    assert kfpn.conv(3, 64, 7, 16, 16) == 4816896
    # 2x bilinear of 8 channels at 4 x 5: 2 * 8 * (8*4*5 + 8*5*10)
    assert kfpn.upsample(8, 4, 5) == 2 * 8 * (160 + 400)


def test_kfpn_flops_equal_a_count_of_the_reference_layers():
    """At 64 x 64 the count equals one made independently, from the
    convolutions the reference model runs (forward hooks) and the three
    bilinear upsamples as matrix products."""
    model = ref_kfpn.KFPN(18, 64).eval()
    counted = []

    def hook(m, args, out):
        k = m.kernel_size[0] * m.kernel_size[1]
        counted.append(2 * k * m.in_channels * m.out_channels * out.shape[-2] * out.shape[-1])

    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            m.register_forward_hook(hook)
    with torch.no_grad():
        model(torch.zeros(1, 3, 64, 64))
    # out4 (512, 2x2) -> 4x4, level1 (256, 4x4) -> 8x8, level2 (128, 8x8) -> 16x16
    ups = sum(2 * c * (2 * h * h * h + 2 * h * h * 2 * h) for c, h in ((512, 2), (256, 4), (128, 8)))
    got = registry.load_module("counts", "kfpn").flops_per_frame(small_cfg(64))
    assert got == sum(counted) + ups


def test_kfpn_18_at_608_is_63_gflop():
    got = registry.load_module("counts", "kfpn").flops_per_frame(small_cfg(608))
    assert 63.0e9 < got < 64.0e9


def test_raster_bytes_by_hand():
    counts = registry.load_module("counts", "bev_raster_reduce")
    # 2 frames of 100 points: 3 int32 a point in; 3 float32 planes of 4 x 5 out
    assert counts.bytes_moved(2, 100, 4, 5) == 2 * 100 * 12 + 2 * 3 * 20 * 4
