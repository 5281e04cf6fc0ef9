"""Pairwise IoU of [x, y, w, h] boxes, the port of `sfa3d_tpu/fusion/iou.py`.

Every step is its own float32 operation in the JAX source's order:
`x + w` first, `(a1 + a2) - inter`, `inter / max(union, 1e-12)`, 0 where
`union <= 0`. This is bit-exact with the JAX function run op by op. Under
`jit`, XLA:CPU contracts a product and the sum that follows it into a fused
multiply-add inside a fusion, so the jitted JAX IoU may differ from this
one by one float32 ulp (tests/test_torch_fusion.py pins both statements).
The CUDA loop kernels (`csrc/fusion_loops.cu`) repeat this order with
`__fadd_rn`/`__fmul_rn`/`__fdiv_rn`.
"""

from __future__ import annotations

import torch


def pairwise_iou_xywh(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """(..., N, 4) x (..., M, 4) [x, y, w, h] -> (..., N, M) IoU."""
    x1, y1, w1, h1 = boxes1.unbind(-1)
    x2, y2, w2, h2 = boxes2.unbind(-1)
    left = torch.maximum(x1[..., :, None], x2[..., None, :])
    top = torch.maximum(y1[..., :, None], y2[..., None, :])
    right = torch.minimum((x1 + w1)[..., :, None], (x2 + w2)[..., None, :])
    bottom = torch.minimum((y1 + h1)[..., :, None], (y2 + h2)[..., None, :])
    inter = torch.clamp_min(right - left, 0.0) * torch.clamp_min(bottom - top, 0.0)
    union = (w1 * h1)[..., :, None] + (w2 * h2)[..., None, :] - inter
    return torch.where(union > 0, inter / torch.clamp_min(union, 1e-12), 0.0)


def iou_xywh(box1, box2) -> torch.Tensor:
    """Scalar IoU of two [x, y, w, h] boxes."""
    b1 = torch.as_tensor(box1, dtype=torch.float32)
    b2 = torch.as_tensor(box2, dtype=torch.float32)
    return pairwise_iou_xywh(b1[None, :], b2[None, :])[0, 0]
