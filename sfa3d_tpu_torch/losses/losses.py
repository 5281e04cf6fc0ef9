"""Detection losses in PyTorch: the port of `sfa3d_tpu/losses/losses.py`.

- `focal_loss`: CornerNet focal loss, alpha 2, beta 4, normalised by the
  number of ground-truth peaks (the negative part alone when there is none).
- `masked_l1_loss`: L1 over the object slots gathered at the heatmap
  indices, / (mask sum + 1e-4).
- `balanced_l1_loss`: Libra R-CNN balanced L1, alpha 0.5, gamma 1.5, beta 1.
- `compute_loss`: all terms weight 1.0 on the raw head outputs (NHWC); the
  heatmap and offset heads go through the straight-through
  `clamped_sigmoid`, whose gradient stays the sigmoid's below the clamp.

Under a data-parallel group (`collectives.py::data_parallel`) the
normalizers are global, as under JAX's data-sharded jit: `compute_loss`
sums the positive count and the object count over the ranks of
`collectives.py::loss_group` (the 'data' axis: on a data x spatial mesh
the ranks of one spatial group hold the same frames' targets) in one
all-reduce before any division, and the `num_pos == 0` branch is taken on
the global count, so each rank's loss is its data shard's share of the
global loss (the shares sum to it).

All math runs in at least float32 (bfloat16 outputs are upcast; float64
stays float64). Integer powers are written as products, as XLA computes
`jnp.power(x, 2)` and `jnp.power(x, 4)` (x * x, then its square).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from sfa3d_tpu_torch.models import clamped_sigmoid
from sfa3d_tpu_torch.collectives import all_reduce_sum, loss_group


def _at_least_f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.promote_types(x.dtype, torch.float32))


def focal_loss(pred: torch.Tensor, gt: torch.Tensor, num_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """CornerNet focal loss (alpha 2, beta 4). `pred` in (0, 1), already
    sigmoided and clamped; `gt` the Gaussian heatmap; both (B, H, W, C).
    `num_pos` replaces the count of ground-truth peaks (the global one
    under a data-parallel group)."""
    pred = _at_least_f32(pred)
    gt = _at_least_f32(gt)
    pos = (gt == 1.0).to(gt.dtype)
    neg = (gt < 1.0).to(gt.dtype)
    one_minus_gt = 1.0 - gt
    sq = one_minus_gt * one_minus_gt
    neg_weights = sq * sq
    one_minus_pred = 1.0 - pred
    pos_loss = torch.log(pred) * (one_minus_pred * one_minus_pred) * pos
    neg_loss = torch.log(one_minus_pred) * (pred * pred) * neg_weights * neg
    if num_pos is None:
        num_pos = pos.sum()
    pos_sum = pos_loss.sum()
    neg_sum = neg_loss.sum()
    return torch.where(num_pos == 0, -neg_sum, -(pos_sum + neg_sum) / torch.clamp_min(num_pos, 1.0))


def gather_slots(output: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """(B, H, W, D) head output + (B, K) flat y * W + x indices -> (B, K, D),
    the index convention of `build_targets`."""
    b, h, w, d = output.shape
    idx = indices.to(torch.int64)[..., None].expand(-1, -1, d)
    return torch.gather(output.reshape(b, h * w, d), 1, idx)


def masked_l1_loss(output, obj_mask, indices, target, mask_sum: Optional[torch.Tensor] = None) -> torch.Tensor:
    """L1 over the gathered object slots, / (mask_sum + 1e-4); `mask_sum`
    defaults to the sum of the mask over the slots and their D values."""
    pred = gather_slots(_at_least_f32(output), indices)
    mask = obj_mask[..., None].to(pred.dtype).expand_as(pred)
    loss = torch.abs(pred * mask - target.to(pred.dtype) * mask).sum()
    return loss / ((mask.sum() if mask_sum is None else mask_sum) + 1e-4)


def balanced_l1_loss(output, obj_mask, indices, target,
                     alpha: float = 0.5, gamma: float = 1.5, beta: float = 1.0,
                     mask_sum: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Libra R-CNN balanced L1 over the gathered slots (`mask_sum` as in
    masked_l1_loss)."""
    pred = gather_slots(_at_least_f32(output), indices)
    mask = obj_mask[..., None].to(pred.dtype).expand_as(pred)
    diff = torch.abs(pred * mask - target.to(pred.dtype) * mask)
    b = math.exp(gamma / alpha) - 1.0
    loss = torch.where(
        diff < beta,
        alpha / b * (b * diff + 1.0) * torch.log(b * diff / beta + 1.0) - alpha * diff,
        gamma * diff + gamma / b - alpha * beta,
    )
    return loss.sum() / ((mask.sum() if mask_sum is None else mask_sum) + 1e-4)


def compute_loss(outputs: Dict[str, torch.Tensor],
                 tg: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total detection loss and its terms. `outputs`: raw head outputs, NHWC
    (B, H, W, C) each; `tg`: the `build_targets` dict. The heads' grid
    must be the targets' heatmap grid (KFPN's and the deconv arch's heads
    are both at stride 4 of the raster); another one raises ValueError."""
    if outputs["hm_cen"].shape != tg["hm_cen"].shape:
        raise ValueError(f"the heatmap head {tuple(outputs['hm_cen'].shape)} is not on the targets' grid "
                         f"{tuple(tg['hm_cen'].shape)}")
    hm = clamped_sigmoid(outputs["hm_cen"])
    offset = clamped_sigmoid(outputs["cen_offset"])
    mask, idx = tg["obj_mask"], tg["indices_center"]

    num_pos, n_obj = None, None
    if loss_group() is not None:  # the global counts, in one all-reduce
        gt = _at_least_f32(tg["hm_cen"])
        counts = all_reduce_sum(torch.stack([(gt == 1.0).to(gt.dtype).sum(), mask.to(gt.dtype).sum()]))
        num_pos, n_obj = counts[0], counts[1]
    dims = {k: tg[k].shape[-1] for k in ("cen_offset", "direction", "z_coor", "dim")}
    ms = {k: None if n_obj is None else n_obj * d for k, d in dims.items()}

    l_hm = focal_loss(hm, tg["hm_cen"], num_pos)
    l_off = masked_l1_loss(offset, mask, idx, tg["cen_offset"], mask_sum=ms["cen_offset"])
    l_dir = masked_l1_loss(outputs["direction"], mask, idx, tg["direction"], mask_sum=ms["direction"])
    l_z = balanced_l1_loss(outputs["z_coor"], mask, idx, tg["z_coor"], mask_sum=ms["z_coor"])
    l_dim = balanced_l1_loss(outputs["dim"], mask, idx, tg["dim"], mask_sum=ms["dim"])

    total = l_hm + l_off + l_dir + l_z + l_dim
    stats = {
        "total_loss": total,
        "hm_cen_loss": l_hm,
        "cen_offset_loss": l_off,
        "dim_loss": l_dim,
        "direction_loss": l_dir,
        "z_coor_loss": l_z,
    }
    return total, stats
