"""Rotated-box IoU (BEV and 3D) on tensors, the port of
`sfa3d_tpu/ops/rotated_iou.py`, batched over every pair of two box sets.

The intersection of two rotated rectangles is Sutherland-Hodgman clipping
of the first by the four edges of the second, with a fixed budget of 8
vertices per polygon: each clip emits, per active edge, the current vertex
(if inside) and the crossing point (if the edge crosses), compacted by a
scatter-add at the running count clipped to slot 7 (so an overflowing
polygon adds into the last slot, as the JAX program does). The crossing's
denominator is clamped away from 0 keeping its sign. The 3D IoU multiplies
the BEV overlap by the vertical overlap; z is the bottom of a box.

Box conventions: BEV (x, y, w, l, yaw) with w along the box's local y and
l along its local x; 3D (x, y, z, h, w, l, yaw) velodyne boxes.
"""

from __future__ import annotations

import torch

MAX_VERTS = 8
_LOCAL = ((0.5, 0.5), (-0.5, 0.5), (-0.5, -0.5), (0.5, -0.5))


def box_corners_bev(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 5) [x, y, w, l, yaw] -> (..., 4, 2) counter-clockwise corners."""
    x, y, w, l, yaw = boxes.unbind(-1)
    c, s = torch.cos(yaw), torch.sin(yaw)
    local = torch.tensor(_LOCAL, dtype=boxes.dtype, device=boxes.device)
    lx = local[:, 0] * l[..., None]  # (..., 4)
    ly = local[:, 1] * w[..., None]
    # the rotation is XLA's (4, 2) x (2, 2) dot, which rounds the first
    # product and fuses the second into it: fma(ly, -s, lx * c), written
    # here as one rounding of an exact float64 sum
    cx = _fma(ly, -s[..., None], lx * c[..., None]) + x[..., None]
    cy = _fma(ly, c[..., None], lx * s[..., None]) + y[..., None]
    return torch.stack([cx, cy], -1)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c with one rounding to a's dtype (the float64 product of two
    float32 values is exact)."""
    return (a.double() * b.double() + c.double()).to(a.dtype)


def _next_index(n: torch.Tensor) -> torch.Tensor:
    """(P,) vertex counts -> (P, MAX_VERTS) index of each slot's successor
    (slot n - 1 wraps to 0)."""
    idx = torch.arange(MAX_VERTS, device=n.device)
    return torch.where(idx + 1 < n[:, None], idx + 1, 0)


def _polygon_area(verts: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Shoelace area of the first n vertices of padded (P, 8, 2) polygons."""
    nxt = _next_index(n)
    active = torch.arange(MAX_VERTS, device=n.device) < n[:, None]
    x, y = verts[..., 0], verts[..., 1]
    xn, yn = torch.gather(x, 1, nxt), torch.gather(y, 1, nxt)
    cross = x * yn - xn * y
    return 0.5 * torch.abs(torch.where(active, cross, 0.0).sum(-1))


def _clip_by_halfplane(verts: torch.Tensor, n: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """Clip padded polygons (P, 8, 2) with n vertices by the half-plane left
    of the edge a -> b ((P, 2) each). Returns (new verts, new n)."""
    edge = b - a
    nxt = _next_index(n)
    cur = verts
    nx = torch.gather(verts, 1, nxt[..., None].expand(-1, -1, 2))

    def side(p):
        return edge[:, None, 0] * (p[..., 1] - a[:, None, 1]) - edge[:, None, 1] * (p[..., 0] - a[:, None, 0])

    s_cur, s_nxt = side(cur), side(nx)
    active = torch.arange(MAX_VERTS, device=n.device) < n[:, None]
    denom = s_cur - s_nxt
    # sign-preserving clamp: a tiny negative denominator must not become
    # +1e-12, which would flip t and put the crossing off the segment
    safe = torch.where(denom.abs() > 1e-12, denom, torch.where(denom < 0, -1e-12, 1e-12))
    t = s_cur / safe
    inter = cur + (nx - cur) * t[..., None]

    emit_cur = active & (s_cur >= 0)
    emit_int = active & ((s_cur >= 0) != (s_nxt >= 0))
    counts = emit_cur.to(torch.int64) + emit_int.to(torch.int64)
    offsets = torch.cumsum(counts, 1) - counts
    pos_cur = offsets.clamp(0, MAX_VERTS - 1)
    pos_int = (offsets + emit_cur.to(torch.int64)).clamp(0, MAX_VERTS - 1)
    out = torch.zeros_like(verts)
    out.scatter_add_(1, pos_cur[..., None].expand(-1, -1, 2), torch.where(emit_cur[..., None], cur, 0.0))
    out.scatter_add_(1, pos_int[..., None].expand(-1, -1, 2), torch.where(emit_int[..., None], inter, 0.0))
    return out, torch.clamp_max(counts.sum(1), MAX_VERTS)


def rotated_intersection_area(box1: torch.Tensor, box2: torch.Tensor) -> torch.Tensor:
    """Intersection areas of (P, 5) rotated BEV rectangles, pair by pair -> (P,)."""
    p = box1.shape[0]
    poly = torch.zeros((p, MAX_VERTS, 2), dtype=box1.dtype, device=box1.device)
    poly[:, :4] = box_corners_bev(box1)
    n = torch.full((p,), 4, dtype=torch.int64, device=box1.device)
    clip = box_corners_bev(box2)
    for i in range(4):
        poly, n = _clip_by_halfplane(poly, n, clip[:, i], clip[:, (i + 1) % 4])
    return torch.where(n >= 3, _polygon_area(poly, n), 0.0)


def _pairs(a: torch.Tensor, b: torch.Tensor):
    n, m = a.shape[0], b.shape[0]
    return a[:, None].expand(n, m, a.shape[-1]).reshape(n * m, -1), b[None].expand(n, m, b.shape[-1]).reshape(n * m, -1)


def pairwise_iou_bev_rotated(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """(N, 5) x (M, 5) [x, y, w, l, yaw] -> (N, M) rotated BEV IoU."""
    n, m = boxes1.shape[0], boxes2.shape[0]
    a, b = _pairs(boxes1, boxes2)
    inter = rotated_intersection_area(a, b)
    union = a[:, 2] * a[:, 3] + b[:, 2] * b[:, 3] - inter
    return (inter / torch.clamp_min(union, 1e-12)).reshape(n, m)


def pairwise_iou_3d(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """(N, 7) x (M, 7) [x, y, z, h, w, l, yaw] velodyne boxes (z the
    bottom, z..z+h the height) -> (N, M) 3D IoU: the BEV overlap area times
    the vertical overlap, over the union of the volumes."""
    n, m = boxes1.shape[0], boxes2.shape[0]
    a, b = _pairs(boxes1, boxes2)
    bev = [0, 1, 4, 5, 6]
    inter_bev = rotated_intersection_area(a[:, bev], b[:, bev])
    h_overlap = torch.clamp_min(torch.minimum(a[:, 2] + a[:, 3], b[:, 2] + b[:, 3])
                                - torch.maximum(a[:, 2], b[:, 2]), 0.0)
    inter = inter_bev * h_overlap
    v1 = a[:, 3] * a[:, 4] * a[:, 5]
    v2 = b[:, 3] * b[:, 4] * b[:, 5]
    return (inter / torch.clamp_min(v1 + v2 - inter, 1e-12)).reshape(n, m)
