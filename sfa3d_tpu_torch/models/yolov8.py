"""YOLOv8 in PyTorch with ultralytics parameter names, the port of
`sfa3d_tpu/models/yolov8.py`.

  backbone: Conv stem -> (Conv s2, C2f) x4 -> SPPF
  neck:     PAN-FPN (nearest 2x upsample + concat C2f top-down, strided Conv
            bottom-up)
  head:     per level a box branch (4 * 16 DFL logits) and a class branch
  decode:   DFL softmax expectation -> ltrb distances -> xyxy at the anchor
            centres, sigmoid class scores -> per-class NMS to fixed K

The module runs NCHW and is laid out as ultralytics' `DetectionModel`: a
list `model` of 23 layers whose parameters carry the keys `model.N.*`
(`model.22` is the head), so an ultralytics-layout state_dict loads with
strict=True. The public functions (`forward_levels`, `decode_predictions`,
`select_detections`) keep the JAX package's NHWC layout and fixed shapes.
BatchNorm is flax's (eps 1e-3, momentum 0.97, the biased running variance:
`FlaxBatchNorm2d`). `export_ultralytics_state_dict` /
`save_ultralytics_checkpoint` write the ultralytics layout that
`load_yolo_checkpoint` and the JAX package's `load_yolo_variables` read.
"""

from __future__ import annotations

import math
import os
import pickle
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sfa3d_tpu_torch.device import Device, resolve_device
from sfa3d_tpu_torch.models.kfpn import _lecun_normal_
from sfa3d_tpu_torch.models.resnet import FlaxBatchNorm2d

# (depth_mult, width_mult, max_channels)
SCALES = {
    "n": (1 / 3, 0.25, 1024),
    "s": (1 / 3, 0.50, 1024),
    "m": (2 / 3, 0.75, 768),
    "l": (1.0, 1.00, 512),
    "x": (1.0, 1.25, 512),
}
STEM_WIDTH_TO_SCALE = {16: "n", 32: "s", 48: "m", 64: "l", 80: "x"}

# the 80 COCO class names, in class-id order (the fuse CLI's labels)
COCO_NAMES = (
    "person bicycle car motorcycle airplane bus train truck boat traffic_light "
    "fire_hydrant stop_sign parking_meter bench bird cat dog horse sheep cow "
    "elephant bear zebra giraffe backpack umbrella handbag tie suitcase frisbee "
    "skis snowboard sports_ball kite baseball_bat baseball_glove skateboard "
    "surfboard tennis_racket bottle wine_glass cup fork knife spoon bowl banana "
    "apple sandwich orange broccoli carrot hot_dog pizza donut cake chair couch "
    "potted_plant bed dining_table toilet tv laptop mouse remote keyboard "
    "cell_phone microwave oven toaster sink refrigerator book clock vase "
    "scissors teddy_bear hair_drier toothbrush"
).split()

REG_MAX = 16
STRIDES = (8, 16, 32)
BN_EPS = 1e-3  # flax BatchNorm epsilon of the JAX model
BN_MOMENTUM = 0.97  # flax convention: running = 0.97 * running + 0.03 * batch

# ultralytics layer index -> the JAX model's module name
_UL_BACKBONE = {
    0: "stem", 1: "down1", 2: "c2f1", 3: "down2", 4: "c2f2",
    5: "down3", 6: "c2f3", 7: "down4", 8: "c2f4", 9: "sppf",
}
_UL_NECK = {12: "n_c2f1", 15: "n_c2f2", 16: "n_down1", 18: "n_c2f3",
            19: "n_down2", 21: "n_c2f4"}
HEAD_INDEX = 22


def _make_divisible(x: float, divisor: int = 8) -> int:
    return max(divisor, int(math.ceil(x / divisor) * divisor))


def scale_widths(scale: str) -> List[int]:
    _, w, mc = SCALES[scale]
    return [_make_divisible(min(c, mc) * w) for c in (64, 128, 256, 512, 1024)]


def scale_depths(scale: str) -> List[int]:
    d, _, _ = SCALES[scale]
    return [max(1, round(n * d)) for n in (3, 6, 6, 3)]


class ConvBnSiLU(nn.Module):
    """Bias-free conv (padding k // 2) + BatchNorm + SiLU: ultralytics `Conv`."""

    def __init__(self, cin: int, cout: int, kernel: int = 1, stride: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, kernel // 2, bias=False)
        self.bn = FlaxBatchNorm2d(cout, eps=BN_EPS, momentum=BN_MOMENTUM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.silu(self.bn(self.conv(x)))


class Bottleneck(nn.Module):
    def __init__(self, cin: int, features: int, shortcut: bool = True):
        super().__init__()
        self.cv1 = ConvBnSiLU(cin, features, 3)
        self.cv2 = ConvBnSiLU(features, features, 3)
        self.add = shortcut and cin == features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C2f(nn.Module):
    """cv1 to 2c channels, split [:c], [c:], n bottlenecks chained on the
    last part, concat [y0, y1, m0, ...], cv2."""

    def __init__(self, cin: int, features: int, n: int = 1, shortcut: bool = False):
        super().__init__()
        self.c = features // 2
        self.cv1 = ConvBnSiLU(cin, 2 * self.c, 1)
        self.cv2 = ConvBnSiLU((2 + n) * self.c, features, 1)
        self.m = nn.ModuleList(Bottleneck(self.c, self.c, shortcut) for _ in range(n))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv1(x)
        parts = [y[:, : self.c], y[:, self.c:]]
        for m in self.m:
            parts.append(m(parts[-1]))
        return self.cv2(torch.cat(parts, 1))


class SPPF(nn.Module):
    """cv1 to half the channels, three chained 5x5 max pools (padded with
    -inf, as flax's max_pool), concat, cv2."""

    def __init__(self, cin: int, features: int, pool: int = 5):
        super().__init__()
        c = cin // 2
        self.cv1 = ConvBnSiLU(cin, c, 1)
        self.cv2 = ConvBnSiLU(4 * c, features, 1)
        self.m = nn.MaxPool2d(pool, stride=1, padding=pool // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv1(x)
        y1 = self.m(y)
        y2 = self.m(y1)
        return self.cv2(torch.cat([y, y1, y2, self.m(y2)], 1))


class Upsample2x(nn.Module):
    """Nearest 2x upsampling (the JAX model's jnp.repeat twice)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.interpolate(x, scale_factor=2.0, mode="nearest")


class Concat(nn.Module):
    def forward(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        return torch.cat(list(xs), 1)


class DFL(nn.Module):
    """Holds ultralytics' fixed DFL kernel (`model.22.dfl.conv.weight`, the
    arange 0..15). The expectation itself is `dfl_expectation`."""

    def __init__(self, c1: int = REG_MAX):
        super().__init__()
        self.conv = nn.Conv2d(c1, 1, 1, bias=False).requires_grad_(False)
        with torch.no_grad():
            self.conv.weight.copy_(torch.arange(c1, dtype=torch.float32).view(1, c1, 1, 1))


class DetectHead(nn.Module):
    """Per-level box (DFL logits) and class branches (ultralytics `Detect`)."""

    def __init__(self, num_classes: int, ch: Sequence[int]):
        super().__init__()
        c2 = max(16, ch[0] // 4, REG_MAX * 4)
        c3 = max(ch[0], min(num_classes, 100))
        self.cv2 = nn.ModuleList(
            nn.Sequential(ConvBnSiLU(c, c2, 3), ConvBnSiLU(c2, c2, 3), nn.Conv2d(c2, 4 * REG_MAX, 1))
            for c in ch
        )
        self.cv3 = nn.ModuleList(
            nn.Sequential(ConvBnSiLU(c, c3, 3), ConvBnSiLU(c3, c3, 3), nn.Conv2d(c3, num_classes, 1))
            for c in ch
        )
        self.dfl = DFL(REG_MAX)

    def forward(self, feats: Sequence[torch.Tensor]) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        return [(box(x), cls(x)) for x, box, cls in zip(feats, self.cv2, self.cv3)]


class YOLOv8(nn.Module):
    """The full detector. `forward` takes (B, 3, H, W) and returns a list of
    (box_logits (B, 64, h, w), cls_logits (B, nc, h, w)) per level (strides
    8/16/32)."""

    def __init__(self, scale: str = "n", num_classes: int = 80):
        super().__init__()
        if scale not in SCALES:
            raise ValueError(f"unknown YOLOv8 scale {scale!r}; have {sorted(SCALES)}")
        self.scale = scale
        self.num_classes = num_classes
        w1, w2, w3, w4, w5 = scale_widths(scale)
        d1, d2, d3, d4 = scale_depths(scale)
        self.model = nn.ModuleList([
            ConvBnSiLU(3, w1, 3, 2),  # 0  P1
            ConvBnSiLU(w1, w2, 3, 2),  # 1  P2
            C2f(w2, w2, d1, True),  # 2
            ConvBnSiLU(w2, w3, 3, 2),  # 3  P3
            C2f(w3, w3, d2, True),  # 4
            ConvBnSiLU(w3, w4, 3, 2),  # 5  P4
            C2f(w4, w4, d3, True),  # 6
            ConvBnSiLU(w4, w5, 3, 2),  # 7  P5
            C2f(w5, w5, d4, True),  # 8
            SPPF(w5, w5, 5),  # 9
            Upsample2x(),  # 10
            Concat(),  # 11 [up(p5), p4]
            C2f(w5 + w4, w4, d4, False),  # 12
            Upsample2x(),  # 13
            Concat(),  # 14 [up(n4), p3]
            C2f(w4 + w3, w3, d4, False),  # 15 P3 out
            ConvBnSiLU(w3, w3, 3, 2),  # 16
            Concat(),  # 17 [., n4]
            C2f(w3 + w4, w4, d4, False),  # 18 P4 out
            ConvBnSiLU(w4, w4, 3, 2),  # 19
            Concat(),  # 20 [., p5]
            C2f(w4 + w5, w5, d4, False),  # 21 P5 out
            DetectHead(num_classes, (w3, w4, w5)),  # 22
        ])

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None) -> "YOLOv8":
        """The JAX package's init, drawn from `generator`: lecun-normal conv
        kernels, zero biases, BatchNorm at identity, the fixed DFL kernel."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d) and m.weight.requires_grad:  # not the fixed DFL kernel
                _lecun_normal_(m.weight, generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
        return self

    def forward(self, x: torch.Tensor) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        m = self.model
        x = m[1](m[0](x))
        x = m[3](m[2](x))
        p3 = m[4](x)
        p4 = m[6](m[5](p3))
        p5 = m[9](m[8](m[7](p4)))
        n4 = m[12](m[11]([m[10](p5), p4]))
        n3 = m[15](m[14]([m[13](n4), p3]))
        n4o = m[18](m[17]([m[16](n3), n4]))
        n5o = m[21](m[20]([m[19](n4o), p5]))
        return m[HEAD_INDEX]([n3, n4o, n5o])


def forward_levels(model: YOLOv8, images: torch.Tensor) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """(B, H, W, 3) images -> per-level (box_logits (B, h, w, 64), cls_logits
    (B, h, w, nc)), NHWC views, on the model's device (the JAX
    `model.apply(variables, images)`)."""
    images = torch.as_tensor(images, device=next(model.parameters()).device)
    levels = model(images.permute(0, 3, 1, 2))
    return [(b.permute(0, 2, 3, 1), c.permute(0, 2, 3, 1)) for b, c in levels]


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def dfl_expectation(box_logits: torch.Tensor) -> torch.Tensor:
    """(..., 4 * 16) DFL logits -> (..., 4) ltrb distances: the expectation
    of a softmax over the 16 bins of each side, written as JAX's softmax
    (exp(x - max) / sum), in float32 (float64 logits stay float64)."""
    dtype = torch.promote_types(box_logits.dtype, torch.float32)
    x = box_logits.to(dtype).reshape(*box_logits.shape[:-1], 4, REG_MAX)
    e = torch.exp(x - x.amax(-1, keepdim=True))
    probs = e / e.sum(-1, keepdim=True)
    bins = torch.arange(REG_MAX, dtype=dtype, device=x.device)
    return (probs * bins).sum(-1)


def decode_predictions(level_outputs: Sequence[Tuple[torch.Tensor, torch.Tensor]]):
    """Per-level NHWC head outputs -> (boxes_xyxy (B, A, 4) in input pixels,
    scores (B, A, C) sigmoid class probabilities), A = all levels' anchors.
    Anchor centres are (arange + 0.5) * stride."""
    all_boxes, all_scores = [], []
    for (box_logits, cls_logits), stride in zip(level_outputs, STRIDES):
        b, h, w, _ = box_logits.shape
        ltrb = dfl_expectation(box_logits.float())  # (B, H, W, 4), float32 as JAX's decode
        ys = (torch.arange(h, dtype=torch.float32, device=ltrb.device) + 0.5)[None, :, None]
        xs = (torch.arange(w, dtype=torch.float32, device=ltrb.device) + 0.5)[None, None, :]
        x1 = (xs - ltrb[..., 0]) * stride
        y1 = (ys - ltrb[..., 1]) * stride
        x2 = (xs + ltrb[..., 2]) * stride
        y2 = (ys + ltrb[..., 3]) * stride
        all_boxes.append(torch.stack([x1, y1, x2, y2], dim=-1).reshape(b, h * w, 4))
        all_scores.append(torch.sigmoid(cls_logits.float()).reshape(b, h * w, cls_logits.shape[-1]))
    return torch.cat(all_boxes, 1), torch.cat(all_scores, 1)


def _top(values: torch.Tensor, k: int):
    """The k largest along the last axis, ties in index order (the order of
    XLA's TopK): a stable descending sort."""
    v, i = torch.sort(values, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def select_detections(boxes: torch.Tensor, scores: torch.Tensor, conf_thresh: float = 0.25,
                      iou_thresh: float = 0.45, max_det: int = 100, pre_nms: int = 0):
    """Ultralytics-style postprocess: best class per anchor, confidence
    gate, class-offset NMS, top max_det. (B, A, 4) xyxy + (B, A, C) scores
    (or one image, (A, 4) + (A, C)) -> (boxes_xyxy (B, max_det, 4), scores
    (B, max_det), classes (B, max_det) int32, valid (B, max_det)).

    Only the top `pre_nms` candidates by confidence enter NMS (0 means
    4 * max_det); the NMS is one launch of the hard-NMS loop kernel for the
    whole batch."""
    from sfa3d_tpu_torch.fusion.nms import hard_nms

    single = boxes.dim() == 2
    if single:
        boxes, scores = boxes[None], scores[None]
    cls = torch.argmax(scores, dim=-1)
    conf = scores.amax(-1)
    n_cand = min(pre_nms if pre_nms > 0 else 4 * max_det, conf.shape[-1])
    top_conf, top_idx = _top(conf, n_cand)
    top_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 4))
    top_cls = torch.gather(cls, 1, top_idx)
    valid = top_conf > conf_thresh

    # per-class NMS via the class-offset trick on xywh boxes
    offset = top_cls.to(torch.float32)[..., None] * 4096.0
    xy = top_boxes[..., :2]
    wh = top_boxes[..., 2:] - xy
    xywh_off = torch.cat([xy + offset, wh], dim=-1)
    keep = hard_nms(xywh_off, top_conf, valid, iou_thresh)

    final_conf = torch.where(keep, top_conf, -1.0)
    k = min(max_det, n_cand)  # tiny inputs can have fewer anchors than max_det
    sel_conf, sel = _top(final_conf, k)
    pad = max_det - k
    if pad:
        sel_conf = F.pad(sel_conf, (0, pad), value=-1.0)
        sel = F.pad(sel, (0, pad), value=0)
    out = (
        torch.gather(top_boxes, 1, sel[..., None].expand(-1, -1, 4)),
        torch.where(sel_conf > 0, sel_conf, 0.0),
        torch.gather(top_cls, 1, sel).to(torch.int32),
        sel_conf > 0,
    )
    return tuple(t[0] for t in out) if single else out


# ---------------------------------------------------------------------------
# host-side preprocessing + one-call detector
# ---------------------------------------------------------------------------


_COEF_SCALE = 2048  # cv2's INTER_RESIZE_COEF_SCALE: 11-bit fixed-point weights


def _linear_taps(dst: int, src: int, snap_left: bool):
    """cv2's INTER_LINEAR source index and fixed-point weights along one
    axis: the position (d + 0.5) * (src / dst) - 0.5 is computed in double
    and rounded to float32, its fraction in float32, and each weight is
    round-half-even(w * 2048) of the float32 weight. With `snap_left` (the
    horizontal axis) a position left of the first pixel takes pixel 0 with
    weight 1; the vertical axis keeps index -1 and its weights, and the
    caller clamps the rows. Returns (index, w0, w1)."""
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * (1.0 / (dst / src)) - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    if snap_left:
        f = np.where(s < 0, np.float32(0.0), f)
        s = np.maximum(s, 0)
    w0 = np.rint((np.float32(1.0) - f) * np.float32(_COEF_SCALE)).astype(np.int32)
    w1 = np.rint(f * np.float32(_COEF_SCALE)).astype(np.int32)
    return s, w0, w1


def _resize_uint8(img: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """cv2.resize(INTER_LINEAR) of a uint8 image, bit for bit, in numpy
    integer arithmetic (cv2's fixed-point path for 8-bit images):
    a horizontal pass with the 11-bit weights into int32 rows (a column at
    or past the last source pixel copies it x 2048), then per output row
    ((w0 * (row0 >> 4)) >> 16) + ((w1 * (row1 >> 4)) >> 16) + 2) >> 2, with
    the two source rows clamped into the image."""
    h, w = img.shape[:2]
    x = img.astype(np.int32).reshape(h, w, -1)
    sx, a0, a1 = _linear_taps(nw, w, snap_left=True)
    last = sx >= w - 1
    sx = np.where(last, w - 1, sx)
    a0, a1 = np.where(last, _COEF_SCALE, a0), np.where(last, 0, a1)
    rows = x[:, sx] * a0[None, :, None] + x[:, np.minimum(sx + 1, w - 1)] * a1[None, :, None]
    sy, b0, b1 = _linear_taps(nh, h, snap_left=False)
    r0 = rows[np.clip(sy, 0, h - 1)] >> 4
    r1 = rows[np.clip(sy + 1, 0, h - 1)] >> 4
    out = (((b0[:, None, None] * r0) >> 16) + ((b1[:, None, None] * r1) >> 16) + 2) >> 2
    return out.astype(np.uint8).reshape((nh, nw) + img.shape[2:])


def _resize_bilinear(img: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """cv2.resize(INTER_LINEAR) without cv2. uint8 images take cv2's
    fixed-point arithmetic (`_resize_uint8`, equal to cv2 bit for bit);
    other types take a float bilinear resize in PyTorch (half-pixel
    centres, no antialiasing) and come back float32."""
    if img.dtype == np.uint8:
        return _resize_uint8(img, nh, nw)
    t = torch.from_numpy(np.ascontiguousarray(img)).to(torch.float32)
    chw = t[None, None] if t.dim() == 2 else t.permute(2, 0, 1)[None]
    out = F.interpolate(chw, size=(nh, nw), mode="bilinear", align_corners=False, antialias=False)[0]
    out = out[0] if t.dim() == 2 else out.permute(1, 2, 0)
    return out.numpy()


def letterbox(img: np.ndarray, new_shape=640, stride: int = 32):
    """Resize + pad to the canvas, ultralytics-style, on the host (numpy and
    CPU PyTorch; no cv2). `new_shape`: int (square) or (h, w).
    Returns (image float32 /255 RGB (H, W, 3), scale r, (pad_left, pad_top))."""
    th, tw = (new_shape, new_shape) if isinstance(new_shape, int) else new_shape
    h, w = img.shape[:2]
    r = min(th / h, tw / w)
    nw, nh = round(w * r), round(h * r)
    pad_w, pad_h = (tw - nw) / 2, (th - nh) / 2
    if (nw, nh) != (w, h):
        img = _resize_bilinear(img, nh, nw)
    top, bottom = round(pad_h - 0.1), round(pad_h + 0.1)
    left, right = round(pad_w - 0.1), round(pad_w + 0.1)
    out = np.full((nh + top + bottom, nw + left + right) + img.shape[2:], 114, dtype=img.dtype)
    out[top:top + nh, left:left + nw] = img
    return out.astype(np.float32) / 255.0, r, (left, top)


def infer_yolo_meta(sd: Dict[str, object]) -> Tuple[str, int]:
    """(scale, num_classes) from an ultralytics-layout state_dict's shapes:
    the stem width names the scale, the last class conv the class count."""
    stem_w = int(sd["model.0.conv.weight"].shape[0])
    scale = STEM_WIDTH_TO_SCALE.get(stem_w)
    if scale is None:
        raise ValueError(f"unrecognized YOLOv8 stem width {stem_w}")
    return scale, int(sd["model.22.cv3.0.2.weight"].shape[0])


def read_yolo_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """An ultralytics-layout `.pt` -> its `model.N.*` tensors. Takes a raw
    state_dict or {'model': state_dict}; strips the extra `model.` prefix of
    a YOLO wrapper's state_dict (`model.model.*`) from the keys that carry
    it. A pickled ultralytics `DetectionModel` needs the ultralytics package
    to unpickle, which the port does not use: it raises."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"YOLOv8 weights not found: {path}")
    try:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        raise ValueError(
            f"{path} holds pickled objects (an ultralytics DetectionModel?), which need the "
            "ultralytics package; save its state_dict instead (model.state_dict())"
        ) from e
    if isinstance(sd, dict) and "model" in sd and not isinstance(sd["model"], torch.Tensor):
        sd = sd["model"]
    if not isinstance(sd, dict):
        raise ValueError(f"{path} holds a {type(sd).__name__}, not a YOLOv8 state_dict")
    if any(k.startswith("model.model.") for k in sd):
        sd = {(k[len("model."):] if k.startswith("model.") else k): v for k, v in sd.items()}
    return {k: v for k, v in sd.items() if k.startswith("model.")}


def export_ultralytics_state_dict(model: YOLOv8,
                                  params: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
    """The model as an ultralytics-layout state_dict of float32 CPU tensors:
    the `model.N.*` keys, the BatchNorm `num_batches_tracked` counters and
    the fixed DFL kernel `model.22.dfl.conv.weight`, as ultralytics' own
    trainer writes them. `params` (a name -> tensor map, e.g. the EMA
    weights) replaces the model's trainable parameters; the BatchNorm
    statistics stay the model's own."""
    sd = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    for k, v in (params or {}).items():
        if k not in sd:
            raise KeyError(f"{k} is not a parameter of the model")
        sd[k] = v.detach().cpu().clone()
    return {k: v.float() if v.is_floating_point() else v for k, v in sd.items()}


def save_ultralytics_checkpoint(model: YOLOv8, path: str,
                                params: Optional[Dict[str, torch.Tensor]] = None) -> str:
    """`torch.save` of `export_ultralytics_state_dict(model, params)`: a
    `.pt` that `load_yolo_checkpoint` (and the JAX package's
    `load_yolo_variables`) read. Returns `path`."""
    torch.save(export_ultralytics_state_dict(model, params), path)
    return path


def load_yolo_checkpoint(path: str) -> YOLOv8:
    """Build a YOLOv8 sized from the checkpoint's own shapes
    (`infer_yolo_meta`) and load it with strict=True. Returns the model on
    the CPU in eval mode."""
    sd = read_yolo_state_dict(path)
    scale, num_classes = infer_yolo_meta(sd)
    model = YOLOv8(scale=scale, num_classes=num_classes)
    model.load_state_dict({k: v.float() if v.is_floating_point() else v for k, v in sd.items()},
                          strict=True)
    return model.eval()


class YOLOv8Detector:
    """One-call detector: image -> ([x, y, w, h] int boxes, confidences,
    class ids) in ORIGINAL image pixels. On cuda unless device="cpu"; with
    no model, random weights from `torch.Generator().manual_seed(seed)`."""

    def __init__(self, scale: str = "n", num_classes: int = 80, model: Optional[YOLOv8] = None,
                 imgsz=640, max_det: int = 100, pre_nms: int = 0, device: Device = None,
                 seed: int = 0):
        self.device = resolve_device(device)
        if model is None:
            model = YOLOv8(scale, num_classes).init_weights(torch.Generator().manual_seed(seed))
        self.model = model.to(self.device).eval()
        self.imgsz = imgsz  # int or (h, w)
        self.max_det = max_det
        self.pre_nms = pre_nms

    @classmethod
    def from_weights(cls, path: str, **kw) -> "YOLOv8Detector":
        """A detector sized from a `.pt` checkpoint's own shapes."""
        return cls(model=load_yolo_checkpoint(path), **kw)

    def __call__(self, image_rgb: np.ndarray, conf: float = 0.25):
        img, r, (pad_w, pad_h) = letterbox(image_rgb, self.imgsz)
        with torch.inference_mode():
            levels = forward_levels(self.model, torch.from_numpy(img)[None].to(self.device))
            boxes, scores = decode_predictions(levels)
            b, s, c, v = select_detections(boxes[0], scores[0], conf_thresh=conf,
                                           max_det=self.max_det, pre_nms=self.pre_nms)
        b, s, c, v = (t.cpu().numpy() for t in (b, s, c, v))
        keep = v & (s >= conf)
        b = b[keep]
        b[:, [0, 2]] = (b[:, [0, 2]] - pad_w) / r
        b[:, [1, 3]] = (b[:, [1, 3]] - pad_h) / r
        h, w = image_rgb.shape[:2]
        b[:, [0, 2]] = b[:, [0, 2]].clip(0, w)
        b[:, [1, 3]] = b[:, [1, 3]].clip(0, h)
        boxes_xywh = [[int(x1), int(y1), int(x2) - int(x1), int(y2) - int(y1)] for x1, y1, x2, y2 in b]
        return boxes_xywh, s[keep].tolist(), c[keep].astype(int).tolist()
