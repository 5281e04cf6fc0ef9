"""KFPN introspection dumps, the port of `sfa3d_tpu/viz/kfpn_viz.py`, drawn
without matplotlib.

From the tensors of `KFPN.forward_features` (the port's NCHW layout) it
writes what the JAX module writes, under the same file names: the backbone
stages and the pyramid levels as grids of their first 16 channels
(`backbone_layer{i}.png`, `pyramid_level{i}.png`), each level's per-channel
mean and standard deviation as a line plot (`pyramid_level{i}_stats.png`),
each head's softmax attention per level (`attention_{head}.png`) and its
mean per level as bars (`attention_{head}_dist.png`), and each head's raw
per-level outputs (`fpn_{head}.png`).

Each panel is min-max normalised as matplotlib's `imshow` does by default
and coloured through matplotlib's viridis (the 256-entry table of
`viz/bev_projection.py`, checked by `scripts/torch_viridis_table.py`); a
constant panel takes the table's first colour. The figures' layout (panel
size, margins, titles through `viz/raster.py`'s `put_text`, lines through
`polylines`, bars through `rectangle`) is the port's own, not matplotlib's
pixels.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

import numpy as np

from sfa3d_tpu_torch.viz import raster
from sfa3d_tpu_torch.viz.bev_projection import VIRIDIS_BGR

CELL = 240  # px a grid panel
GAP = 8
TITLE_PX = 40
_WHITE, _BLACK, _GREY = (255, 255, 255), (0, 0, 0), (160, 160, 160)
_BLUE, _ORANGE = (180, 119, 31), (14, 127, 255)  # matplotlib's C0 and C1, BGR


def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().float().cpu().numpy()
    return np.asarray(t, np.float32)


def colorize(feat: np.ndarray) -> np.ndarray:
    """A 2D map -> BGR uint8 through viridis after imshow's min-max
    normalisation (index floor(x * 256), 1.0 on the last entry)."""
    f = np.asarray(feat, np.float64)
    lo, hi = np.nanmin(f), np.nanmax(f)
    if not hi > lo:
        idx = np.zeros(f.shape, np.int64)
    else:
        idx = np.clip(((f - lo) / (hi - lo) * 256).astype(np.int64), 0, 255)
    return VIRIDIS_BGR[idx]


def _fit(img: np.ndarray, size: int) -> np.ndarray:
    """Nearest-neighbour scale so the longer side is `size` px."""
    h, w = img.shape[:2]
    scale = size / max(h, w)
    nh, nw = max(1, int(round(h * scale))), max(1, int(round(w * scale)))
    return img[(np.arange(nh) * h) // nh][:, (np.arange(nw) * w) // nw]


def _title(canvas: np.ndarray, text: str, y: int, scale: float = 0.5) -> None:
    (tw, _), _ = raster.get_text_size(text, raster.FONT_HERSHEY_SIMPLEX, scale, 1)
    x = max((canvas.shape[1] - tw) // 2, 2)
    raster.put_text(canvas, text, (x, y), raster.FONT_HERSHEY_SIMPLEX, scale, _BLACK, 1, raster.LINE_AA)


def grid_image(rows: int, cols: int, feats: Sequence[np.ndarray], title: str) -> np.ndarray:
    """`rows` x `cols` panels of the maps in `feats` (row-major, blank past
    their count) under a title, as a BGR uint8 image."""
    h = TITLE_PX + rows * (CELL + GAP) + GAP
    w = cols * (CELL + GAP) + GAP
    canvas = np.full((h, w, 3), 255, np.uint8)
    _title(canvas, title, TITLE_PX - 14)
    for i, feat in enumerate(feats[: rows * cols]):
        panel = _fit(colorize(feat), CELL)
        r, c = divmod(i, cols)
        y0 = TITLE_PX + GAP + r * (CELL + GAP) + (CELL - panel.shape[0]) // 2
        x0 = GAP + c * (CELL + GAP) + (CELL - panel.shape[1]) // 2
        canvas[y0:y0 + panel.shape[0], x0:x0 + panel.shape[1]] = panel
    return canvas


def _axes(size, title: str):
    """A white figure with its plot box: (canvas, (x0, y0, x1, y1))."""
    w, h = size
    canvas = np.full((h, w, 3), 255, np.uint8)
    box = (60, TITLE_PX, w - 20, h - 40)
    raster.rectangle(canvas, box[:2], box[2:], _BLACK, 1)
    _title(canvas, title, TITLE_PX - 14)
    return canvas, box


def _ylabels(canvas, box, lo: float, hi: float) -> None:
    x0, y0, x1, y1 = box
    for v, y in ((hi, y0 + 10), (lo, y1)):
        raster.put_text(canvas, f"{v:.3g}", (2, y), raster.FONT_HERSHEY_SIMPLEX, 0.4, _BLACK, 1, raster.LINE_AA)


def line_plot(series: Dict[str, np.ndarray], title: str, size=(960, 360)) -> np.ndarray:
    """Each named series over its index as a polyline in one box, with a
    legend, as a BGR uint8 image."""
    canvas, box = _axes(size, title)
    x0, y0, x1, y1 = box
    values = [np.asarray(v, np.float64) for v in series.values()]
    lo = min(float(v.min()) for v in values)
    hi = max(float(v.max()) for v in values)
    span = hi - lo if hi > lo else 1.0
    for k, (name, v) in enumerate(zip(series, values)):
        n = len(v)
        xs = x0 + 4 + np.arange(n) * (x1 - x0 - 8) / max(n - 1, 1)
        ys = y1 - 4 - (v - lo) / span * (y1 - y0 - 8)
        pts = np.stack([np.round(xs), np.round(ys)], axis=1).astype(np.int64)
        color = (_BLUE, _ORANGE)[k % 2]
        raster.polylines(canvas, [pts], False, color, 2)
        ly = y0 + 16 + 18 * k
        raster.line(canvas, (x1 - 90, ly - 4), (x1 - 66, ly - 4), color, 2)
        raster.put_text(canvas, name, (x1 - 60, ly), raster.FONT_HERSHEY_SIMPLEX, 0.4, _BLACK, 1, raster.LINE_AA)
    _ylabels(canvas, box, lo, hi)
    return canvas


def bar_plot(values: Sequence[float], title: str, xlabel: str, ylabel: str, size=(480, 360)) -> np.ndarray:
    """One bar per value from zero (or from the smallest value when all are
    negative), labelled by index, as a BGR uint8 image."""
    canvas, box = _axes(size, title)
    x0, y0, x1, y1 = box
    v = np.asarray(values, np.float64)
    lo, hi = min(0.0, float(v.min())), max(0.0, float(v.max()))
    span = hi - lo if hi > lo else 1.0
    n = len(v)
    slot = (x1 - x0) / max(n, 1)
    zero = y1 - (0.0 - lo) / span * (y1 - y0 - 8)
    for i, val in enumerate(v):
        left = int(round(x0 + slot * (i + 0.1)))
        right = int(round(x0 + slot * (i + 0.9)))
        top = int(round(y1 - (val - lo) / span * (y1 - y0 - 8)))
        a, b = sorted((top, int(round(zero))))
        raster.fill_convex_poly(canvas, np.array([[left, a], [right, a], [right, b], [left, b]]), _BLUE)
        raster.rectangle(canvas, (left, a), (right, b), _BLACK, 1)
        raster.put_text(canvas, str(i), ((left + right) // 2 - 4, y1 + 16), raster.FONT_HERSHEY_SIMPLEX, 0.4,
                        _BLACK, 1, raster.LINE_AA)
    raster.put_text(canvas, xlabel, ((x0 + x1) // 2 - 40, y1 + 34), raster.FONT_HERSHEY_SIMPLEX, 0.4, _BLACK, 1,
                    raster.LINE_AA)
    raster.put_text(canvas, ylabel, (2, y0 - 4), raster.FONT_HERSHEY_SIMPLEX, 0.4, _GREY, 1, raster.LINE_AA)
    _ylabels(canvas, box, lo, hi)
    return canvas


def _write(path: str, img: np.ndarray) -> None:
    from sfa3d_tpu_torch.data.png import write_image_bgr

    write_image_bgr(path, img)


def _channels(feat, max_channels: int) -> List[np.ndarray]:
    f = _np(feat)[0]  # (C, H, W)
    return [f[c] for c in range(min(max_channels, f.shape[0]))]


def _nhwc_shape(feat) -> tuple:
    b, c, h, w = tuple(feat.shape)
    return (b, h, w, c)


def save_backbone_features(viz: Dict, out_dir: str, max_channels: int = 16) -> None:
    """The backbone stages' first channels as 4 x 4 grids."""
    os.makedirs(out_dir, exist_ok=True)
    for idx, feat in enumerate(viz["backbone"]):
        title = f"backbone layer{idx + 1} {_nhwc_shape(feat)[1:]}"
        _write(os.path.join(out_dir, f"backbone_layer{idx + 1}.png"),
               grid_image(4, 4, _channels(feat, max_channels), title))


def save_pyramid_features(viz: Dict, out_dir: str, max_channels: int = 16) -> None:
    """The pyramid levels' first channels as 4 x 4 grids, and each level's
    per-channel mean and standard deviation."""
    os.makedirs(out_dir, exist_ok=True)
    for idx, feat in enumerate(viz["pyramid"]):
        f = _np(feat)[0]
        title = f"pyramid level{idx} {_nhwc_shape(feat)[1:]}"
        _write(os.path.join(out_dir, f"pyramid_level{idx}.png"), grid_image(4, 4, _channels(feat, max_channels), title))
        stats = {"mean": f.mean(axis=(1, 2)), "std": f.std(axis=(1, 2))}
        _write(os.path.join(out_dir, f"pyramid_level{idx}_stats.png"),
               line_plot(stats, f"pyramid level{idx} channel stats"))


def save_attention_weights(viz: Dict, out_dir: str) -> None:
    """Each head's softmax weights of its first channel per level, and the
    weights' mean per level as bars."""
    os.makedirs(out_dir, exist_ok=True)
    for head, weights in viz["kfpn_weights"].items():
        w = _np(weights)[0]  # (C, H, W, L)
        n_levels = w.shape[-1]
        _write(os.path.join(out_dir, f"attention_{head}.png"),
               grid_image(1, n_levels, [w[0, :, :, lvl] for lvl in range(n_levels)], f"{head} attention per level"))
        _write(os.path.join(out_dir, f"attention_{head}_dist.png"),
               bar_plot(w.mean(axis=(0, 1, 2)), head, "pyramid level", "mean attention"))


def save_fpn_outputs(viz: Dict, out_dir: str) -> None:
    """Each head's per-level outputs (first channel)."""
    os.makedirs(out_dir, exist_ok=True)
    for head, levels in viz["fpn_outputs"].items():
        maps = [_np(lvl)[0, 0] for lvl in levels]
        _write(os.path.join(out_dir, f"fpn_{head}.png"), grid_image(1, len(maps), maps, f"{head} per-level outputs"))


def save_all(viz: Dict, out_dir: str) -> None:
    save_backbone_features(viz, out_dir)
    save_pyramid_features(viz, out_dir)
    save_attention_weights(viz, out_dir)
    save_fpn_outputs(viz, out_dir)
