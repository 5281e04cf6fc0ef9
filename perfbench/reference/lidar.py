"""The plain reference of the served LiDAR path, and the comparison that
decides `correct` for it.

Reference: the host range filter, the raster (`raster.py`), KFPN
(`kfpn.py`) with the seed's weights, the clamped sigmoid, the 3 x 3 peak
rule and SFA3D's decode (`utils/evaluation_utils.py::decode`,
`post_processing`, `convert_det_to_real_values`): a detection is a heatmap
peak among the K best over all classes with a score above the threshold;
its box is read from the heads at that cell,

    x = (row + off_y) * down / H * (maxX - minX) + minX
    y = (col + off_x) * down / W * (maxY - minY) + minY
    z = z_coor + minZ,   h, w, l = dim,   yaw = -atan2(dir_0, dir_1)

Comparison, reply by reply (a reply is (n, 9) rows [class, score, x, y, z,
h, w, l, yaw]). Each served row names its cell: the class, and the row and
column that its x and y fall in (an offset lies inside its cell, 1e-4
from either edge by the clamp). At that cell:

    score_err   |served score - reference score|
    box_err     largest |served - reference| over x, y, z, h, w, l (m),
                and the yaw's as the error of the direction vector it is
                read from: |yaw difference| x |(dir_0, dir_1)| (atan2
                magnifies noise where that vector is short)
    select_gap  how far the program's selection departs from the
                reference's, beyond a near-tie of TIE: a served row that
                is not a peak (its 3 x 3 maximum - its score - TIE) or is
                under the threshold; a reference peak that stands above
                each of its 8 neighbours by more than TIE, scores above
                the threshold and was not served, by how far it lies above
                the program's cut (its lowest served score when K rows were
                served, the threshold otherwise) less TIE. A duplicate or
                unplaceable row counts 1.

Each number is the largest over the sampled replies. Random weights put
many peaks near the K-th and some beside a neighbour of nearly the same
score, so two float32 programs may swap a near-tie in the ranking or in a
peak's 3 x 3 test: select_gap measures a decision by the score margin it
was taken on, and excuses margins under TIE (twice the LiDAR score limit:
two neighbours each within 4e-6 of the reference may swap). A peak test
flipped on a margin of 1e-7 costs the next candidate's score gap, 2e-3
on one scan of 128 (measured on one H100), without the excuse.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.harness import inputs
from perfbench.harness.weights import seeded_state
from perfbench.reference import kfpn, raster

BAD = 1.0  # a row that names no cell, or a cell twice
TIE = 8e-6  # score margins under this are near-ties that float32 noise may decide


def frames(cfg: dict, seed: int, n: int) -> list:
    """The requests of the seed's pool: raw KITTI-sized scans."""
    return inputs.scan_pool(seed, n)


def build_model(cfg: dict, seed: int, device) -> kfpn.KFPN:
    model = kfpn.KFPN(cfg["num_layers"], cfg["head_conv"])
    model.load_state_dict(seeded_state(model.state_dict(), seed, device, cfg["conditioning"]))
    return model.to(device).eval()


def clamped_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x).clamp(1e-4, 1 - 1e-4)


@torch.no_grad()
def heads(model, scans: Sequence[np.ndarray], cfg: dict, device, block: int = 8) -> List[Dict[str, np.ndarray]]:
    """Per scan: {"hm", "pool", "off", "z", "dim", "dir"}, float64 numpy,
    channels first at heatmap size."""
    out = []
    for i in range(0, len(scans), block):
        padded = [raster.filter_and_pad(s, cfg["boundary"], cfg["max_points"]) for s in scans[i: i + block]]
        pts = torch.from_numpy(np.stack([p for p, _ in padded])).to(device)
        valid = torch.from_numpy(np.stack([v for _, v in padded])).to(device)
        bev = raster.raster(pts, valid, cfg["boundary"], cfg["bev_height"], cfg["bev_width"])
        h = model(bev)
        hm = clamped_sigmoid(h["hm_cen"])
        out += heads_from(h, hm, F.max_pool2d(hm, 3, 1, 1), clamped_sigmoid(h["cen_offset"]))
    return out


def heads_from(h: Dict[str, torch.Tensor], hm, pool, off) -> List[Dict[str, np.ndarray]]:
    """A batch's raw heads, heatmap, its 3 x 3 maximum, the maximum of each
    cell's 8 neighbours ("nbr") and offsets -> one dict a frame, float64
    numpy."""
    padded = F.pad(hm, (1, 1, 1, 1), value=-float("inf"))
    H, W = hm.shape[-2:]
    nbr = torch.stack([padded[..., 1 + dy: 1 + dy + H, 1 + dx: 1 + dx + W]
                       for dy in (-1, 0, 1) for dx in (-1, 0, 1) if dy or dx]).amax(0)
    named = (("hm", hm), ("pool", pool), ("nbr", nbr), ("off", off), ("z", h["z_coor"]), ("dim", h["dim"]),
             ("dir", h["direction"]))
    return [{k: v[j].double().cpu().numpy() for k, v in named} for j in range(hm.shape[0])]


def boxes_at(ref: Dict[str, np.ndarray], c, r, q, cfg: dict) -> np.ndarray:
    """Metric rows [class, score, x, y, z, h, w, l, yaw] at cells (c, r, q)."""
    b, down = cfg["boundary"], cfg["down_ratio"]
    x = (r + ref["off"][1, r, q]) * down / cfg["bev_height"] * (b["maxX"] - b["minX"]) + b["minX"]
    y = (q + ref["off"][0, r, q]) * down / cfg["bev_width"] * (b["maxY"] - b["minY"]) + b["minY"]
    z = ref["z"][0, r, q] + b["minZ"]
    h, w, l = (ref["dim"][k, r, q] for k in range(3))
    yaw = -np.arctan2(ref["dir"][0, r, q], ref["dir"][1, r, q])
    return np.stack([np.asarray(c, np.float64), ref["hm"][c, r, q], x, y, z, h, w, l, yaw], -1)


def selected(ref: Dict[str, np.ndarray], cfg: dict):
    """(class, row, col) of the reference's detections: the K best 3 x 3
    peaks above the threshold."""
    peaks = np.where(ref["hm"] == ref["pool"], ref["hm"], -np.inf).ravel()
    k = cfg["K"]
    kth = np.partition(peaks, -k)[-k]
    idx = np.flatnonzero((peaks >= kth) & (peaks > cfg["peak_thresh"]))
    return np.unravel_index(idx, ref["hm"].shape)


def detections(ref: Dict[str, np.ndarray], cfg: dict) -> np.ndarray:
    """The reference's own reply (the control's served rows)."""
    c, r, q = selected(ref, cfg)
    return boxes_at(ref, c, r, q, cfg)


def compare(rows: np.ndarray, ref: Dict[str, np.ndarray], cfg: dict, scored: bool = True) -> Dict[str, float]:
    """One reply's numbers; scored=False for rows whose score column is
    not served (score_err is then 0)."""
    b, down = cfg["boundary"], cfg["down_ratio"]
    C, H, W = ref["hm"].shape
    score_err = box_err = gap = 0.0
    seen = set()
    served_scores = []
    for row in np.asarray(rows, np.float64).reshape(-1, 9):
        c = int(round(row[0]))
        r = int(np.floor((row[2] - b["minX"]) / (b["maxX"] - b["minX"]) * cfg["bev_height"] / down))
        q = int(np.floor((row[3] - b["minY"]) / (b["maxY"] - b["minY"]) * cfg["bev_width"] / down))
        if not (0 <= c < C and 0 <= r < H and 0 <= q < W) or (c, r, q) in seen:
            gap = max(gap, BAD)
            box_err = max(box_err, BAD)
            continue
        seen.add((c, r, q))
        want = boxes_at(ref, c, r, q, cfg)
        s = want[1]
        served_scores.append(s)
        if scored:
            score_err = max(score_err, abs(row[1] - s))
        d = np.abs(row[2:8] - want[2:8])
        dyaw = abs((row[8] - want[8] + np.pi) % (2 * np.pi) - np.pi) * np.hypot(*ref["dir"][:, r, q])
        box_err = max(box_err, float(d.max()), float(dyaw))
        gap = max(gap, ref["pool"][c, r, q] - s - TIE, cfg["peak_thresh"] - s - TIE)
    floor = min(served_scores) if len(served_scores) >= cfg["K"] else cfg["peak_thresh"]
    must = (ref["hm"] > ref["nbr"] + TIE) & (ref["hm"] > cfg["peak_thresh"] + TIE) & (ref["hm"] > floor + TIE)
    for c, r, q in zip(*np.nonzero(must)):
        if (int(c), int(r), int(q)) not in seen:
            gap = max(gap, ref["hm"][c, r, q] - floor - TIE)
    return {"score_err": float(score_err), "box_err": float(box_err), "select_gap": float(max(gap, 0.0))}


def worst(readings: List[Dict[str, float]]) -> Dict[str, float]:
    """The largest of each number over replies (NaN where there are none)."""
    keys = ("score_err", "box_err", "select_gap")
    return {k: max((r[k] for r in readings), default=float("nan")) for k in keys}


def check(cfg: dict, seed: int, scans: Sequence[np.ndarray], replies: List[tuple], device) -> Dict[str, float]:
    """replies: [(scan index, rows)] -> the worst of each number."""
    model = build_model(cfg, seed, device)
    need = sorted({i for i, _ in replies})
    refs = dict(zip(need, heads(model, [scans[i] for i in need], cfg, device)))
    del model
    return worst([compare(rows, refs[i], cfg) for i, rows in replies])


def control(cfg: dict, seed: int, scans: Sequence[np.ndarray], picks: Sequence[int], device) -> Dict[str, float]:
    """The control: the reference computed with TF32 on (the nearest
    precision below the configuration's) put in the program's place, its
    replies to the picked scans judged against the float32 reference."""
    need = sorted(set(int(i) for i in picks))
    model = build_model(cfg, seed, device)
    with tf32(False):
        exact = dict(zip(need, heads(model, [scans[i] for i in need], cfg, device)))
    with tf32(True):
        low = dict(zip(need, heads(model, [scans[i] for i in need], cfg, device)))
    return worst([compare(detections(low[int(i)], cfg), exact[int(i)], cfg) for i in picks])


class tf32:
    """Sets cuDNN's and cuBLAS's TF32 switches inside the block."""

    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        self.was = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = self.on

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.was


def control_readings(cfg: dict, traffic: dict, seed: int, device) -> Dict[str, Dict[str, float]]:
    """The control on one seed, over as many requests drawn from the seed's
    pool as a run samples."""
    scans = frames(cfg, seed, int(traffic["pool"]))
    picks = np.random.default_rng([int(seed) % (2 ** 63), 6]).integers(0, len(scans), int(traffic["sample"]))
    return {"tf32": control(cfg, seed, scans, picks, device)}
