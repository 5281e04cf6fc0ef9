"""CLEAR-MOT and identity metrics for the 3D tracker, the port's copy of
`sfa3d_tpu/tracking/metrics.py` (host numpy and scipy, as the JAX module
is; the port keeps its own copy rather than import the JAX package).

- CLEAR-MOT (Bernardin & Stiefelhagen 2008): MOTA, MOTP, FP/FN/ID-switch
  counts, with the sticky-match rule (a GT keeps its previous track while
  it stays within the gate, so jitter cannot inflate IDSW).
- Identity metrics (Ristani et al. 2016): IDF1/IDP/IDR through one global
  trajectory-level Hungarian assignment.
- Track coverage: mostly tracked (MT, >= 80% of a GT's frames) and mostly
  lost (ML, <= 20%).

Matching is gated by BEV centre distance (2 m by default), with a Hungarian
assignment per frame on the gated cost (scipy's linear_sum_assignment). It
runs once per sequence on the host, on the tracker's fixed-slot output
(masked rows dropped here).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from scipy.optimize import linear_sum_assignment

Frame = Tuple[np.ndarray, np.ndarray]  # (ids (N,) int, centers (N, 2) f32)


def _assign(cost: np.ndarray, gate: float) -> List[Tuple[int, int]]:
    """Min-cost bipartite matching on `cost`, keeping only pairs < gate."""
    if cost.size == 0:
        return []
    # cap gated-out pairs so the solver never prefers an invalid pair
    capped = np.where(cost < gate, cost, 1e9)
    rows, cols = linear_sum_assignment(capped)
    return [(int(r), int(c)) for r, c in zip(rows, cols) if cost[r, c] < gate]


def _as_frames(seq) -> List[Frame]:
    out = []
    for ids, centers in seq:
        ids = np.asarray(ids, np.int64).reshape(-1)
        if len(ids) == 0:
            centers = np.zeros((0, 2), np.float64)
        else:
            centers = np.asarray(centers, np.float64) \
                .reshape(len(ids), -1)[:, :2]
        out.append((ids, centers))
    return out


def clear_mot(
    gt_seq: Sequence[Frame],
    pred_seq: Sequence[Frame],
    dist_gate: float = 2.0,
) -> Dict[str, float]:
    """Evaluate a tracked sequence against ground truth.

    gt_seq / pred_seq: one (ids, centers) pair per frame — ids (N,) int,
    centers (N, >=2) using BEV x/y in meters. Tracker output converts via
    `tracker_output_to_frames`. Returns the metric dict (counts + rates).
    """
    if len(gt_seq) != len(pred_seq):
        raise ValueError(
            f"gt has {len(gt_seq)} frames, predictions {len(pred_seq)}")
    gt_seq, pred_seq = _as_frames(gt_seq), _as_frames(pred_seq)

    n_gt = n_fp = n_fn = n_idsw = n_match = 0
    dist_sum = 0.0
    last_track: Dict[int, int] = {}  # gt id -> track id of its last match
    gt_frames: Dict[int, int] = {}  # gt id -> #frames present
    gt_tracked: Dict[int, int] = {}  # gt id -> #frames matched

    for (gids, gxy), (pids, pxy) in zip(gt_seq, pred_seq):
        n_gt += len(gids)
        for g in gids:
            gt_frames[int(g)] = gt_frames.get(int(g), 0) + 1
        cost = np.linalg.norm(gxy[:, None, :] - pxy[None, :, :], axis=-1) \
            if len(gids) and len(pids) else np.zeros((len(gids), len(pids)))

        # CLEAR step 1: keep last frame's correspondences while still valid
        matched_g, matched_p = set(), set()
        pairs: List[Tuple[int, int]] = []
        pid_to_col = {int(p): j for j, p in enumerate(pids)}
        for i, g in enumerate(gids):
            t = last_track.get(int(g))
            j = pid_to_col.get(t) if t is not None else None
            if j is not None and cost[i, j] < dist_gate:
                pairs.append((i, j))
                matched_g.add(i)
                matched_p.add(j)

        # CLEAR step 2: Hungarian over the remainder
        free_g = [i for i in range(len(gids)) if i not in matched_g]
        free_p = [j for j in range(len(pids)) if j not in matched_p]
        sub = cost[np.ix_(free_g, free_p)] if free_g and free_p \
            else np.zeros((0, 0))
        for r, c in _assign(sub, dist_gate):
            pairs.append((free_g[r], free_p[c]))

        for i, j in pairs:
            g, t = int(gids[i]), int(pids[j])
            if g in last_track and last_track[g] != t:
                n_idsw += 1
            last_track[g] = t
            gt_tracked[g] = gt_tracked.get(g, 0) + 1
            dist_sum += float(cost[i, j])
        n_match += len(pairs)
        n_fn += len(gids) - len(pairs)
        n_fp += len(pids) - len(pairs)

    # identity metrics: ONE global gt-trajectory <-> track-trajectory map
    overlap: Dict[Tuple[int, int], int] = {}
    total_pred = 0
    for (gids, gxy), (pids, pxy) in zip(gt_seq, pred_seq):
        total_pred += len(pids)
        if not (len(gids) and len(pids)):
            continue
        cost = np.linalg.norm(gxy[:, None, :] - pxy[None, :, :], axis=-1)
        # Ristani overlap: every gated co-occurrence counts; one-to-one is
        # enforced once, globally, by the trajectory-level assignment below
        for r, c in zip(*np.nonzero(cost < dist_gate)):
            key = (int(gids[r]), int(pids[c]))
            overlap[key] = overlap.get(key, 0) + 1
    g_ids = sorted({g for g, _ in overlap} | set(gt_frames))
    t_ids = sorted({t for _, t in overlap})
    idtp = 0
    if g_ids and t_ids:
        gain = np.zeros((len(g_ids), len(t_ids)))
        for (g, t), n in overlap.items():
            gain[g_ids.index(g), t_ids.index(t)] = n
        rows, cols = linear_sum_assignment(-gain)
        idtp = int(gain[rows, cols].sum())
    idp = idtp / total_pred if total_pred else 0.0
    idr = idtp / n_gt if n_gt else 0.0
    idf1 = 2 * idtp / (n_gt + total_pred) if (n_gt + total_pred) else 0.0

    cover = [gt_tracked.get(g, 0) / f for g, f in gt_frames.items()]
    return {
        "mota": 1.0 - (n_fn + n_fp + n_idsw) / n_gt if n_gt else 0.0,
        "motp": dist_sum / n_match if n_match else 0.0,
        "idf1": idf1,
        "idp": idp,
        "idr": idr,
        "id_switches": n_idsw,
        "false_positives": n_fp,
        "misses": n_fn,
        "matches": n_match,
        "n_gt": n_gt,
        "n_pred": total_pred,
        "mostly_tracked": sum(c >= 0.8 for c in cover),
        "mostly_lost": sum(c <= 0.2 for c in cover),
        "n_gt_trajectories": len(gt_frames),
    }


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)


def tracker_output_to_frames(
    outs: Dict[str, np.ndarray],
    cls: Optional[int] = None,
) -> List[Frame]:
    """Stacked `track_sequence` output (or a list of per-step dicts), numpy
    or tensors on any device -> the (ids, centers) frame list `clear_mot`
    consumes. Boxes rows are the tracker's (cls, x, y, z, h, w, l, yaw);
    optional `cls` filters to one class (per-class MOT evaluation, the
    KITTI-MOT convention)."""
    if isinstance(outs, dict):
        host = {k: _host(v) for k, v in outs.items()}
        frames_iter = [{k: v[f] for k, v in host.items()} for f in range(len(host["alive"]))]
    else:
        frames_iter = [{k: _host(v) for k, v in o.items()} for o in outs]
    frames: List[Frame] = []
    for o in frames_iter:
        keep = o["alive"].astype(bool)
        if cls is not None:
            keep &= o["boxes"][:, 0].astype(np.int64) == cls
        frames.append((o["ids"][keep], o["boxes"][keep, 1:3]))
    return frames
