"""3D multi-object tracking over per-frame detections, the port of
`sfa3d_tpu/tracking/tracker.py` (an AB3DMOT-style tracker: Weng et al.
2020, "3D Multi-Object Tracking: A Baseline").

- Fixed track slots (`max_tracks`) with alive / confirmed masks instead of
  a track list, so a step is a fixed set of tensor ops on one device and a
  sequence is a Python loop of steps (`lax.scan` in JAX).
- A constant-velocity Kalman filter per slot on [x, y, z, yaw, h, w, l]
  with velocity states [vx, vy, vz]; the (7, 7) innovation solve is batched
  over the slots.
- Association: rotated BEV IoU (`ops/rotated_iou.py`) between the predicted
  track boxes and the frame's detections, class-gated, greedy by descending
  detection score. The greedy loop is the CUDA kernel `track_associate`
  (`ops/track_associate.py`, one launch a step; its plain twin on the CPU).
- AB3DMOT's orientation correction: a yaw innovation beyond pi/2 is folded
  by pi before the update (a BEV box is pi-symmetric).
- Births fill free slots from unmatched detections (ids from a running
  counter), deaths follow `max_age` consecutive misses, and a track is
  confirmed once it has `min_hits` matches.

Input rows follow `ops/decode.detections_to_real`: metric velodyne-frame
[cls, x, y, z_bottom, h, w, l, yaw], a validity mask and scores. The whole
step runs on the state's device and copies nothing to the host.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from sfa3d_tpu_torch.device import Device, device_constant, resolve_device
from sfa3d_tpu_torch.ops.rotated_iou import pairwise_iou_bev_rotated
from sfa3d_tpu_torch.ops.track_associate import track_associate

# state layout: [x, y, z, yaw, h, w, l, vx, vy, vz]
DIM_X = 10
DIM_Z = 7
_VEL = slice(7, 10)  # vx, vy, vz
_YAW = 3

# constant-velocity transition: pos += vel (dt = 1 frame)
_F = np.eye(DIM_X, dtype=np.float32)
_F[0, 7] = _F[1, 8] = _F[2, 9] = 1.0
# observe the first 7 state dims
_H = np.zeros((DIM_Z, DIM_X), dtype=np.float32)
_H[:DIM_Z, :DIM_Z] = np.eye(DIM_Z)
# AB3DMOT covariance recipe: huge initial velocity uncertainty, modest
# process noise on velocity only, unit measurement noise
_P0 = np.eye(DIM_X, dtype=np.float32)
_P0[_VEL, _VEL] *= 1000.0
_P0 *= 10.0
_Q = np.zeros((DIM_X, DIM_X), dtype=np.float32)
_Q[7, 7] = _Q[8, 8] = _Q[9, 9] = 0.01
_R = np.eye(DIM_Z, dtype=np.float32)

# float32 pi, pi / 2 and 2 pi, as the JAX program's weakly typed constants
# become on float32 arrays
_PI = float(np.float32(np.pi))
_HALF_PI = float(np.float32(np.pi / 2))
_TWO_PI = float(np.float32(2.0 * np.pi))


@dataclasses.dataclass
class TrackState:
    """Fixed-slot tracker state: tensors on one device."""

    mean: torch.Tensor  # (T, 10) float32
    cov: torch.Tensor  # (T, 10, 10) float32
    alive: torch.Tensor  # (T,) bool
    track_id: torch.Tensor  # (T,) int32, -1 when free
    cls: torch.Tensor  # (T,) int32
    score: torch.Tensor  # (T,) float32, the last matched detection's score
    hits: torch.Tensor  # (T,) int32, total matches
    misses: torch.Tensor  # (T,) int32, consecutive misses
    next_id: torch.Tensor  # () int32

    @property
    def device(self) -> torch.device:
        return self.mean.device

    def replace(self, **changes) -> "TrackState":
        return dataclasses.replace(self, **changes)


_CONSTANTS = {"F": _F, "H": _H, "P0": _P0, "Q": _Q, "R": _R, "I": np.eye(DIM_X, dtype=np.float32)}


@device_constant
def _consts(device: torch.device) -> Dict[str, torch.Tensor]:
    """The filter's constant matrices on `device`, copied there once: a copy
    from pageable host memory synchronizes the stream, which on every step
    would stall the host's launches behind the device. Made outside
    inference mode, so that a copy first made under it serves any caller."""
    with torch.inference_mode(False):
        return {name: torch.from_numpy(a).to(device) for name, a in _CONSTANTS.items()}


def _to(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A tensor or array-like as `dtype` on `device` (host arrays are copied:
    they may be read-only)."""
    if not isinstance(x, torch.Tensor):
        x = torch.tensor(np.asarray(x), dtype=dtype)
    return x.to(device=device, dtype=dtype)


def init_tracks(max_tracks: int = 64, device: Device = None) -> TrackState:
    """Empty state of `max_tracks` slots on `device` (default cuda; raises
    without a GPU unless device="cpu")."""
    dev = resolve_device(device)
    t = max_tracks
    return TrackState(
        mean=torch.zeros((t, DIM_X), dtype=torch.float32, device=dev),
        cov=_consts(dev)["P0"].expand(t, DIM_X, DIM_X).clone(),
        alive=torch.zeros((t,), dtype=torch.bool, device=dev),
        track_id=torch.full((t,), -1, dtype=torch.int32, device=dev),
        cls=torch.zeros((t,), dtype=torch.int32, device=dev),
        score=torch.zeros((t,), dtype=torch.float32, device=dev),
        hits=torch.zeros((t,), dtype=torch.int32, device=dev),
        misses=torch.zeros((t,), dtype=torch.int32, device=dev),
        next_id=torch.zeros((), dtype=torch.int32, device=dev),
    )


def _wrap_pi(a: torch.Tensor) -> torch.Tensor:
    """Wrap angles to [-pi, pi): (a + pi) mod 2 pi - pi in float32, the mod
    taking the divisor's sign (`jnp.remainder` and `torch.remainder` are
    both fmod plus the divisor where the signs differ)."""
    return torch.remainder(a + _PI, _TWO_PI) - _PI


def _predict(state: TrackState) -> TrackState:
    c = _consts(state.device)
    F, Q = c["F"], c["Q"]
    mean = state.mean @ F.T
    # F's rows have one or two ones: (F @ cov) @ F^T adds two terms at a time,
    # in XLA's order for the einsum "ij,tjk,lk->til"
    cov = torch.matmul(torch.matmul(F, state.cov), F.T) + Q
    return state.replace(mean=mean, cov=cov)


def _associate(state: TrackState, det_boxes, det_scores, det_cls, det_valid, iou_min: float):
    """Greedy match by descending detection score. Returns (det_match (K,)
    int32 slot index or -1, track_matched (T,) bool)."""
    trk = state.mean
    trk5 = torch.stack([trk[:, 0], trk[:, 1], trk[:, 5], trk[:, 6], trk[:, 3]], -1)  # (T, 5) [x, y, w, l, yaw]
    det5 = torch.stack([det_boxes[:, 1], det_boxes[:, 2], det_boxes[:, 5], det_boxes[:, 6], det_boxes[:, 7]], -1)
    iou = pairwise_iou_bev_rotated(det5, trk5)  # (K, T)
    ok = det_valid[:, None] & state.alive[None, :] & (det_cls[:, None] == state.cls[None, :])
    iou = torch.where(ok, iou, -1.0)
    # highest-confidence detections first, ties in index order (jnp.argsort is stable)
    order = torch.sort(-det_scores, stable=True).indices.to(torch.int32)
    det_match, trk_used = track_associate(iou[None].contiguous(), order[None].contiguous(), iou_min)
    return det_match[0], trk_used[0]


def _kf_update(mean: torch.Tensor, cov: torch.Tensor, z: torch.Tensor):
    """One Kalman measurement update of every slot: mean (T, 10), cov (T,
    10, 10), z (T, 7) in the state's [x, y, z, yaw, h, w, l] order."""
    c = _consts(mean.device)
    H, R = c["H"], c["R"]
    y = z - mean @ H.T
    # AB3DMOT orientation correction: a yaw reading about pi away is the same
    # box facing backwards, so fold the innovation into [-pi/2, pi/2]
    dy = _wrap_pi(y[:, _YAW])
    dy = torch.where(dy > _HALF_PI, dy - _PI, dy)
    dy = torch.where(dy < -_HALF_PI, dy + _PI, dy)
    y = torch.cat([y[:, :_YAW], dy[:, None], y[:, _YAW + 1:]], 1)
    S = H @ cov @ H.T + R  # (T, 7, 7)
    # solve_ex: S = cov + I is positive definite, and solve's singularity
    # check would copy its info to the host (a stream sync) every step
    K = torch.linalg.solve_ex(S, H @ cov)[0].transpose(1, 2)  # (T, 10, 7)
    mean = mean + (K @ y[:, :, None])[:, :, 0]
    mean = torch.cat([mean[:, :_YAW], _wrap_pi(mean[:, _YAW:_YAW + 1]), mean[:, _YAW + 1:]], 1)
    cov = (c["I"] - K @ H) @ cov
    return mean, cov


def _put_rows(dst: torch.Tensor, target: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """dst with row target[k] set to src[k]; a target of len(dst) drops its
    row (JAX's `.at[target].set(src, mode="drop")`). Nothing is indexed out
    of range: dropped rows land in a scratch row that is cut off."""
    src = src.to(dst.dtype).expand(target.shape[0], *dst.shape[1:])
    ext = torch.cat([dst, dst[:1]])
    ext.index_copy_(0, target, src)
    return ext[:-1]


def tracker_step(
    state: TrackState,
    boxes_real,  # (K, 8) [cls, x, y, z, h, w, l, yaw]
    scores,  # (K,)
    valid,  # (K,) bool
    *,
    iou_min: float = 0.01,
    max_age: int = 3,
    min_hits: int = 2,
) -> Tuple[TrackState, Dict[str, torch.Tensor]]:
    """Advance the tracker one frame on the state's device. Returns
    (new_state, outputs); outputs report every slot with masks: ids (T,),
    boxes (T, 8) (the input's row layout), scores (T,), velocities (T, 3),
    alive (T,), confirmed (T,), confirmed meaning alive and hits >=
    min_hits. Numpy inputs are copied to the state's device."""
    dev = state.device
    boxes_real = _to(boxes_real, torch.float32, dev)
    scores = _to(scores, torch.float32, dev)
    valid = _to(valid, torch.bool, dev)
    det_cls = boxes_real[:, 0].to(torch.int32)
    state = _predict(state)
    det_match, _ = _associate(state, boxes_real, scores, det_cls, valid, iou_min)

    # --- update matched tracks ------------------------------------------
    t = state.alive.shape[0]
    k = boxes_real.shape[0]
    det_idx = torch.arange(k, dtype=torch.int32, device=dev)
    # per slot: the detection that matched it (-1 if none)
    slot_det = _put_rows(torch.full((t,), -1, dtype=torch.int32, device=dev),
                         torch.where(det_match >= 0, det_match, t).long(), det_idx)
    has_det = slot_det >= 0
    safe_det = slot_det.clamp_min(0).long()
    z = boxes_real[safe_det][:, 1:8]  # [x, y, z, h, w, l, yaw] -> the state's [x, y, z, yaw, h, w, l]
    z = torch.stack([z[:, 0], z[:, 1], z[:, 2], z[:, 6], z[:, 3], z[:, 4], z[:, 5]], -1)
    upd_mean, upd_cov = _kf_update(state.mean, state.cov, z)
    mean = torch.where(has_det[:, None], upd_mean, state.mean)
    cov = torch.where(has_det[:, None, None], upd_cov, state.cov)
    score = torch.where(has_det, scores[safe_det], state.score)
    hits = state.hits + has_det.to(torch.int32)
    misses = torch.where(has_det, 0, state.misses + state.alive.to(torch.int32))

    # --- deaths -----------------------------------------------------------
    alive = state.alive & (misses < max_age)

    # --- births -----------------------------------------------------------
    is_birth = valid & (det_match < 0)  # unmatched real detections
    free = ~alive
    # stable assignment: r-th birth -> r-th free slot
    free_slots = torch.sort((~free).to(torch.int32), stable=True).indices
    birth_rank = torch.cumsum(is_birth.to(torch.int32), 0, dtype=torch.int32) - 1  # (K,)
    n_free = free.to(torch.int32).sum()
    can_place = is_birth & (birth_rank < n_free)
    target = torch.where(can_place, free_slots[birth_rank.clamp(0, t - 1).long()], t)

    init_mean = torch.zeros((k, DIM_X), dtype=torch.float32, device=dev)
    init_mean[:, 0:3] = boxes_real[:, 1:4]
    init_mean[:, _YAW] = boxes_real[:, 7]
    init_mean[:, 4:7] = boxes_real[:, 4:7]

    mean = _put_rows(mean, target, init_mean)
    cov = _put_rows(cov, target, _consts(dev)["P0"][None])
    score = _put_rows(score, target, scores)
    hits = _put_rows(hits, target, torch.ones((1,), dtype=torch.int32, device=dev))
    misses = _put_rows(misses, target, torch.zeros((1,), dtype=torch.int32, device=dev))
    cls = _put_rows(state.cls, target, det_cls)
    track_id = _put_rows(state.track_id, target, state.next_id + birth_rank)
    alive = _put_rows(alive, target, torch.ones((1,), dtype=torch.bool, device=dev))
    next_id = state.next_id + can_place.to(torch.int32).sum(dtype=torch.int32)

    new_state = TrackState(mean=mean, cov=cov, alive=alive, track_id=track_id, cls=cls,
                           score=score, hits=hits, misses=misses, next_id=next_id)
    out_boxes = torch.cat([cls[:, None].to(torch.float32), mean[:, 0:3], mean[:, 4:7],
                           mean[:, _YAW:_YAW + 1]], -1)
    outputs = {
        "ids": track_id,
        "boxes": out_boxes,
        "scores": score,
        "velocities": mean[:, _VEL],
        "alive": alive,
        "confirmed": alive & (hits >= min_hits),
    }
    return new_state, outputs


def track_sequence(
    boxes_seq,  # (F, K, 8)
    scores_seq,  # (F, K)
    valid_seq,  # (F, K) bool
    *,
    max_tracks: int = 64,
    iou_min: float = 0.01,
    max_age: int = 3,
    min_hits: int = 2,
    device: Device = None,
) -> Dict[str, torch.Tensor]:
    """Track a whole detection sequence on `device` (default cuda; raises
    without a GPU unless device="cpu"): one `tracker_step` a frame. Returns
    the per-frame outputs stacked on a leading F axis."""
    state = init_tracks(max_tracks, device)
    dev = state.device
    boxes_seq = _to(boxes_seq, torch.float32, dev)
    scores_seq = _to(scores_seq, torch.float32, dev)
    valid_seq = _to(valid_seq, torch.bool, dev)
    outs = []
    for f in range(boxes_seq.shape[0]):
        state, out = tracker_step(state, boxes_seq[f], scores_seq[f], valid_seq[f],
                                  iou_min=iou_min, max_age=max_age, min_hits=min_hits)
        outs.append(out)
    return {key: torch.stack([o[key] for o in outs]) for key in outs[0]} if outs else {}
