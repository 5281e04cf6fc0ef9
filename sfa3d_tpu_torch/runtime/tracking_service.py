"""Per-stream 3D multi-object tracking for the serving layer, the port of
`sfa3d_tpu/runtime/tracking_service.py`.

The batching servers (`runtime/serving.py`) answer every request as an
independent frame. A deployment that reads ordered frames from one or more
sensors wants identities back ("car 7 is still car 7, moving 1.1 m a
frame"). `TrackingSessions` adds that on top of the detection replies: one
fixed-slot Kalman tracker (`sfa3d_tpu_torch/tracking/`) per stream key,
advanced once a frame on the backing detector's device.

- Per-stream mutual exclusion through a fixed pool of striped locks
  indexed by the stream key's hash: tracker state is the one piece of
  order-dependent state in the server. A per-stream lock dict would grow
  without bound or have to drop locks on eviction, and dropping a lock
  another thread holds breaks the exclusion. Frames of one stream must
  arrive in order on one connection; the serve CLI's writer thread updates
  the tracker in request order.
- Bounded memory: streams beyond `max_streams` are evicted least recently
  used first. An evicted stream that returns restarts with a fresh tracker
  whose ids resume from a service-wide floor (the largest next_id ever
  evicted), so a track id is never reused within one logical stream.
- A tracker step is a few dozen small launches and one `track_associate`
  kernel launch; its only host copies are this layer's (the frame's
  detections in, the slots' outputs out).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, List

import numpy as np
import torch

from sfa3d_tpu_torch.config import kitti as cnf
from sfa3d_tpu_torch.device import Device, resolve_device
from sfa3d_tpu_torch.tracking import TrackState, init_tracks, tracker_step


class TrackingSessions:
    """stream key -> tracker state; `update` advances one stream by one
    frame of detection dicts (the `detector.format_detections` layout) and
    returns the confirmed tracks as wire-ready dicts. States live on
    `device` (default cuda; raises without a GPU unless device="cpu")."""

    def __init__(
        self,
        K: int = 50,
        max_tracks: int = 64,
        iou_min: float = 0.01,
        max_age: int = 3,
        min_hits: int = 2,
        max_streams: int = 256,
        include_coasting: bool = False,
        lock_stripes: int = 64,
        device: Device = None,
    ):
        self.K = int(K)
        self.max_tracks = int(max_tracks)
        self.max_streams = int(max_streams)
        self.include_coasting = bool(include_coasting)
        self.device = resolve_device(device)
        self._step_kw = dict(iou_min=iou_min, max_age=max_age, min_hits=min_hits)
        self._states: "OrderedDict[str, TrackState]" = OrderedDict()
        self._lock_pool = [threading.Lock() for _ in range(lock_stripes)]
        self._registry = threading.Lock()  # guards _states and _id_floor
        # the largest next_id ever evicted: a returning evicted stream
        # resumes its ids from here, never from 0
        self._id_floor = 0

    def _fresh(self, next_id) -> TrackState:
        state = init_tracks(self.max_tracks, self.device)
        return state.replace(next_id=torch.as_tensor(next_id, dtype=torch.int32).to(self.device))

    # -- stream registry --------------------------------------------------
    def _acquire(self, stream: str) -> threading.Lock:
        return self._lock_pool[hash(stream) % len(self._lock_pool)]

    def reset(self, stream: str) -> None:
        """Drop a stream's tracks (scene cut, new recording). The id counter
        carries over: tracks after the cut get fresh ids, so no track id
        spans two scenes."""
        with self._registry:
            old = self._states.pop(stream, None)
            if old is not None:
                self._states[stream] = self._fresh(old.next_id)

    def _get_state(self, stream: str) -> TrackState:
        with self._registry:
            if stream in self._states:
                self._states.move_to_end(stream)
                return self._states[stream]
            floor = self._id_floor
        return self._fresh(floor)

    def _put_state(self, stream: str, state: TrackState) -> None:
        evicted = []
        with self._registry:
            self._states[stream] = state
            self._states.move_to_end(stream)
            while len(self._states) > self.max_streams:
                evicted.append(self._states.popitem(last=False)[1])
        # read the evicted counters outside the registry lock (a device to
        # host copy, only on eviction) and raise the id floor past them
        if evicted:
            high = max(int(s.next_id) for s in evicted)
            with self._registry:
                self._id_floor = max(self._id_floor, high)

    @property
    def n_streams(self) -> int:
        with self._registry:
            return len(self._states)

    # -- the frame step ----------------------------------------------------
    def update(self, stream: str, detections: List[Dict]) -> List[Dict]:
        """Advance `stream` by one frame. `detections` is the detection-dict
        list a server future resolves to; returns the track list for the
        wire. The caller's order is the frame order."""
        boxes = np.zeros((self.K, 8), np.float32)
        scores = np.zeros((self.K,), np.float32)
        valid = np.zeros((self.K,), bool)
        dets = sorted(detections, key=lambda d: -d["score"])[: self.K]
        for i, d in enumerate(dets):
            boxes[i] = [d["class_id"], d["x"], d["y"], d["z"], d["h"], d["w"], d["l"], d["yaw"]]
            scores[i] = d["score"]
            valid[i] = True

        with self._acquire(stream):
            state = self._get_state(stream)
            state, out = tracker_step(state, boxes, scores, valid, **self._step_kw)
            self._put_state(stream, state)

        out = {k: v.cpu().numpy() for k, v in out.items()}
        which = out["alive"] if self.include_coasting else out["confirmed"]
        tracks = []
        for t in np.nonzero(which)[0]:
            row = out["boxes"][t]
            cls = int(row[0])
            tracks.append({
                "track_id": int(out["ids"][t]),
                "class_id": cls,
                "class_name": cnf.ID_TO_CLASS_NAME.get(cls, str(cls)),
                "score": float(out["scores"][t]),
                "x": float(row[1]), "y": float(row[2]), "z": float(row[3]),
                "h": float(row[4]), "w": float(row[5]), "l": float(row[6]),
                "yaw": float(row[7]),
                "velocity": [round(float(v), 6) for v in out["velocities"][t][:2]],
                "confirmed": bool(out["confirmed"][t]),
            })
        return tracks
