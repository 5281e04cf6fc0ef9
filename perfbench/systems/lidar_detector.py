"""The served LiDAR path of the port: `sfa3d_tpu_torch.Detector` behind
`runtime/serving.py::BatchingDetectorServer`, built from a configuration.

The detector's network takes the seed's weights (`harness/weights.py`);
the server calls it through `DeviceCalls`, a thin proxy that records one
span a device call (`device_call`, sized by the batch). A request is a raw
scan; the reply, a list of detection dicts, is kept as (n, 9) rows [class,
score, x, y, z, h, w, l, yaw] for the comparison.
"""

from __future__ import annotations

import threading
from typing import Dict, List

import numpy as np
import torch

from perfbench.harness.spans import Spans
from perfbench.harness.weights import seeded_state
from perfbench.reference import kfpn as ref_kfpn
from perfbench.reference import lidar as ref_lidar

DETECTION_KEYS = ("class_id", "score", "x", "y", "z", "h", "w", "l", "yaw")
WARM_ROUNDS = 2  # device calls a warmed bucket has run on the serving thread
WARM_TIMEOUT_S = 600.0


class DeviceCalls:
    """Forwards everything to the detector; times each detect_batch."""

    def __init__(self, target, spans: Spans):
        self._target = target
        self._spans = spans

    def detect_batch(self, pts, valid):
        frames = int(np.asarray(valid).any(axis=1).sum())
        with self._spans.span("device_call", bucket=len(pts), frames=frames):
            return self._target.detect_batch(pts, valid)

    def __getattr__(self, name):
        return getattr(self._target, name)


def kfpn_state(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    template = ref_kfpn.KFPN(cfg["num_layers"], cfg["head_conv"]).state_dict()
    return seeded_state(template, seed, device, cfg["conditioning"])


class System:
    def __init__(self, cfg: dict, seed: int, device, spans: Spans):
        from sfa3d_tpu_torch.detector import Detector
        from sfa3d_tpu_torch.runtime.serving import BatchingDetectorServer

        self.cfg, self.spans, self.device = cfg, spans, torch.device(device)
        det = Detector(arch=cfg["arch"], K=cfg["K"], peak_thresh=cfg["peak_thresh"],
                       dtype=cfg["dtype"], device=self.device)
        det.model.load_state_dict(kfpn_state(cfg, seed, self.device), strict=True)
        self.detector = DeviceCalls(det, spans)
        serving = cfg["serving"]
        self.server = BatchingDetectorServer(self.detector, max_batch=serving["max_batch"],
                                             max_delay_ms=serving["max_delay_ms"])

    def buckets(self) -> List[int]:
        return self.server.buckets()

    def warm(self, buckets: List[int], request) -> None:
        """Each bucket served WARM_ROUNDS times through the server, so on the
        thread that serves the window: PyTorch keeps cuDNN's execution plans
        and the cuBLAS handle per thread, and a bucket first run on another
        thread pays them again inside the window. The callers' host path
        (its native range filter, built and loaded on first use) is warmed
        by the same submits."""
        for b in buckets:
            for _ in range(WARM_ROUNDS * 4):
                if self._served_at(b) >= WARM_ROUNDS:
                    break
                self._serve_together(b, request)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _served_at(self, bucket: int) -> int:
        return sum(1 for s in self.spans.of("device_call") if s[3]["bucket"] == bucket)

    def _serve_together(self, n: int, request) -> None:
        """n requests submitted at once from n threads, so that the server
        takes them as one batch of the bucket n fills; waits for each."""
        gate = threading.Barrier(n)
        futs = [None] * n

        def send(i):
            gate.wait()
            futs[i] = self.server.submit(request)

        threads = [threading.Thread(target=send, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for f in futs:
            f.result(timeout=WARM_TIMEOUT_S)

    def pool(self, seed: int, n: int) -> list:
        return ref_lidar.frames(self.cfg, seed, n)

    def submit(self, request):
        with self.spans.span("submit"):
            return self.server.submit(request)

    @staticmethod
    def compact(reply) -> np.ndarray:
        return np.asarray([[d[k] for k in DETECTION_KEYS] for d in reply], np.float64).reshape(-1, 9)

    def counters(self) -> Dict[str, int]:
        return dict(self.server.stats)

    def stop(self) -> None:
        self.server.stop()
