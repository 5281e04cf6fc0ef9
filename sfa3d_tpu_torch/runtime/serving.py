"""Batched serving runtime of the port, the counterpart of
`sfa3d_tpu/runtime/serving.py`.

Concurrent callers submit single frames; the server coalesces them into
device batches, trading up to `max_delay_ms` of latency for a fuller
batch. Batches run at power-of-two bucket sizes capped at `max_batch`;
short batches are zero-padded and the padding frames cost callers nothing.

    server = BatchingDetectorServer(Detector(), max_batch=8)
    fut = server.submit(points)          # concurrent.futures.Future
    dets = fut.result()                  # list of detection dicts
    server.stop()

    server = BatchingFusedServer(FusedDetector(imgsz=(224, 640)), max_batch=8)
    fut = server.submit_fused(points, image_rgb, calib)
    reply = fut.result()                 # FusedDetector.detect's dict

Both servers also run over exported programs (`detector.py::
ArtifactDetector`, `ArtifactFusedDetector`): the point budget comes from
the artifact, a fixed-batch artifact pads every batch to its one size
(max_batch is clamped to it), and a fused artifact refuses at submit a
frame whose size is not the baked `img_hw`.

Threading model: ONE dispatch thread makes every device call; request
threads only prepare their frame on the host (scan filter and pad, and the
letterbox for the fused server, on the caller's thread), enqueue it and
wait on the future.
"""

from __future__ import annotations

import queue
import sys
import threading
import time
from concurrent.futures import Future
from typing import Dict

import numpy as np

from sfa3d_tpu_torch import native
from sfa3d_tpu_torch.config import kitti as cnf
from sfa3d_tpu_torch.detector import format_detections, fused_reply
from sfa3d_tpu_torch.ops.bev import filter_and_pad_points


def read_scan_filtered(velodyne_bin: str, max_points: int):
    """A velodyne `.bin` scan -> the padded (max_points, 4) points and
    mask that `filter_and_pad_points` gives: the native fused read, filter
    and pad (the raw scan is never materialised; it raises for an
    unreadable or malformed file, where JAX's servers fall back to numpy),
    or with SFA3D_TPU_NO_NATIVE numpy's read and the filter."""
    native.note_path()
    if native.enabled():
        return native.read_velodyne_filtered(velodyne_bin, max_points, cnf.boundary)
    points = np.fromfile(velodyne_bin, dtype=np.float32).reshape(-1, 4)
    return filter_and_pad_points(points, max_points=max_points)


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class BatchingDetectorServer:
    """Dynamic batcher around a `Detector` (LiDAR-only path)."""

    def __init__(self, detector, max_batch: int = 8, max_delay_ms: float = 5.0):
        self.det = detector
        # an artifact carries its export-time point budget; live detectors
        # take the production constant
        self._P = getattr(detector, "max_points", cnf.MAX_POINTS_FILTERED)
        # a fixed-batch artifact runs exactly one batch size: every bucket
        # is padded to it, and max_batch cannot exceed it
        self._fixed_bucket = getattr(detector, "fixed_batch", None)
        if self._fixed_bucket is not None and max_batch > self._fixed_bucket:
            print(
                f"serving: clamping max_batch {max_batch} -> "
                f"{self._fixed_bucket} (fixed-batch artifact)",
                file=sys.stderr,
            )
            max_batch = self._fixed_bucket
        self.max_batch = max(1, int(max_batch))
        self.max_delay_s = max_delay_ms / 1000.0
        self._q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        # serializes submit()'s (check stopped, enqueue) against stop()'s
        # (mark stopped, final drain), so no future is left unresolved
        self._submit_lock = threading.Lock()
        # serializes warmup()'s device calls against the dispatch thread's
        self._device_lock = threading.Lock()
        # served = requests answered; batches = device calls;
        # padded = zero frames added to reach the bucket size
        self.stats: Dict[str, int] = {"served": 0, "batches": 0, "padded": 0}
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="serving-dispatch"
        )
        self._thread.start()

    # -- client API -------------------------------------------------------
    def submit(self, points: np.ndarray) -> Future:
        """(N, 4) raw velodyne scan -> Future of a detection-dict list."""
        pts, valid = filter_and_pad_points(points, max_points=self._P)
        return self._enqueue(pts, valid)

    def _enqueue(self, pts, valid) -> Future:
        fut: Future = Future()
        with self._submit_lock:
            if self._stop.is_set():
                raise RuntimeError("server stopped")
            self._q.put((pts, valid, fut))
        return fut

    def submit_file(self, velodyne_bin: str) -> Future:
        """Request from a `.bin` scan path (`read_scan_filtered`)."""
        return self._enqueue(*read_scan_filtered(velodyne_bin, self._P))

    def buckets(self):
        """Every batch size the server runs: a fixed-batch artifact's one
        size, else powers of two below max_batch, plus max_batch itself."""
        if self._fixed_bucket is not None:
            return [self._fixed_bucket]
        out, b = [], 1
        while b < self.max_batch:
            out.append(b)
            b *= 2
        return out + [self.max_batch]

    def warmup(self):
        """Run one zero batch at every bucket size before traffic arrives,
        so first-use costs (kernel build, cuDNN plans, allocator growth) do
        not land on a request. Safe while traffic flows: warm calls
        serialize with dispatch on the device lock."""
        for b in self.buckets():
            with self._device_lock:
                self._warm_bucket(b)

    def _warm_bucket(self, bucket: int):
        self.det.detect_batch(
            np.zeros((bucket, self._P, 4), np.float32), np.zeros((bucket, self._P), bool)
        )

    def stop(self, timeout: float = 60.0):
        """Drain in-flight work, then stop the dispatch thread. Requests
        still queued when the thread has not retired within `timeout`
        seconds (None waits without limit) are cancelled, never left
        hanging."""
        self._q.put(None)  # sentinel: finish everything queued before it
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            print(
                f"serving: dispatch thread still busy after {timeout}s; "
                "cancelling queued requests",
                file=sys.stderr,
            )
        with self._submit_lock:
            self._stop.set()
            cancelled = 0
            while True:
                try:
                    item = self._q.get_nowait()
                except queue.Empty:
                    break
                if item is not None:
                    item[2].cancel()
                    cancelled += 1
            if cancelled:
                self.stats["cancelled"] = self.stats.get("cancelled", 0) + cancelled
                print(f"serving: cancelled {cancelled} queued request(s) at stop",
                      file=sys.stderr)

    # -- dispatch thread ---------------------------------------------------
    def _loop(self):
        while True:
            try:
                item = self._q.get(timeout=0.05)
            except queue.Empty:
                if self._stop.is_set():
                    return
                continue
            if item is None:
                return
            batch = [item]
            deadline = time.monotonic() + self.max_delay_s
            sentinel_seen = False
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                try:
                    # past the deadline a non-blocking drain still takes
                    # whatever is already queued: no latency, fuller bucket
                    nxt = (self._q.get(timeout=remaining) if remaining > 0
                           else self._q.get_nowait())
                except queue.Empty:
                    break
                if nxt is None:
                    sentinel_seen = True
                    break
                batch.append(nxt)
            try:
                with self._device_lock:
                    self._run_batch(batch)
            except BaseException as e:  # the boundary that must keep serving: every exception reaches the callers
                for _, _, fut in batch:
                    if not fut.done():
                        fut.set_exception(e)
            if sentinel_seen:
                return

    def _bucket(self, n: int) -> int:
        """The batch size that runs n requests: a fixed-batch artifact's one
        size, else the next power of two capped at max_batch."""
        if self._fixed_bucket is not None:
            return self._fixed_bucket
        return min(_next_pow2(n), self.max_batch)

    def _run_batch(self, batch):
        n = len(batch)
        bucket = self._bucket(n)
        P = batch[0][0].shape[0]
        pts = np.zeros((bucket, P, 4), np.float32)
        valid = np.zeros((bucket, P), bool)
        for i, (p, v, _) in enumerate(batch):
            pts[i], valid[i] = p, v
        out = self.det.detect_batch(pts, valid)
        for i, (_, _, fut) in enumerate(batch):
            fut.set_result(format_detections(out, i))
        self.stats["served"] += n
        self.stats["batches"] += 1
        self.stats["padded"] += bucket - n


class BatchingFusedServer(BatchingDetectorServer):
    """Dynamic batcher over the camera + LiDAR fusion program
    (`FusedDetector`, `fusion/batch.py`).

    submit_fused(points, image_rgb, calib) -> Future of the
    FusedDetector.detect reply. The scan filter and the letterbox run on the
    caller's thread; only the batched program runs on the dispatch thread.
    """

    def __init__(self, fused_detector, max_batch: int = 8, max_delay_ms: float = 5.0):
        self.fd = fused_detector
        super().__init__(detector=fused_detector, max_batch=max_batch,
                         max_delay_ms=max_delay_ms)

    def submit(self, points):
        raise TypeError("BatchingFusedServer needs submit_fused(points, image, calib)")

    def submit_file(self, velodyne_bin):
        raise TypeError("BatchingFusedServer needs submit_fused_file(path, image, calib)")

    def submit_fused(self, points: np.ndarray, image_rgb: np.ndarray, calib) -> Future:
        """(N, 4) raw scan + 0-255 RGB image (the letterbox normalizes) +
        calibration -> Future of the FusedDetector.detect reply."""
        pts, valid = filter_and_pad_points(points, max_points=self._P)
        return self._enqueue_fused(pts, valid, image_rgb, calib)

    def submit_fused_file(self, velodyne_bin: str, image_rgb: np.ndarray, calib) -> Future:
        """Fused request from a `.bin` scan path (`read_scan_filtered`)."""
        pts, valid = read_scan_filtered(velodyne_bin, self._P)
        return self._enqueue_fused(pts, valid, image_rgb, calib)

    def _enqueue_fused(self, pts, valid, image_rgb, calib) -> Future:
        from sfa3d_tpu_torch.models.yolov8 import letterbox

        h, w = image_rgb.shape[:2]
        baked_hw = getattr(self.fd, "img_hw", None)
        if baked_hw is not None and (h, w) != tuple(baked_hw):
            # an artifact bakes the letterbox geometry; a frame of another
            # size would be projected wrongly without a word
            raise ValueError(
                f"frame is {h}x{w} but the fused artifact bakes img_hw="
                f"{list(baked_hw)}; re-export for this camera"
            )
        img, r, (pad_w, pad_h) = letterbox(image_rgb, self.fd.imgsz)
        req = dict(
            pts=pts, valid=valid, img=img,
            V2C=np.asarray(calib.V2C, np.float32),
            R0=np.asarray(calib.R0, np.float32),
            P2=np.asarray(calib.P2, np.float32),
            hw=np.float32([h, w]), scale=np.float32(r),
            pad=np.float32([pad_w, pad_h]),
        )
        return self._enqueue(req, None)

    def _warm_bucket(self, bucket: int):
        # the detector's own canvas (h, w); an int imgsz is square
        imgsz = self.fd.imgsz
        ch, cw = (imgsz, imgsz) if isinstance(imgsz, int) else imgsz
        self.fd.run_batch(
            np.zeros((bucket, self._P, 4), np.float32),
            np.zeros((bucket, self._P), bool),
            np.zeros((bucket, ch, cw, 3), np.float32),
            np.zeros((bucket, 3, 4), np.float32),
            np.zeros((bucket, 3, 3), np.float32),
            np.zeros((bucket, 3, 4), np.float32),
            np.ones((bucket, 2), np.float32),
            np.ones((bucket,), np.float32),
            np.zeros((bucket, 2), np.float32),
        )

    def _run_batch(self, batch):
        n = len(batch)
        bucket = self._bucket(n)
        reqs = [req for req, _, _ in batch]

        def stack(key, fill=None):
            pad = np.zeros_like(reqs[0][key]) if fill is None else fill
            return np.stack([r[key] for r in reqs] + [pad] * (bucket - n))

        out = self.fd.run_batch(
            stack("pts"), stack("valid"), stack("img"), stack("V2C"), stack("R0"),
            stack("P2"), stack("hw"), stack("scale", np.float32(1.0)), stack("pad"),
        )
        for i, (_, _, fut) in enumerate(batch):
            fut.set_result(fused_reply(out, i))
        self.stats["served"] += n
        self.stats["batches"] += 1
        self.stats["padded"] += bucket - n
