"""Serving entry point of the port, the counterpart of `sfa3d_tpu/cli/serve.py`:
line-delimited JSON requests over stdio or TCP, answered by the batching
servers (`runtime/serving.py`).

    python -m sfa3d_tpu_torch.cli.serve [--pretrained_path CKPT.pth | --artifact PATH]
        [--port 8471] [--max_batch 8] [--max_delay_ms 5] [--track] [--fused] [--platform cpu]

Protocol (one JSON object per line):
  request:  {"id": <any>, "lidar": "/path/to/scan.bin"}
        or  {"id": <any>, "points": [[x, y, z, r], ...]}
  response: {"id": <any>, "detections": [{class_name, score, x, y, z, h, w,
             l, yaw, class_id}, ...]}
  error:    {"id": <any>, "error": "..."}

With --fused the server runs the camera + LiDAR fusion program, and
requests carry the camera frame (a PNG file, read with `data/png.py`) and
calibration:
  request:  {"id": <any>, "lidar": "scan.bin", "image": "frame.png",
             "calib": "calib.txt"}   (calib omitted -> dataset mean)
  response: {"id": <any>, "fused": {"boxes": [[x,y,w,h],...], "scores":
             [...], "classes": [...], "source": [...]},
             "boxes_3d": [[cls,x,y,z,h,w,l,yaw], ...]}

With --track the server keeps per-stream 3D tracking state
(`runtime/tracking_service.py`, on the detector's device): replies gain
"stream" and "tracks" (stable track_id, Kalman-smoothed box, velocity in m
a frame). Requests may carry "stream": <key> (default: one stream per
connection) and "track_reset": true on a scene cut; frames of one stream
must arrive in order on one connection.

TCP mode (--port; 0 picks a free port) takes many connections at once, and
their requests coalesce into shared device batches. Replies on a
connection come in request order. It runs on cuda (raising without a GPU)
unless --platform cpu is given. --compilation_cache (an XLA cache) is a
JAX-only option and raises.

With --artifact PATH the server runs an exported program (`cli export`,
`runtime/export.py`): a detector artifact backs the LiDAR server, a fused
one the fusion server (requests then carry image and calibration); the
flags that pick the model (--pretrained_path, --arch, --K, --peak_thresh,
--dtype) are ignored with a warning, since the artifact bakes its own. A
fixed-batch artifact is served by padding every batch to its size. The
artifact runs on the device it was exported on, which must be the one
asked for (cuda, or cpu with --platform cpu).
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
from concurrent.futures import Future


def _parse(argv):
    p = argparse.ArgumentParser("serve")
    p.add_argument("--pretrained_path", default=None,
                   help="torch .pth checkpoint (random init if absent)")
    p.add_argument("--arch", default="fpn_resnet_18")
    p.add_argument("--K", type=int, default=50)
    p.add_argument("--peak_thresh", type=float, default=0.2)
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--max_batch", type=int, default=8)
    p.add_argument("--max_delay_ms", type=float, default=5.0)
    p.add_argument("--port", type=int, default=None,
                   help="TCP port; omit for stdin/stdout mode")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--platform", default=None, choices=["cpu", "cuda"],
                   help="'cpu' runs on the CPU; the default is cuda")
    p.add_argument("--compilation_cache", default=None, metavar="DIR", nargs="?", const="",
                   help="JAX only (an XLA executable cache); raises here")
    p.add_argument("--fused", action="store_true",
                   help="serve the camera + LiDAR fusion program")
    p.add_argument("--yolo_checkpoint", default=None,
                   help="ultralytics-layout .pt for the fused 2D branch")
    p.add_argument("--warmup", action="store_true",
                   help="run every batch bucket once before accepting traffic")
    p.add_argument("--artifact", default=None, metavar="PATH",
                   help="serve an exported program (`cli export`): its manifest's kind picks "
                        "the LiDAR or the fused server; the model flags are ignored")
    p.add_argument("--track", action="store_true",
                   help="stateful per-stream 3D tracking: replies gain a 'tracks' list "
                        "with stable track ids and velocities. Requests may set 'stream' "
                        "(default: one stream per connection) and 'track_reset': true on "
                        "a scene cut. LiDAR detector mode only.")
    p.add_argument("--track_min_hits", type=int, default=2)
    p.add_argument("--track_max_age", type=int, default=3)
    p.add_argument("--track_iou_min", type=float, default=0.01)
    p.add_argument("--track_coasting", action="store_true",
                   help="also report unconfirmed and coasting tracks")
    args = p.parse_args(argv)
    if args.compilation_cache is not None:
        raise NotImplementedError("--compilation_cache is an XLA cache; sfa3d_tpu_torch compiles nothing ahead")
    return args


def read_image(path: str):
    """A request's camera frame -> (H, W, 3) RGB uint8. The port reads PNG
    only (data/png.py); the JAX CLI reads any format cv2 does."""
    from sfa3d_tpu_torch.data.png import read_png_rgb

    try:
        return read_png_rgb(path)
    except ValueError as e:
        raise ValueError(f"image {path}: {e} (sfa3d_tpu_torch serve --fused reads PNG frames only)") from None


def _submit(server, req):
    from sfa3d_tpu_torch.runtime.serving import BatchingFusedServer

    if isinstance(server, BatchingFusedServer):
        return _submit_fused(server, req)
    if "lidar" in req:
        return server.submit_file(req["lidar"])
    import numpy as np

    pts = np.asarray(req["points"], np.float32).reshape(-1, 4)
    return server.submit(pts)


def _submit_fused(server, req):
    import numpy as np

    from sfa3d_tpu_torch.geometry.calibration import KittiCalibration

    img = read_image(req["image"])  # 0-255 RGB: the letterbox normalizes itself
    calib = KittiCalibration(req.get("calib"))
    if "lidar" in req:
        fut = server.submit_fused_file(req["lidar"], img, calib)
    else:
        pts = np.asarray(req["points"], np.float32).reshape(-1, 4)
        fut = server.submit_fused(pts, img, calib)
    # re-shape the resolved dict into the wire format
    wire: Future = Future()

    def relay(f):
        try:
            r = f.result()
            wire.set_result({
                "fused": {
                    "boxes": r["boxes"].tolist(),
                    "scores": np.round(r["scores"], 6).tolist(),
                    "classes": r["classes"].tolist(),
                    "source": r["source"].tolist(),
                },
                "boxes_3d": np.round(r["boxes_3d"], 6).tolist(),
            })
        except BaseException as e:
            wire.set_exception(e)

    fut.add_done_callback(relay)
    return wire


def _handle_stream(server, rfile, wfile, lock=None, sessions=None, conn_name="stdio"):
    """One client. The reader (this function) only parses lines and
    submits, so every pending request is in flight at once and a burst from
    one client fills a device batch. A writer thread resolves the futures in
    request order and writes the replies; a reply never waits for further
    input. With `sessions` (a TrackingSessions) the writer also advances the
    request's tracker stream: writer order is request order, the frame
    order tracking needs. `track_reset` rides the queue with its request
    and the writer applies it, so a scene cut lands in request order too."""
    import queue

    out_q: "queue.Queue" = queue.Queue()

    def writer():
        while True:
            item = out_q.get()
            if item is None:
                return
            _reply(wfile, *item, lock=lock, sessions=sessions)

    t = threading.Thread(target=writer, daemon=True, name="serve-writer")
    t.start()
    try:
        for line in rfile:
            line = line.strip()
            if not line:
                continue
            rid, stream, reset = None, None, False
            try:
                req = json.loads(line)
                rid = req.get("id")
                stream = str(req.get("stream", conn_name))
                reset = bool(req.get("track_reset"))
                out_q.put((rid, _submit(server, req), stream, reset))
            except Exception as e:
                out_q.put((rid, e, stream, reset))
    finally:
        out_q.put(None)
        t.join()


def _reply(wfile, rid, fut_or_err, stream=None, reset=False, lock=None, sessions=None):
    from concurrent.futures import CancelledError

    # the scene cut applies here, in request order, even when the request
    # itself fails: the client declared the frame history invalid either way
    if sessions is not None and reset and stream is not None:
        sessions.reset(stream)
    if isinstance(fut_or_err, Exception):
        msg = {"id": rid, "error": str(fut_or_err)}
    else:
        try:
            res = fut_or_err.result()
            # fused results arrive shaped for the wire ({"fused": ...}); the
            # LiDAR path returns the detection list
            msg = {"id": rid, **res} if isinstance(res, dict) else {"id": rid, "detections": res}
            if sessions is not None and not isinstance(res, dict):
                msg["stream"] = stream
                msg["tracks"] = sessions.update(stream, res)
        except CancelledError:
            # server.stop() cancels queued requests; CancelledError is a
            # BaseException, which `except Exception` would let kill this
            # writer and drop every later reply
            msg = {"id": rid, "error": "cancelled"}
        except Exception as e:
            msg = {"id": rid, "error": str(e)}
    data = json.dumps(msg) + "\n"
    if lock:
        with lock:
            wfile.write(data)
            wfile.flush()
    else:
        wfile.write(data)
        wfile.flush()


def build_server(args):
    """The batching server (and TrackingSessions with --track) the flags
    ask for, on cuda unless --platform cpu."""
    from sfa3d_tpu_torch.detector import Detector, FusedDetector
    from sfa3d_tpu_torch.runtime.export import read_manifest
    from sfa3d_tpu_torch.runtime.serving import BatchingDetectorServer, BatchingFusedServer

    manifest = read_manifest(args.artifact) if args.artifact else {}
    device = "cpu" if args.platform == "cpu" else None
    if args.track and (args.fused or manifest.get("kind") == "fused"):
        raise SystemExit(
            "--track supports the LiDAR detector server only (fused replies carry 2D "
            "fusion output, not 3D boxes in tracker layout)")
    if args.artifact:
        server = _artifact_server(args, manifest)
    elif args.fused:
        fd = FusedDetector(arch=args.arch, checkpoint=args.pretrained_path,
                           yolo_checkpoint=args.yolo_checkpoint, K=args.K,
                           peak_thresh=args.peak_thresh, dtype=args.dtype, device=device)
        server = BatchingFusedServer(fd, max_batch=args.max_batch, max_delay_ms=args.max_delay_ms)
    else:
        det = Detector(arch=args.arch, checkpoint=args.pretrained_path, K=args.K,
                       peak_thresh=args.peak_thresh, dtype=args.dtype, device=device)
        server = BatchingDetectorServer(det, max_batch=args.max_batch, max_delay_ms=args.max_delay_ms)
    sessions = None
    if args.track:
        from sfa3d_tpu_torch.runtime.tracking_service import TrackingSessions

        # capacity follows the backing detector's K (an artifact's own K,
        # whatever --K says)
        sessions = TrackingSessions(
            K=server.det.K, min_hits=args.track_min_hits, max_age=args.track_max_age,
            iou_min=args.track_iou_min, include_coasting=args.track_coasting,
            device=server.det.device)
    return server, sessions


def _artifact_server(args, manifest):
    """The batching server over the artifact at args.artifact, dispatched on
    its `manifest`'s kind, as the JAX CLI does."""
    from sfa3d_tpu_torch.detector import ArtifactDetector, ArtifactFusedDetector
    from sfa3d_tpu_torch.runtime.serving import BatchingDetectorServer, BatchingFusedServer

    # the artifact bakes the model, K and peak_thresh: the flags that would
    # pick them are dead here, so say so
    ignored = [f for f, v in [
        ("--pretrained_path", args.pretrained_path),
        ("--arch", args.arch if args.arch != "fpn_resnet_18" else None),
        ("--K", args.K if args.K != 50 else None),
        ("--peak_thresh", args.peak_thresh if args.peak_thresh != 0.2 else None),
        ("--dtype", args.dtype if args.dtype != "float32" else None),
    ] if v is not None]
    for flag in ignored:
        print(f"serving: {flag} is IGNORED with --artifact — the value baked into the "
              "artifact manifest applies (re-export to change it)", file=sys.stderr)
    platform = args.platform or "cuda"
    if manifest.get("platforms") != [platform]:
        raise SystemExit(
            f"{args.artifact} was exported for {manifest.get('platforms')}; it cannot run on "
            f"{platform} (re-export with --platform {platform})")
    kind = manifest.get("kind")
    if kind == "fused":
        return BatchingFusedServer(ArtifactFusedDetector(args.artifact), max_batch=args.max_batch,
                                   max_delay_ms=args.max_delay_ms)
    if args.fused:
        raise SystemExit(
            f"--fused needs a fused artifact; {args.artifact} is kind={kind!r} "
            "(export with `cli export --fused`)")
    return BatchingDetectorServer(ArtifactDetector(args.artifact), max_batch=args.max_batch,
                                  max_delay_ms=args.max_delay_ms)


def main(argv=None, stdin=None, stdout=None, ready=None, stop=None):
    """Run the server. stdio mode reads `stdin` (default sys.stdin) and
    writes `stdout` until end of input. TCP mode serves until interrupted or
    until the `stop` Event is set; `ready`, a callable, gets the bound port
    once the socket listens. Returns the server's stats."""
    args = _parse(argv)
    server, sessions = build_server(args)

    if args.port is None:
        try:
            if args.warmup:
                server.warmup()
            _handle_stream(server, stdin or sys.stdin, stdout or sys.stdout, sessions=sessions)
        finally:
            server.stop()
        print(json.dumps({"stats": server.stats}), file=sys.stderr)
        return server.stats

    import socket

    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    sock.bind((args.host, args.port))
    sock.listen(64)
    sock.settimeout(0.2)  # wakes the accept loop to look at `stop`
    port = sock.getsockname()[1]
    print(f"serving on {args.host}:{port}", file=sys.stderr, flush=True)
    if args.warmup:
        # bind first, so early clients wait in the listen backlog while the buckets warm
        server.warmup()
    if ready is not None:
        ready(port)

    conn_seq = iter(range(1 << 62))

    def client(conn, name):
        with conn:
            rfile = conn.makefile("r")
            wfile = conn.makefile("w")
            try:
                _handle_stream(server, rfile, wfile, lock=threading.Lock(),
                               sessions=sessions, conn_name=name)
            except (BrokenPipeError, ConnectionResetError):
                pass

    try:
        while stop is None or not stop.is_set():
            try:
                conn, _ = sock.accept()
            except socket.timeout:
                continue
            conn.settimeout(None)
            threading.Thread(target=client, args=(conn, f"conn-{next(conn_seq)}"), daemon=True).start()
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
        sock.close()
    return server.stats


if __name__ == "__main__":
    main()
