"""The port's serving layer with tracking on the CPU: `TrackingSessions`
(mirroring tests/test_serving.py:269-326 and held against the JAX
`TrackingSessions` fed the same detections) and `python -m
sfa3d_tpu_torch.cli.serve` over stdio and TCP, with --track and --fused
(its --artifact path: tests/test_torch_export.py).

Tolerances: detections within DET_ATOL of the port's own `Detector.detect`
on the same checkpoint (the server runs padded batches of 1-8 frames, whose
convolutions may sum in another order than a batch of one); track ids, classes
and confirmed flags equal to JAX's; track boxes, scores and velocities
within TRACK_ATOL (float32 Kalman algebra in another order, see
tests/test_torch_tracking.py)."""

import io
import json
import socket
import threading

import numpy as np
import pytest
import torch

from sfa3d_tpu.runtime.tracking_service import TrackingSessions as JaxSessions
from sfa3d_tpu_torch.cli import serve
from sfa3d_tpu_torch.data.png import read_image_bgr, write_image_bgr, write_png_rgb
from sfa3d_tpu_torch.data.synthetic import synthetic_scene
from sfa3d_tpu_torch.detector import Detector, FusedDetector
from sfa3d_tpu_torch.geometry.calibration import KittiCalibration
from sfa3d_tpu_torch.runtime.tracking_service import TrackingSessions

TRACK_ATOL = 1e-5
DET_ATOL = 1e-4
FLOAT_KEYS = ("score", "x", "y", "z", "h", "w", "l", "yaw")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's side runs on one intra-op thread: in a loaded multi-worker
    run more threads only wait on each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _det(x, y, cls=1, score=0.9):
    return {"class_id": cls, "class_name": "Car", "score": score,
            "x": x, "y": y, "z": -1.0, "h": 1.5, "w": 1.6, "l": 3.9, "yaw": 0.0}


def assert_dets_close(got, want):
    """Detection lists equal in classes and count, boxes and scores within
    DET_ATOL (rows sorted by class, x, y)."""
    def rows(dets):
        r = np.asarray([[d["class_id"], d["x"], d["y"], d["z"], d["h"], d["w"], d["l"], d["yaw"], d["score"]]
                        for d in dets]).reshape(-1, 9)
        return r[np.lexsort((r[:, 2], r[:, 1], r[:, 0]))]

    assert len(got) == len(want)
    assert sorted(d["class_name"] for d in got) == sorted(d["class_name"] for d in want)
    np.testing.assert_allclose(rows(got), rows(want), rtol=0, atol=DET_ATOL)


def _sessions(**kw):
    return TrackingSessions(device="cpu", **kw)


def assert_tracks_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in ("track_id", "class_id", "class_name", "confirmed"):
            assert g[k] == w[k], k
        for k in FLOAT_KEYS:
            assert g[k] == pytest.approx(w[k], abs=TRACK_ATOL), k
        np.testing.assert_allclose(g["velocity"], w["velocity"], rtol=0, atol=TRACK_ATOL)


# ---------------------------------------------------------------------------
# TrackingSessions
# ---------------------------------------------------------------------------


def test_tracking_sessions_stable_ids_streams_isolated_and_reset():
    s = _sessions(K=8, max_tracks=16, min_hits=1)
    ids_a = []
    for f in range(4):
        tracks = s.update("a", [_det(10.0 + 0.5 * f, 0.0)])
        assert len(tracks) == 1
        ids_a.append(tracks[0]["track_id"])
    assert len(set(ids_a)) == 1
    t = s.update("a", [_det(12.0, 0.0)])[0]
    assert t["class_name"] == "Car" and t["confirmed"]
    assert abs(t["velocity"][0] - 0.5) < 0.3
    assert all(v == round(v, 6) for v in t["velocity"])
    assert len(s.update("b", [_det(10.0, 0.0)])) == 1
    assert s.n_streams == 2
    s.reset("a")
    re = s.update("a", [_det(12.5, 0.0)])
    assert re[0]["track_id"] not in ids_a


def test_tracking_sessions_lru_eviction_bounds_memory():
    s = _sessions(K=4, max_tracks=8, min_hits=1, max_streams=3)
    for i in range(5):
        s.update(f"s{i}", [_det(10.0, 0.0)])
    assert s.n_streams == 3


def test_tracking_sessions_evicted_stream_never_reuses_ids():
    s = _sessions(K=4, max_tracks=8, min_hits=1, max_streams=2)
    assert [t["track_id"] for t in s.update("cam", [_det(10.0, 0.0)])] == [0]
    s.update("other1", [_det(10.0, 0.0)])
    s.update("other2", [_det(10.0, 0.0)])
    assert s.n_streams == 2
    back = s.update("cam", [_det(50.0, 5.0)])
    assert back and all(t["track_id"] > 0 for t in back)


def test_tracking_sessions_state_stays_on_its_device():
    s = _sessions(K=4, max_tracks=8)
    s.update("a", [_det(10.0, 0.0)])
    state = s._states["a"]
    assert {getattr(state, f).device.type for f in ("mean", "cov", "alive", "next_id")} == {"cpu"}


def _frame_dets(rng, f, n=6):
    """Six cars moving 0.4 m a frame, jittered, plus a class-0 pedestrian
    and a low-score false positive; shuffled."""
    dets = [_det(8.0 + 4 * i + 0.4 * f + rng.normal(0, 0.05), -6.0 + 2.5 * i + rng.normal(0, 0.05),
                 cls=1, score=float(rng.uniform(0.5, 1.0))) for i in range(n)]
    dets.append(_det(20.0 - 0.2 * f, 8.0, cls=0, score=0.6))
    dets.append(_det(float(rng.uniform(0, 40)), float(rng.uniform(-20, 20)), cls=2, score=0.3))
    return [dets[i] for i in rng.permutation(len(dets))]


@pytest.mark.parametrize("coasting", [False, True])
def test_tracking_sessions_match_jax_sessions(coasting):
    """The same detection lists into both services, two streams, a reset
    and an eviction: equal wire dicts."""
    kw = dict(K=8, max_tracks=8, min_hits=2, max_age=2, max_streams=2, include_coasting=coasting)
    ours, ref = _sessions(**kw), JaxSessions(**kw)
    rng = np.random.default_rng(0)
    n_tracks = 0
    for f in range(10):
        for stream in (("a", "b") if f < 6 else ("a", "c")):
            dets = _frame_dets(rng, f) if f % 4 != 3 else []
            got, want = ours.update(stream, dets), ref.update(stream, dets)
            assert_tracks_equal(got, want)
            n_tracks += len(got)
        if f == 4:
            ours.reset("a")
            ref.reset("a")
    assert n_tracks > 50
    assert ours._id_floor == ref._id_floor > 0


def test_track_reset_applies_in_request_order():
    """A scene cut lands in request order: the writer applies the reset
    between the frames it answers, even when both frames' futures resolve
    after both requests were queued (tests/test_serving.py's case)."""
    import time
    from concurrent.futures import Future

    sessions = _sessions(K=4, max_tracks=8, min_hits=1)
    futs = []

    class FakeServer:
        def submit(self, pts):
            f = Future()
            futs.append(f)
            return f

    pts = [[0.0, 0.0, 0.0, 0.0]]
    rfile = io.StringIO(json.dumps({"id": 1, "stream": "cam", "points": pts}) + "\n"
                        + json.dumps({"id": 2, "stream": "cam", "points": pts, "track_reset": True}) + "\n")
    wfile = io.StringIO()
    t = threading.Thread(target=serve._handle_stream, args=(FakeServer(), rfile, wfile),
                         kwargs=dict(sessions=sessions), daemon=True)
    t.start()
    deadline = time.time() + 30
    while len(futs) < 2 and time.time() < deadline:
        time.sleep(0.01)
    assert len(futs) == 2, "both requests must be in flight before replies"
    futs[0].set_result([_det(10.0, 0.0)])
    futs[1].set_result([_det(10.0, 0.0)])
    t.join(timeout=60)
    assert not t.is_alive()
    by_id = {r["id"]: r for r in (json.loads(line) for line in wfile.getvalue().splitlines())}
    ids1 = {tr["track_id"] for tr in by_id[1]["tracks"]}
    ids2 = {tr["track_id"] for tr in by_id[2]["tracks"]}
    assert ids1 and ids2 and not ids1 & ids2, f"a track id crossed the scene cut: {ids1} {ids2}"


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A KFPN-18 .pth of the port's random init with the heatmap biases
    raised by 2.0, so random weights give detections, and car-sized boxes
    (the dim heads' biases raised by h, w, l = 1.5, 1.6, 3.9 m): random
    weights alone give millimetre boxes, whose IoUs with the tracks are
    float32 noise and near-ties that decide the association."""
    det = Detector(device="cpu", seed=0)
    sd = det.model.state_dict()
    for i in range(3):
        sd[f"fpn{i}_hm_cen.2.bias"] = sd[f"fpn{i}_hm_cen.2.bias"] + 2.0
        sd[f"fpn{i}_dim.2.bias"] = sd[f"fpn{i}_dim.2.bias"] + torch.tensor([1.5, 1.6, 3.9])
    path = tmp_path_factory.mktemp("ckpt") / "Model_fpn_resnet_18.pth"
    torch.save(sd, path)
    return str(path)


@pytest.fixture(scope="module")
def scans(tmp_path_factory):
    root = tmp_path_factory.mktemp("scans")
    out = []
    for seed in range(3):
        points, _ = synthetic_scene(seed=seed)
        path = root / f"{seed:06d}.bin"
        points.astype(np.float32).tofile(path)
        out.append((str(path), points))
    return out


def _run_stdio(argv, requests):
    stdin = io.StringIO("".join(json.dumps(r) + "\n" for r in requests))
    stdout = io.StringIO()
    stats = serve.main(argv + ["--platform", "cpu"], stdin=stdin, stdout=stdout)
    return [json.loads(line) for line in stdout.getvalue().splitlines()], stats


def test_serve_stdio_replies_in_order_equal_to_detector(checkpoint, scans):
    det = Detector(checkpoint=checkpoint, device="cpu")
    requests = [{"id": 1, "lidar": scans[0][0]}, {"id": "two", "points": scans[1][1][:4000].tolist()},
                {"id": 3, "lidar": "/nonexistent/scan.bin"}, {"id": 4, "lidar": scans[2][0]}]
    replies, stats = _run_stdio(["--pretrained_path", checkpoint, "--max_delay_ms", "50"], requests)
    assert [r["id"] for r in replies] == [1, "two", 3, 4]
    assert "error" in replies[2] and "detections" not in replies[2]
    assert_dets_close(replies[0]["detections"], det.detect(scans[0][1]))
    assert_dets_close(replies[1]["detections"], det.detect(scans[1][1][:4000]))
    assert_dets_close(replies[3]["detections"], det.detect(scans[2][1]))
    assert len(replies[0]["detections"]) > 0
    assert stats["served"] == 3


def test_serve_track_replies_equal_jax_sessions_fed_the_same_detections(checkpoint, scans):
    """--track: every reply's tracks equal the JAX TrackingSessions advanced
    with the same detection lists in the same order (stream per request,
    a reset in request order, a bad request in between)."""
    requests = []
    for f in range(4):
        for stream in ("cam0", "cam1"):
            requests.append({"id": f"{stream}-{f}", "lidar": scans[f % 2][0], "stream": stream})
    requests.insert(5, {"id": "bad", "stream": "cam0", "points": "not a list"})
    requests.append({"id": "cut", "lidar": scans[0][0], "stream": "cam0", "track_reset": True})
    argv = ["--pretrained_path", checkpoint, "--track", "--track_min_hits", "1", "--peak_thresh", "0.3"]
    replies, _ = _run_stdio(argv, requests)
    assert [r["id"] for r in replies] == [r["id"] for r in requests]
    ref = JaxSessions(K=50, min_hits=1)
    seen = {"cam0": set(), "cam1": set()}
    for req, rep in zip(requests, replies):
        if req["id"] == "bad":
            assert "error" in rep
            continue
        if req.get("track_reset"):
            ref.reset(req["stream"])
        assert rep["stream"] == req["stream"]
        assert_tracks_equal(rep["tracks"], ref.update(req["stream"], rep["detections"]))
        ids = {t["track_id"] for t in rep["tracks"]}
        if req["id"] == "cut":
            assert ids and not ids & seen["cam0"], "a track id crossed the scene cut"
        seen[req["stream"]] |= ids
    assert seen["cam0"] and seen["cam1"]


def test_serve_tcp_two_connections(checkpoint, scans):
    det = Detector(checkpoint=checkpoint, device="cpu")
    ready, stop = threading.Event(), threading.Event()
    port = []
    thread = threading.Thread(
        target=serve.main,
        args=(["--pretrained_path", checkpoint, "--port", "0", "--platform", "cpu", "--max_delay_ms", "20",
               "--track", "--track_min_hits", "1"],),
        kwargs=dict(ready=lambda p: (port.append(p), ready.set()), stop=stop), daemon=True)
    thread.start()
    try:
        assert ready.wait(120), "the server never listened"
        conns = [socket.create_connection(("127.0.0.1", port[0]), timeout=300) for _ in range(2)]
        files = [c.makefile("rw") for c in conns]
        for i, f in enumerate(files):
            for rid in range(2):
                f.write(json.dumps({"id": rid, "lidar": scans[(i + rid) % 3][0]}) + "\n")
            f.write(json.dumps({"id": "bad", "lidar": "/nonexistent.bin"}) + "\n")
            f.flush()
        for i, f in enumerate(files):
            replies = [json.loads(f.readline()) for _ in range(3)]
            assert [r["id"] for r in replies] == [0, 1, "bad"]
            assert "error" in replies[2]
            for rid, r in enumerate(replies[:2]):
                assert_dets_close(r["detections"], det.detect(scans[(i + rid) % 3][1]))
                assert r["stream"] == f"conn-{i}" or r["stream"].startswith("conn-")
                assert r["tracks"]
        for c in conns:
            c.close()
    finally:
        stop.set()
        thread.join(60)
    assert not thread.is_alive()


def test_serve_fused_reads_png_frames(checkpoint, scans, tmp_path):
    rng = np.random.default_rng(3)
    image = rng.integers(0, 256, (375, 1242, 3), dtype=np.uint8)
    png = tmp_path / "frame.png"
    write_png_rgb(str(png), image)
    (tmp_path / "frame.jpg").write_bytes(b"\xff\xd8\xff\xe0 not a png")
    requests = [{"id": 1, "lidar": scans[0][0], "image": str(png)},
                {"id": 2, "lidar": scans[0][0], "image": str(tmp_path / "frame.jpg")}]
    replies, _ = _run_stdio(["--pretrained_path", checkpoint, "--fused"], requests)
    assert str(tmp_path / "frame.jpg") in replies[1]["error"]
    fd = FusedDetector(checkpoint=checkpoint, device="cpu")
    want = fd.detect(scans[0][1], image, KittiCalibration(None))
    got = replies[0]
    assert got["fused"]["boxes"] == want["boxes"].tolist()
    assert got["fused"]["classes"] == want["classes"].tolist()
    assert got["fused"]["source"] == want["source"].tolist()
    np.testing.assert_allclose(got["fused"]["scores"], np.round(want["scores"], 6), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["boxes_3d"], np.round(want["boxes_3d"], 6), rtol=0, atol=1e-6)
    assert len(got["boxes_3d"]) > 0


def test_serve_fused_reads_jpeg_frames(checkpoint, scans, tmp_path):
    """A JPEG frame (written by the port's encoder) is answered as
    FusedDetector answers the decoded pixels; a file that is neither PNG
    nor JPEG gets an error reply naming it."""
    rng = np.random.default_rng(4)
    image = rng.integers(0, 256, (375, 1242, 3), dtype=np.uint8)
    jpg = tmp_path / "frame.jpg"
    write_image_bgr(str(jpg), image[:, :, ::-1])
    (tmp_path / "frame.bmp").write_bytes(b"BM" + bytes(64))
    requests = [{"id": 1, "lidar": scans[0][0], "image": str(jpg)},
                {"id": 2, "lidar": scans[0][0], "image": str(tmp_path / "frame.bmp")}]
    replies, _ = _run_stdio(["--pretrained_path", checkpoint, "--fused"], requests)
    assert str(tmp_path / "frame.bmp") in replies[1]["error"]
    assert "detections" not in replies[1] and "fused" not in replies[1]
    decoded = np.ascontiguousarray(read_image_bgr(str(jpg))[:, :, ::-1])
    assert 0 < np.abs(decoded.astype(int) - image).max()  # lossy: the reply must use the decoded pixels
    want = FusedDetector(checkpoint=checkpoint, device="cpu").detect(scans[0][1], decoded, KittiCalibration(None))
    got = replies[0]
    assert got["id"] == 1
    assert got["fused"]["boxes"] == want["boxes"].tolist()
    assert got["fused"]["classes"] == want["classes"].tolist()
    assert got["fused"]["source"] == want["source"].tolist()
    np.testing.assert_allclose(got["fused"]["scores"], np.round(want["scores"], 6), rtol=0, atol=1e-6)
    assert len(got["boxes_3d"]) > 0
    np.testing.assert_allclose(got["boxes_3d"], want["boxes_3d"], rtol=0, atol=1e-3)


def test_serve_refuses_jax_only_options_and_fused_tracking(checkpoint, tmp_path):
    jax_artifact = tmp_path / "model.sfa3dx"  # the JAX export's header: magic, manifest length, manifest
    jax_artifact.write_bytes(b"SFA3DX01" + (2).to_bytes(8, "little") + b"{}")
    with pytest.raises(ValueError, match="JAX StableHLO artifact"):
        serve.main(["--artifact", str(jax_artifact), "--platform", "cpu"])
    with pytest.raises(NotImplementedError, match="--compilation_cache"):
        serve.main(["--compilation_cache", "--platform", "cpu"])
    with pytest.raises(SystemExit, match="--track"):
        serve.main(["--fused", "--track", "--platform", "cpu"])
    with pytest.raises(SystemExit):  # the parser takes float32 and bfloat16 (served since slice 12)
        serve.main(["--dtype", "float16", "--platform", "cpu"], stdin=io.StringIO(""), stdout=io.StringIO())


def test_serve_arch_resnet_18_answers(tmp_path, scans):
    """--arch resnet_18 serves the deconv arch from its own checkpoint."""
    det = Detector(arch="resnet_18", device="cpu", peak_thresh=0.0)
    path = tmp_path / "Model_resnet_18.pth"
    torch.save(det.model.state_dict(), path)
    replies, _ = _run_stdio(["--arch", "resnet_18", "--pretrained_path", str(path), "--peak_thresh", "0.0"],
                            [{"id": 1, "lidar": scans[0][0]}])
    assert_dets_close(replies[0]["detections"], det.detect(scans[0][1]))
    assert len(replies[0]["detections"]) == 50


def test_serve_runs_on_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main([], stdin=io.StringIO(""), stdout=io.StringIO())
