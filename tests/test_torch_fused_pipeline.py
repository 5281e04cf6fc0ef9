"""The port's batched camera + LiDAR fusion program (`build_fused_pipeline`),
`FusedDetector` and `BatchingFusedServer` against the JAX package on the
CPU, at a 128x128 raster and a 64x192 letterbox canvas.

The decode's metric constants assume the 608x608 raster, so a 128x128
heatmap puts every 3D box at x in [0, 10.5] m, y in [-25, -14.5] m. The
camera of this fixture is the KITTI one moved 20 m to the right and 15 m
back (V2C's translation), with the intrinsics scaled to a 360x108 image, so
those boxes project into the image and the fusion stages have work."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfa3d_tpu.config import kitti as jcnf
from sfa3d_tpu.data.synthetic import synthetic_scene
from sfa3d_tpu.fusion.batch import build_fused_pipeline as jbuild_fused_pipeline
from sfa3d_tpu.models import create_model as jcreate_model
from sfa3d_tpu.models.yolov8 import YOLOv8 as JYOLOv8
from sfa3d_tpu.ops.bev import filter_and_pad_points
from sfa3d_tpu.pipeline import init_detector as jinit_detector
from sfa3d_tpu_torch.detector import FusedDetector
from sfa3d_tpu_torch.fusion.batch import build_fused_pipeline
from sfa3d_tpu_torch.geometry.calibration import KittiCalibration
from sfa3d_tpu_torch.models import create_model
from sfa3d_tpu_torch.models.port import state_dict_from_jax, yolo_state_dict_from_jax
from sfa3d_tpu_torch.models.yolov8 import YOLOv8, letterbox
from sfa3d_tpu_torch.runtime.serving import BatchingFusedServer

B = 2
BEV = (128, 128)
CANVAS = (64, 192)
IMG_HW = (108, 360)
K, MAX_YOLO = 50, 16
FUSION_IOU = 0.05  # random YOLO boxes are rarely close to the projected ones
SCORE_TOL = 1e-4  # scores: float32 heads in another order than XLA's, soft-NMS exp ulps
# A fused or projected coordinate is truncated to an integer; where its exact
# value sits on an integer, the two frameworks' float32 roundings may
# truncate one pixel apart. Allowed only where the port's untruncated value
# lies within TRUNC_EDGE of an integer (none is needed by this fixture).
TRUNC_EDGE = 1e-3


def _camera():
    """Per-frame calibration of the fixture's camera (see module docstring)."""
    calib = KittiCalibration(None)
    v2c = calib.V2C.astype(np.float32).copy()
    v2c[0, 3] -= 20.0
    v2c[2, 3] += 15.0
    p2 = calib.P2.astype(np.float32).copy()
    p2[:2] *= IMG_HW[1] / 1242.0
    return v2c, calib.R0.astype(np.float32), p2


@pytest.fixture(scope="module")
def fixture():
    kfpn = jcreate_model("fpn_resnet_18")
    kvars = jinit_detector(kfpn, jax.random.PRNGKey(0), input_size=BEV)
    kvars = jax.tree_util.tree_map(lambda t: np.array(t), kvars)
    for i in range(3):
        # random weights then give peaks above the threshold, and boxes of
        # about 1.5 m a side that project to boxes of a few pixels
        kvars["params"][f"fpn{i}_hm_cen"]["conv2"]["bias"] += 2.0
        kvars["params"][f"fpn{i}_dim"]["conv2"]["bias"] += 1.5
    yolo = JYOLOv8(scale="n")
    yvars = yolo.init(jax.random.PRNGKey(1), jnp.zeros((1, *CANVAS, 3), jnp.float32), train=False)
    yvars = jax.tree_util.tree_map(lambda t: np.array(t), yvars)
    for i in range(3):  # DFL mass on bin 2: YOLO boxes of about 4 strides
        yvars["params"]["detect"][f"cv2_{i}_2"]["bias"].reshape(4, 16)[:, 2] += 4.0

    tkfpn = create_model("fpn_resnet_18")
    tkfpn.load_state_dict(state_dict_from_jax(kvars), strict=True)
    tyolo = YOLOv8("n", 80)
    tyolo.load_state_dict(yolo_state_dict_from_jax(yvars, "n", 80), strict=True)

    rng = np.random.default_rng(31)
    pts = np.zeros((B, jcnf.MAX_POINTS_FILTERED, 4), np.float32)
    val = np.zeros((B, jcnf.MAX_POINTS_FILTERED), bool)
    for b in range(B):
        pts[b], val[b] = filter_and_pad_points(synthetic_scene(seed=b + 3)[0])
    images = np.stack([letterbox(rng.integers(0, 256, (*IMG_HW, 3)).astype(np.uint8), CANVAS)[0]
                       for _ in range(B)])
    _, r, pad = letterbox(np.zeros((*IMG_HW, 3), np.uint8), CANVAS)
    v2c, r0, p2 = _camera()
    inputs = (pts, val, images, np.stack([v2c] * B), np.stack([r0] * B), np.stack([p2] * B),
              np.float32([IMG_HW] * B), np.float32([r] * B), np.float32([pad] * B))
    return (kfpn, kvars, yolo, yvars), (tkfpn.eval(), tyolo.eval()), inputs


def _rows(out, f):
    v = out["valid"][f]
    rows = np.concatenate([out["boxes"][f][v], out["scores"][f][v][:, None],
                           out["classes"][f][v][:, None], out["source"][f][v][:, None]], axis=1)
    return rows[np.lexsort((rows[:, 1], rows[:, 0], rows[:, 6], rows[:, 5]))]


MODES = [("bayesian", True), ("bayesian", False), ("weighted", False), ("nms", False)]


@pytest.mark.parametrize("mode,gnms", MODES, ids=[f"{m}-{'gauss' if g else 'hard'}" for m, g in MODES])
def test_build_fused_pipeline_matches_jax(fixture, mode, gnms):
    (kfpn, kvars, yolo, yvars), (tkfpn, tyolo), inputs = fixture
    kw = dict(K=K, max_yolo=MAX_YOLO, mode=mode, use_gaussian_nms=gnms, bev_size=BEV,
              fusion_iou_threshold=FUSION_IOU, sfa_conf_gate=0.2)
    want = jbuild_fused_pipeline(kfpn, yolo, **kw)(kvars, yvars, *inputs)
    want = {k: np.asarray(v) for k, v in want.items()}
    got = build_fused_pipeline(tkfpn, tyolo, device="cpu", **kw)(*inputs)
    got = {k: v.numpy() for k, v in got.items()}

    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
    np.testing.assert_array_equal(got["mask_3d"], want["mask_3d"])
    np.testing.assert_allclose(got["boxes_real"], want["boxes_real"], rtol=0, atol=1e-3)
    n_valid = n_fused = 0
    for f in range(B):
        np.testing.assert_array_equal(got["valid"][f], want["valid"][f])
        g, w = _rows(got, f), _rows(want, f)
        np.testing.assert_array_equal(g[:, 5:], w[:, 5:])  # classes, source
        np.testing.assert_array_equal(g[:, :4], w[:, :4])  # integer boxes
        np.testing.assert_allclose(g[:, 4], w[:, 4], rtol=0, atol=SCORE_TOL)
        n_valid += len(w)
        n_fused += int((w[:, 6] == 2).sum())
    assert n_valid > 0 and (got["source"][got["valid"]] == 1).any(), "no SFA3D box in the image: vacuous"
    if mode != "nms":
        assert n_fused > 0, "no fused pair: vacuous"


def test_unknown_mode_raises(fixture):
    _, (tkfpn, tyolo), _ = fixture
    with pytest.raises(ValueError, match="unknown fusion mode"):
        build_fused_pipeline(tkfpn, tyolo, mode="vote", device="cpu")


@pytest.fixture(scope="module")
def fused_detector(fixture, tmp_path_factory):
    """A CPU FusedDetector on the fixture's weights, loaded from a `.pth`
    and an ultralytics-layout `.pt`, at the full 608x608 raster."""
    _, (tkfpn, tyolo), _ = fixture
    d = tmp_path_factory.mktemp("weights")
    torch.save({"state_dict": tkfpn.state_dict()}, d / "kfpn.pth")
    torch.save({"model": tyolo.state_dict()}, d / "yolov8n.pt")
    det = FusedDetector(checkpoint=str(d / "kfpn.pth"), yolo_checkpoint=str(d / "yolov8n.pt"),
                        imgsz=CANVAS, max_yolo=MAX_YOLO, fusion_iou_threshold=FUSION_IOU,
                        device="cpu")
    with pytest.raises(ValueError, match="YOLOv8n"):
        FusedDetector(yolo_checkpoint=str(d / "yolov8n.pt"), yolo_scale="s", device="cpu")
    return det


def _requests(n):
    rng = np.random.default_rng(37)
    v2c, r0, p2 = _camera()
    calib = KittiCalibration(None)
    calib.set_matrices(P2=p2, R0=r0, V2C=v2c)
    return [(synthetic_scene(seed=s)[0], rng.integers(0, 256, (*IMG_HW, 3)).astype(np.uint8), calib)
            for s in range(n)]


def _assert_replies_equal(got, want):
    assert set(got) == set(want) == {"boxes", "scores", "classes", "source", "boxes_3d"}
    for k in ("boxes", "classes", "source"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0, atol=SCORE_TOL)
    np.testing.assert_allclose(got["boxes_3d"], want["boxes_3d"], rtol=0, atol=1e-5)


def test_fused_detector_detect_on_cpu(fused_detector):
    (points, image, calib), = _requests(1)
    out = fused_detector.detect(points, image, calib)
    for k in ("boxes", "scores", "classes", "source"):
        assert len(out[k]) == len(out["boxes"])
    assert out["boxes"].dtype.kind == "i" and out["boxes_3d"].shape[1:] == (8,)
    assert len(out["boxes"]) > 0 and len(out["boxes_3d"]) > 0
    # the same frame prepared by hand through the fused program
    pts, valid = filter_and_pad_points(points)
    img, r, pad = letterbox(image, CANVAS)
    raw = fused_detector.run_batch(
        pts[None], valid[None], img[None], calib.V2C[None].astype(np.float32),
        calib.R0[None].astype(np.float32), calib.P2[None].astype(np.float32),
        np.float32([IMG_HW]), np.float32([r]), np.float32([pad]))
    v = raw["valid"][0]
    np.testing.assert_array_equal(out["boxes"], raw["boxes"][0][v].astype(int))
    np.testing.assert_array_equal(out["boxes_3d"], raw["boxes_real"][0][raw["mask_3d"][0]])


def test_batching_fused_server_on_cpu(fused_detector, tmp_path):
    reqs = _requests(3)
    reqs[2][0].astype(np.float32).tofile(tmp_path / "000002.bin")
    server = BatchingFusedServer(fused_detector, max_batch=2, max_delay_ms=500.0)
    try:
        server.warmup()
        futs = [server.submit_fused(*r) for r in reqs[:2]]
        futs.append(server.submit_fused_file(str(tmp_path / "000002.bin"), *reqs[2][1:]))
        replies = [f.result(timeout=300) for f in futs]
        with pytest.raises(TypeError, match="submit_fused"):
            server.submit(reqs[0][0])
    finally:
        server.stop()
    assert server.stats["served"] == 3 and server.stats["batches"] >= 2
    assert server.buckets() == [1, 2]
    for (points, image, calib), got in zip(reqs, replies):
        _assert_replies_equal(got, fused_detector.detect(points, image, calib))
    with pytest.raises(RuntimeError, match="server stopped"):
        server.submit_fused(*reqs[0])
