"""The port's AOT export of the fusion program (`runtime/export.py::
export_fused`), its facade (`ArtifactFusedDetector`), fixed-batch fused
serving and `cli serve --artifact` with a fused artifact, on the CPU,
against the port's live fused program and the JAX package's export.

The geometry is tests/test_torch_fused_pipeline.py's: a 128x128 raster
(`bev_size`, which the JAX export passes through to its pipeline too), its
camera moved so the 128-px decode's boxes project into a 108x360 frame,
here letterboxed onto a square canvas of LETTERBOX (an artifact's canvas is
square, as the JAX export's is).

Tolerances: the artifact equals the live program bit for bit on the CPU;
against JAX's artifact, masks, validity, classes, sources and integer boxes
are equal, 3D boxes within 1e-3 and scores within SCORE_TOL (float32 heads
in another order than XLA's, soft-NMS exp ulps), as in the fused pipeline's
own parity test."""

import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfa3d_tpu.config import kitti as jcnf
from sfa3d_tpu.data.synthetic import synthetic_scene
from sfa3d_tpu.models import create_model as jcreate_model
from sfa3d_tpu.models.yolov8 import YOLOv8 as JYOLOv8
from sfa3d_tpu.ops.bev import filter_and_pad_points
from sfa3d_tpu.pipeline import init_detector as jinit_detector
from sfa3d_tpu.runtime.export import export_fused as jexport_fused
from sfa3d_tpu.runtime.export import load_exported as jload_exported
from sfa3d_tpu.runtime.export import save_exported as jsave_exported
from sfa3d_tpu_torch.cli import serve
from sfa3d_tpu_torch.data.png import write_png_rgb
from sfa3d_tpu_torch.detector import ArtifactDetector, ArtifactFusedDetector, fused_reply
from sfa3d_tpu_torch.fusion.batch import build_fused_pipeline
from sfa3d_tpu_torch.geometry.calibration import KittiCalibration
from sfa3d_tpu_torch.models import create_model
from sfa3d_tpu_torch.models.port import state_dict_from_jax, yolo_state_dict_from_jax
from sfa3d_tpu_torch.models.yolov8 import YOLOv8, letterbox
from sfa3d_tpu_torch.runtime.export import export_fused, letterbox_geometry, load_exported, save_exported
from sfa3d_tpu_torch.runtime.serving import BatchingFusedServer

B = 2  # the fixed batch of the fused artifact
BEV = (128, 128)
LETTERBOX = 192
IMG_HW = (108, 360)
MAXP = 4096
SCORE_TOL = 1e-4
FUSED = dict(K=50, max_yolo=16, bev_size=BEV, fusion_iou_threshold=0.05)


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _calibration():
    """KITTI's camera moved 20 m right and 15 m back, intrinsics scaled to
    the 360-px frame (tests/test_torch_fused_pipeline.py::_camera)."""
    calib = KittiCalibration(None)
    v2c = calib.V2C.astype(np.float32).copy()
    v2c[0, 3] -= 20.0
    v2c[2, 3] += 15.0
    p2 = calib.P2.astype(np.float32).copy()
    p2[:2] *= IMG_HW[1] / 1242.0
    calib.set_matrices(P2=p2, R0=calib.R0.astype(np.float32), V2C=v2c)
    return calib


@pytest.fixture(scope="module")
def weights():
    """JAX KFPN-18 and YOLOv8n variables (heatmap and dim biases raised,
    DFL mass on bin 2, as the fused pipeline's test does) and the port's
    models on them."""
    kfpn = jcreate_model("fpn_resnet_18")
    kvars = jax.tree_util.tree_map(np.array, jinit_detector(kfpn, jax.random.PRNGKey(0), input_size=BEV))
    for i in range(3):
        kvars["params"][f"fpn{i}_hm_cen"]["conv2"]["bias"] += 2.0
        kvars["params"][f"fpn{i}_dim"]["conv2"]["bias"] += 1.5
    yolo = JYOLOv8(scale="n")
    yvars = jax.tree_util.tree_map(
        np.array, yolo.init(jax.random.PRNGKey(1), jnp.zeros((1, LETTERBOX, LETTERBOX, 3), jnp.float32),
                            train=False))
    for i in range(3):
        yvars["params"]["detect"][f"cv2_{i}_2"]["bias"].reshape(4, 16)[:, 2] += 4.0
    tkfpn = create_model("fpn_resnet_18")
    tkfpn.load_state_dict(state_dict_from_jax(kvars), strict=True)
    tyolo = YOLOv8("n", 80)
    tyolo.load_state_dict(yolo_state_dict_from_jax(yvars, "n", 80), strict=True)
    return (kfpn, kvars, yolo, yvars), (tkfpn.eval(), tyolo.eval())


@pytest.fixture(scope="module")
def artifact(weights, tmp_path_factory):
    """A batch-B CPU fused artifact of the port's models."""
    _, (tkfpn, tyolo) = weights
    exported, manifest = export_fused(tkfpn, tyolo, batch=B, max_points=MAXP, img_hw=IMG_HW,
                                      letterbox=LETTERBOX, **FUSED)
    path = tmp_path_factory.mktemp("fused") / "fused.sfa3dt"
    save_exported(str(path), exported, manifest)
    return str(path)


def _requests(n, seed=0):
    rng = np.random.default_rng(37 + seed)
    return [(synthetic_scene(seed=s)[0], rng.integers(0, 256, (*IMG_HW, 3)).astype(np.uint8), _calibration())
            for s in range(seed, seed + n)]


def _batch(requests):
    """The artifact's inputs for `requests` and the live letterbox's
    (img_hw, scale, pad) for each frame."""
    rows = []
    for points, image, calib in requests:
        pts, valid = filter_and_pad_points(points, MAXP, jcnf.boundary)
        img, r, pad = letterbox(image, LETTERBOX)
        rows.append((pts, valid, img, *(np.float32(m) for m in (calib.V2C, calib.R0, calib.P2)),
                     np.float32(IMG_HW), np.float32(r), np.float32(pad)))
    return [np.stack(a) for a in zip(*rows)]


def _rows(out, f):
    v = out["valid"][f]
    rows = np.concatenate([out["boxes"][f][v], out["scores"][f][v][:, None],
                           out["classes"][f][v][:, None], out["source"][f][v][:, None]], axis=1)
    return rows[np.lexsort((rows[:, 1], rows[:, 0], rows[:, 6], rows[:, 5]))]


def test_fused_artifact_equals_the_live_program(weights, artifact):
    """The artifact (baked letterbox geometry) equals the live fused program
    given the live letterbox's pad and scale, bit for bit; the loops stay
    one custom op each."""
    _, (tkfpn, tyolo) = weights
    art = load_exported(artifact)
    targets = [str(n.target) for n in art.exported.graph.nodes if n.op == "call_function"]
    for op in ("bev_raster_reduce", "hard_nms_keep", "soft_nms_gaussian", "greedy_match"):
        assert targets.count(f"sfa3d_torch.{op}.default") == 1, op
    inputs = _batch(_requests(B))
    got = art.call(*inputs[:6])
    want = build_fused_pipeline(tkfpn, tyolo, device="cpu", **FUSED)(*inputs)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert want["valid"].any() and (want["source"][want["valid"]] == 1).any()


def test_fused_artifact_matches_the_jax_artifact(weights, artifact, tmp_path):
    (kfpn, kvars, yolo, yvars), _ = weights
    exported, manifest = jexport_fused(kfpn, kvars, yolo, yvars, batch=B, max_points=MAXP, img_hw=IMG_HW,
                                       letterbox=LETTERBOX, **FUSED)
    jpath = str(tmp_path / "fused.sfa3dx")
    jsave_exported(jpath, exported, manifest)
    inputs = _batch(_requests(B, seed=4))[:6]
    want = {k: np.asarray(v) for k, v in jload_exported(jpath).call(*inputs).items()}
    got = ArtifactFusedDetector(artifact).run_batch(*inputs)
    assert set(got) == set(want)
    ours = load_exported(artifact).manifest
    for key in ("kind", "batch", "max_points", "img_hw", "letterbox", "letterbox_scale", "letterbox_pad",
                "fused_kwargs"):
        assert ours[key] == manifest[key], key
    np.testing.assert_array_equal(got["mask_3d"], want["mask_3d"])
    np.testing.assert_allclose(got["boxes_real"], want["boxes_real"], rtol=0, atol=1e-3)
    n_fused = 0
    for f in range(B):
        np.testing.assert_array_equal(got["valid"][f], want["valid"][f])
        g, w = _rows(got, f), _rows(want, f)
        np.testing.assert_array_equal(g[:, 5:], w[:, 5:])  # classes, source
        np.testing.assert_array_equal(g[:, :4], w[:, :4])  # integer boxes
        np.testing.assert_allclose(g[:, 4], w[:, 4], rtol=0, atol=SCORE_TOL)
        n_fused += int((w[:, 6] == 2).sum())
    assert n_fused > 0, "no fused pair: vacuous"


def test_letterbox_pad_pinned_against_jax(weights):
    """At 375x1242 on a 640 canvas JAX's export_fused bakes the integer pad
    (0, 223) and scale 640/1242; the port's geometry is the same, and so is
    what the live letterbox returns for such a frame (its top padding,
    round(223.5 - 0.1)), so the artifact and the live FusedDetector
    unletterbox alike."""
    (kfpn, kvars, yolo, yvars), _ = weights
    _, manifest = jexport_fused(kfpn, kvars, yolo, yvars, batch=1, max_points=MAXP, img_hw=(375, 1242),
                                letterbox=640, bev_size=BEV)
    scale, pad_x, pad_y = letterbox_geometry((375, 1242), 640)
    assert manifest["letterbox_pad"] == [pad_x, pad_y] == [0, 223]
    assert manifest["letterbox_scale"] == scale == 640 / 1242
    _, r, pad = letterbox(np.zeros((375, 1242, 3), np.uint8), 640)
    assert (r, pad) == (scale, (0, 223))


def test_fixed_batch_fused_artifact(artifact, capsys):
    """The facade's surface; the program refuses another batch; the server
    clamps max_batch to the artifact's batch, pads every batch to it, and
    refuses at submit a frame of another size than the baked img_hw."""
    afd = ArtifactFusedDetector(artifact)
    assert (afd.imgsz, afd.img_hw, afd.fixed_batch, afd.max_points) == (LETTERBOX, IMG_HW, B, MAXP)
    with pytest.raises(ValueError, match="cannot back the LiDAR detector server"):
        ArtifactDetector(artifact)
    reqs = _requests(3, seed=8)
    with pytest.raises(Exception):
        afd.run_batch(*_batch(reqs)[:6])  # batch 3: the program's own shape check
    points, image, calib = reqs[0]
    with pytest.raises(ValueError, match=r"bakes img_hw=\[108, 360\]"):
        afd.detect(points, image[:, :200], calib)
    with pytest.raises(Exception):
        afd.detect(points, image, calib)  # one frame: as in JAX, only the batching server pads
    server = BatchingFusedServer(afd, max_batch=8, max_delay_ms=500.0)
    try:
        assert "clamping max_batch 8 -> 2 (fixed-batch artifact)" in capsys.readouterr().err
        assert server.buckets() == [B]
        with pytest.raises(ValueError, match="re-export for this camera"):
            server.submit_fused(points, image[:, :200], calib)
        futs = [server.submit_fused(*r) for r in reqs]
        replies = [f.result(timeout=600) for f in futs]
    finally:
        server.stop()
    assert server.stats["served"] == 3 and server.stats["padded"] == B * server.stats["batches"] - 3
    inputs = _batch(reqs)[:6]
    n_rows = 0
    for i, got in enumerate(replies):  # each frame through the program beside an empty frame
        pair = afd.run_batch(*[np.stack([a[i], np.zeros_like(a[i])]) for a in inputs])
        want = fused_reply(pair, 0)
        assert set(got) == set(want)
        for k in ("boxes", "classes", "source"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_allclose(got["scores"], want["scores"], rtol=0, atol=SCORE_TOL)
        np.testing.assert_allclose(got["boxes_3d"], want["boxes_3d"], rtol=0, atol=1e-5)
        n_rows += len(want["boxes"])
    assert n_rows > 0


def test_serve_cli_with_a_fused_artifact(artifact, tmp_path):
    """`cli serve --artifact` dispatches on the manifest's kind: a fused
    artifact backs the fusion server, whose replies equal the facade's;
    --track with a fused artifact is refused."""
    points, image, calib = _requests(1, seed=12)[0]
    png, scan = tmp_path / "frame.png", tmp_path / "000012.bin"
    write_png_rgb(str(png), image)
    points.astype(np.float32).tofile(scan)
    calib_path = tmp_path / "calib.txt"
    with open(calib_path, "w") as f:
        for name, m in (("P2", calib.P2), ("R0_rect", calib.R0), ("Tr_velo_to_cam", calib.V2C)):
            f.write(f"{name}: " + " ".join(f"{v:.9e}" for v in np.asarray(m, np.float64).ravel()) + "\n")
    req = {"id": 1, "lidar": str(scan), "image": str(png), "calib": str(calib_path)}
    stdout = io.StringIO()
    serve.main(["--artifact", artifact, "--platform", "cpu", "--max_delay_ms", "1"],
               stdin=io.StringIO(json.dumps(req) + "\n"), stdout=stdout)
    reply = json.loads(stdout.getvalue())
    inputs = _batch([(points, image, KittiCalibration(str(calib_path)))] * B)[:6]
    want = fused_reply(ArtifactFusedDetector(artifact).run_batch(*inputs), 0)
    assert reply["id"] == 1 and reply["fused"]["boxes"] == want["boxes"].tolist()
    assert reply["fused"]["source"] == want["source"].tolist() and len(want["boxes"]) > 0
    np.testing.assert_allclose(reply["boxes_3d"], np.round(want["boxes_3d"], 6), rtol=0, atol=1e-6)
    with pytest.raises(SystemExit, match="--track supports the LiDAR detector server only"):
        serve.main(["--artifact", artifact, "--platform", "cpu", "--track"])
