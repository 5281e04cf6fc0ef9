"""The port's fused program over a data x spatial mesh
(`fusion/batch.py::build_fused_pipeline(mesh=make_mesh_2d(2, 2))`) on the
CPU: four spawned gloo ranks, at a 128 x 128 raster and a 64 x 192
letterbox canvas (tests/test_torch_fused_pipeline.py's camera and weights),
4 frames, 2 a data index.

- In float64 the program's KFPN heads and YOLOv8 levels of each rank's
  frames (the rows computed on each rank, then gathered) lie within 1e-9
  of the one-device program's.
- In float32 each data shard's detections equal JAX's
  `build_fused_pipeline(mesh=make_mesh_2d(2, 2))` frame for frame: `valid`
  equal, the fused boxes and the metric 3D boxes within 1e-3, the two
  ranks of a spatial group returning the same frames.
"""

import threading

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
from sfa3d_tpu.parallel.mesh import make_mesh_2d as jmake_mesh_2d
from sfa3d_tpu.pipeline import init_detector as jinit_detector
from sfa3d_tpu_torch.geometry.calibration import KittiCalibration
from sfa3d_tpu_torch.models.port import state_dict_from_jax, yolo_state_dict_from_jax
from sfa3d_tpu_torch.models.yolov8 import letterbox
from sfa3d_tpu_torch.parallel import mesh as pmesh
from tests._spatial_ranks import fused_rank

B, WORLD, DATA = 4, 4, 2
BEV = (128, 128)
CANVAS = (64, 192)
IMG_HW = (108, 360)
KW = dict(K=50, max_yolo=16, mode="bayesian", use_gaussian_nms=True, bev_size=BEV, fusion_iou_threshold=0.05,
          sfa_conf_gate=0.2)
NET_TOL = 1e-9  # float64 heads and levels, sharded against one device
BOX_TOL = 1e-3
SPAWN_TIMEOUT = 300


def _camera():
    """tests/test_torch_fused_pipeline.py's camera: the KITTI one moved 20 m
    right and 15 m back, intrinsics scaled to 360 x 108."""
    calib = KittiCalibration(None)
    v2c = calib.V2C.astype(np.float32).copy()
    v2c[0, 3] -= 20.0
    v2c[2, 3] += 15.0
    p2 = calib.P2.astype(np.float32).copy()
    p2[:2] *= IMG_HW[1] / 1242.0
    return v2c, calib.R0.astype(np.float32), p2


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    kfpn = jcreate_model("fpn_resnet_18")
    kvars = jax.tree_util.tree_map(np.array, jinit_detector(kfpn, jax.random.PRNGKey(0), input_size=BEV))
    for i in range(3):
        kvars["params"][f"fpn{i}_hm_cen"]["conv2"]["bias"] += 2.0
        kvars["params"][f"fpn{i}_dim"]["conv2"]["bias"] += 1.5
    yolo = JYOLOv8(scale="n")
    yvars = yolo.init(jax.random.PRNGKey(1), jnp.zeros((1, *CANVAS, 3), jnp.float32), train=False)
    yvars = jax.tree_util.tree_map(np.array, yvars)
    for i in range(3):
        yvars["params"]["detect"][f"cv2_{i}_2"]["bias"].reshape(4, 16)[:, 2] += 4.0
    rng = np.random.default_rng(41)
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
    case = {"kfpn": state_dict_from_jax(kvars), "yolo": yolo_state_dict_from_jax(yvars, "n", 80), "kw": KW,
            "inputs": inputs, "bev64": rng.uniform(0, 1, (B, 3, *BEV)),
            "images64": rng.uniform(0, 1, (B, *CANVAS, 3))}
    root = tmp_path_factory.mktemp("spatial_fused")
    torch.save(case, root / "case.pt")
    return (kfpn, kvars, yolo, yvars), inputs, str(root / "case.pt"), str(root / "fused")


@pytest.fixture(scope="module")
def runs(fixture):
    (kfpn, kvars, yolo, yvars), inputs, case_path, prefix = fixture
    errors = []

    def spawn():
        threads = torch.get_num_threads()
        try:
            pmesh.spawn_ranks(fused_rank, WORLD, args=(case_path, prefix), device="cpu", timeout=SPAWN_TIMEOUT)
        except BaseException as e:  # reported by the tests
            errors.append(e)
        finally:
            torch.set_num_threads(threads)

    torch.set_num_threads(1)
    t = threading.Thread(target=spawn)
    t.start()
    want = jbuild_fused_pipeline(kfpn, yolo, mesh=jmake_mesh_2d(2, 2), **KW)(kvars, yvars, *inputs)
    want = {k: np.asarray(v) for k, v in want.items()}
    t.join(SPAWN_TIMEOUT + 30)
    assert not t.is_alive(), "the ranks outlived their timeout"
    if errors:
        raise errors[0]
    return want, [torch.load(f"{prefix}.rank{r}.pt", weights_only=False) for r in range(WORLD)]


def test_sharded_networks_equal_the_one_device_networks(runs):
    _, ranks = runs
    for r in ranks:
        assert r["local_rows"] == BEV[0] // 2
        assert r["heads_err"] <= NET_TOL * max(1.0, r["heads_scale"]), (r["rank"], r["heads_err"])
        assert r["levels_err"] <= NET_TOL, (r["rank"], r["levels_err"])
        assert not r["jax_imported"]


def _rows(out, f):
    v = out["valid"][f]
    rows = np.concatenate([out["boxes"][f][v], out["scores"][f][v][:, None],
                           out["classes"][f][v][:, None], out["source"][f][v][:, None]], axis=1)
    return rows[np.lexsort((rows[:, 1], rows[:, 0], rows[:, 6], rows[:, 5]))]


def test_sharded_program_matches_jax_mesh_program(runs):
    want, ranks = runs
    per = B // DATA
    n_valid = n_fused = 0
    for r in ranks:
        got = r["detections"]
        d = r["rank"] // (WORLD // DATA)
        sl = slice(d * per, (d + 1) * per)
        assert set(got) == set(want)
        np.testing.assert_array_equal(got["mask_3d"], want["mask_3d"][sl])
        np.testing.assert_allclose(got["boxes_real"], want["boxes_real"][sl], rtol=0, atol=BOX_TOL)
        for f in range(per):
            np.testing.assert_array_equal(got["valid"][f], want["valid"][sl][f])
            g, w = _rows(got, f), _rows({k: v[sl] for k, v in want.items()}, f)
            np.testing.assert_allclose(g[:, :4], w[:, :4], rtol=0, atol=BOX_TOL)
            np.testing.assert_array_equal(g[:, 5:], w[:, 5:])
            n_valid += len(w)
            n_fused += int((w[:, 6] == 2).sum())
    for a, b in ((0, 1), (2, 3)):  # the two ranks of each spatial group return the same frames
        for k, v in ranks[a]["detections"].items():
            np.testing.assert_array_equal(v, ranks[b]["detections"][k])
    assert n_valid > 0 and n_fused > 0, "no detections or no fused pair: vacuous"
