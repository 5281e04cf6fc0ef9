"""bfloat16 inference of the port (`Detector(dtype="bfloat16")`, the fused
program over networks set by `models::to_inference_dtype`, `serve --dtype
bfloat16`) against the JAX package's bfloat16 models, on the CPU.

JAX's bfloat16 models (`create_model(dtype=jnp.bfloat16)`, `YOLOv8(dtype=
jnp.bfloat16)`) and the port's bfloat16 networks round at the same places
but their convolutions do not sum in the same order, so the two bfloat16
runs are not compared
element by element. The same seeded inputs and JAX-bridged weights go
through JAX float32, JAX bfloat16 and the port's bfloat16 path, and the
port's deviation from JAX float32 is held to a multiple of JAX's own:

- raw heads: per head, max |port bf16 - JAX f32| within HEAD_MULT = 2 times
  max |JAX bf16 - JAX f32|;
- detections (decode at K = 50, matched to JAX float32's by BEV centre
  within 1 m and the same class, the JAX audit's rule, in
  `scripts/torch_bf16_audit.py::match_and_diff`): the port's match rate
  at least JAX's less MATCH_SLACK = 0.05, and per
  field (x, y, z, h, w, l, yaw, score) its p95 and max deviation within
  DET_MULT = 3 times JAX's plus DET_FLOOR = 1e-3;
- the fused program at a 128 x 128 raster and a 64 x 192 canvas: its 3D
  branch as the detections above; its fused 2D rows matched to JAX
  float32's (same class and source, every coordinate within ROW_PX = 8
  px), the match rate as above and the matched rows' largest coordinate
  and score deviation within DET_MULT times JAX's plus ROW_FLOOR = 1 px
  (coordinates are integers) and DET_FLOOR (scores).

The raster stays float32 and the heads come out bfloat16, as in JAX;
`to_inference_dtype` casts the convolutions' weights once and leaves
BatchNorm float32; `FlaxBatchNorm2d` takes a bfloat16 input to float32 in
eval and training mode, bit-equal to its float32 run on the same values
(flax's promotion); `Detector(dtype="float16")` raises; `serve --dtype
bfloat16 --platform cpu` answers with and without `--fused`.
"""

import io
import json

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
from sfa3d_tpu.ops.bev import filter_and_pad_points, points_to_bev as jpoints_to_bev
from sfa3d_tpu.pipeline import detect_bev as jdetect_bev
from sfa3d_tpu.pipeline import init_detector as jinit_detector
from sfa3d_tpu_torch.cli import serve
from sfa3d_tpu_torch.detector import Detector
from sfa3d_tpu_torch.fusion.batch import build_fused_pipeline
from sfa3d_tpu_torch.geometry.calibration import KittiCalibration
from sfa3d_tpu_torch.models import create_model, to_inference_dtype
from sfa3d_tpu_torch.models.port import state_dict_from_jax, yolo_state_dict_from_jax
from sfa3d_tpu_torch.models.yolov8 import YOLOv8, letterbox
from sfa3d_tpu_torch.pipeline import detect_bev, forward_heads
from scripts.torch_bf16_audit import match_and_diff

HEAD_MULT = 2.0
DET_MULT = 3.0
DET_FLOOR = 1e-3
MATCH_SLACK = 0.05
ROW_PX = 8.0
ROW_FLOOR = 1.0
BEV = (256, 256)  # the heads' comparison: a 64 x 64 heatmap
FUSED_BEV = (128, 128)
CANVAS = (64, 192)
IMG_HW = (108, 360)
B = 2
K, MAX_YOLO = 50, 16
FUSION_IOU = 0.05


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bumped(kvars):
    """Random KFPN weights with the heatmap biases raised by 2.0 (peaks above
    the threshold) and the dim biases by 1.5 (boxes of about 1.5 m)."""
    for i in range(3):
        kvars["params"][f"fpn{i}_hm_cen"]["conv2"]["bias"] += 2.0
        kvars["params"][f"fpn{i}_dim"]["conv2"]["bias"] += 1.5
    return kvars


def _scans(n, max_points=jcnf.MAX_POINTS_FILTERED):
    pts = np.zeros((n, max_points, 4), np.float32)
    val = np.zeros((n, max_points), bool)
    for b in range(n):
        pts[b], val[b] = filter_and_pad_points(synthetic_scene(seed=b + 3)[0], max_points=max_points)
    return pts, val


def _camera():
    """The KITTI camera moved 20 m right and 15 m back, intrinsics scaled to
    a 360 x 108 image: the small raster's boxes project into it (the
    fixture of tests/test_torch_fused_pipeline.py)."""
    calib = KittiCalibration(None)
    v2c = calib.V2C.astype(np.float32).copy()
    v2c[0, 3] -= 20.0
    v2c[2, 3] += 15.0
    p2 = calib.P2.astype(np.float32).copy()
    p2[:2] *= IMG_HW[1] / 1242.0
    return v2c, calib.R0.astype(np.float32), p2


@pytest.fixture(scope="module")
def heads_case():
    """One JAX init (bumped), two seeded scans rasterised at BEV; JAX
    float32 and bfloat16 heads and decodes, and the port's bfloat16 ones."""
    jm32 = jcreate_model("fpn_resnet_18")
    jm16 = jcreate_model("fpn_resnet_18", dtype=jnp.bfloat16)
    kvars = _bumped(jax.tree_util.tree_map(np.array, jinit_detector(jm32, jax.random.PRNGKey(0), input_size=BEV)))
    pts, val = _scans(B)
    bound = (jcnf.boundary["minX"], jcnf.boundary["maxX"], jcnf.boundary["minY"], jcnf.boundary["maxY"],
             jcnf.boundary["minZ"], jcnf.boundary["maxZ"])
    bev = np.stack([np.asarray(jpoints_to_bev(p, v, bev_height=BEV[0], bev_width=BEV[1], bound=bound))
                    for p, v in zip(pts, val)])
    jax_heads = {name: {k: np.asarray(v.astype(jnp.float32)) for k, v in m.apply(kvars, bev).items()}
                 for name, m in (("f32", jm32), ("bf16", jm16))}
    jax_dets = {name: [np.asarray(a) for a in jdetect_bev(m, kvars, bev, K=K)]
                for name, m in (("f32", jm32), ("bf16", jm16))}
    model = create_model("fpn_resnet_18")
    model.load_state_dict(state_dict_from_jax(kvars), strict=True)
    to_inference_dtype(model.eval(), "bfloat16")
    port_heads = forward_heads(model, torch.from_numpy(bev))
    port_dets = [a.numpy() for a in detect_bev(model, torch.from_numpy(bev), K=K)]
    return jax_heads, jax_dets, port_heads, port_dets


def envelope(ref, other, frames):
    """Match `other`'s detections to `ref`'s frame by frame -> (match rate,
    per-field p95, per-field max, matched pairs). Each is (dets, boxes_bev,
    boxes_real, mask)."""
    rows, counts = [], np.zeros(3, np.int64)
    for f in range(frames):
        r, c = match_and_diff(ref[2][f], ref[0][f, :, 0], ref[3][f], other[2][f], other[0][f, :, 0], other[3][f])
        rows += r
        counts += c
    D = np.asarray(rows).reshape(-1, 8)
    rate = counts[2] / max(1, max(counts[0], counts[1]))
    return rate, np.percentile(D, 95, axis=0), D.max(axis=0), int(counts[2])


def assert_within_envelope(port, jax_own, what):
    p_rate, p_p95, p_max, p_n = port
    j_rate, j_p95, j_max, j_n = jax_own
    assert j_n > 0 and p_n > 0, f"{what}: no matched detection (vacuous)"
    assert p_rate >= j_rate - MATCH_SLACK, (what, p_rate, j_rate)
    assert np.all(p_p95 <= DET_MULT * j_p95 + DET_FLOOR), (what, p_p95.tolist(), j_p95.tolist())
    assert np.all(p_max <= DET_MULT * j_max + DET_FLOOR), (what, p_max.tolist(), j_max.tolist())


def test_bf16_heads_within_jax_bf16_deviation(heads_case):
    jax_heads, _, port_heads, _ = heads_case
    for k, want in jax_heads["f32"].items():
        assert port_heads[k].dtype == torch.bfloat16, k
        own = np.abs(jax_heads["bf16"][k] - want).max()
        got = np.abs(port_heads[k].float().numpy() - want).max()
        assert 0 < own and got <= HEAD_MULT * own, (k, got, own)


def test_bf16_detections_within_jax_bf16_envelope(heads_case):
    _, jax_dets, _, port_dets = heads_case
    jax_own = envelope(jax_dets["f32"], jax_dets["bf16"], B)
    assert_within_envelope(envelope(jax_dets["f32"], port_dets, B), jax_own, "detections")


@pytest.fixture(scope="module")
def fused_case():
    """JAX-bridged KFPN and YOLOv8n weights (bumped as in
    tests/test_torch_fused_pipeline.py), two scans and letterboxed random
    images; the fused program of JAX float32, JAX bfloat16 and the port's
    bfloat16 at FUSED_BEV."""
    kfpn32, kfpn16 = jcreate_model("fpn_resnet_18"), jcreate_model("fpn_resnet_18", dtype=jnp.bfloat16)
    kvars = _bumped(jax.tree_util.tree_map(np.array, jinit_detector(kfpn32, jax.random.PRNGKey(0),
                                                                    input_size=FUSED_BEV)))
    yolo32, yolo16 = JYOLOv8(scale="n"), JYOLOv8(scale="n", dtype=jnp.bfloat16)
    yvars = jax.tree_util.tree_map(
        np.array, yolo32.init(jax.random.PRNGKey(1), jnp.zeros((1, *CANVAS, 3), jnp.float32), train=False))
    for i in range(3):  # DFL mass on bin 2: YOLO boxes of about 4 strides
        yvars["params"]["detect"][f"cv2_{i}_2"]["bias"].reshape(4, 16)[:, 2] += 4.0
    rng = np.random.default_rng(31)
    pts, val = _scans(B)
    images = np.stack([letterbox(rng.integers(0, 256, (*IMG_HW, 3)).astype(np.uint8), CANVAS)[0]
                       for _ in range(B)])
    _, r, pad = letterbox(np.zeros((*IMG_HW, 3), np.uint8), CANVAS)
    v2c, r0, p2 = _camera()
    inputs = (pts, val, images, np.stack([v2c] * B), np.stack([r0] * B), np.stack([p2] * B),
              np.float32([IMG_HW] * B), np.float32([r] * B), np.float32([pad] * B))
    kw = dict(K=K, max_yolo=MAX_YOLO, bev_size=FUSED_BEV, fusion_iou_threshold=FUSION_IOU, sfa_conf_gate=0.2)
    outs = {}
    for name, (km, ym) in (("f32", (kfpn32, yolo32)), ("bf16", (kfpn16, yolo16))):
        outs[name] = {k: np.asarray(v) for k, v in jbuild_fused_pipeline(km, ym, **kw)(kvars, yvars, *inputs).items()}
    tkfpn = create_model("fpn_resnet_18")
    tkfpn.load_state_dict(state_dict_from_jax(kvars), strict=True)
    tyolo = YOLOv8("n", 80)
    tyolo.load_state_dict(yolo_state_dict_from_jax(yvars, "n", 80), strict=True)
    to_inference_dtype(tkfpn.eval(), "bfloat16"), to_inference_dtype(tyolo.eval(), "bfloat16")
    seen = []
    hooks = [m.register_forward_hook(lambda mod, args, out: seen.append(out)) for m in (tkfpn, tyolo)]
    try:
        port = build_fused_pipeline(tkfpn, tyolo, device="cpu", **kw)(*inputs)
    finally:
        for h in hooks:
            h.remove()
    outs["port"] = {k: v.numpy() for k, v in port.items()}
    return outs, seen


def _rows(out, f):
    v = out["valid"][f]
    return np.concatenate([out["boxes"][f][v], out["scores"][f][v][:, None],
                           out["classes"][f][v][:, None], out["source"][f][v][:, None]], axis=1)


def row_envelope(ref, other):
    """Greedy match of `other`'s fused rows to `ref`'s (same class and
    source, the nearest by largest coordinate difference, within ROW_PX) ->
    (match rate, largest coordinate deviation, largest score deviation,
    matched rows)."""
    n_ref = n_other = matched = 0
    px = score = 0.0
    for f in range(B):
        a, b = _rows(ref, f), _rows(other, f)
        n_ref, n_other = n_ref + len(a), n_other + len(b)
        used = np.zeros(len(b), bool)
        for row in a:
            if not len(b):
                break
            d = np.abs(b[:, :4] - row[:4]).max(1)
            d = np.where(used | (b[:, 5] != row[5]) | (b[:, 6] != row[6]), np.inf, d)
            j = int(np.argmin(d))
            if d[j] > ROW_PX:
                continue
            used[j] = True
            matched += 1
            px, score = max(px, float(d[j])), max(score, abs(float(b[j, 4] - row[4])))
    return matched / max(1, n_ref, n_other), px, score, matched


def _as_dets(out):
    """The fused program's 3D branch as (dets, boxes_bev, boxes_real, mask)
    with the score in dets[..., 0] (boxes_real carries no score: the
    branch's scores are not in the output, so they compare as 0)."""
    real = out["boxes_real"]
    return np.zeros(real.shape[:2] + (1,), np.float32), None, real, out["mask_3d"]


def test_fused_program_bf16_within_jax_bf16_envelope(fused_case):
    outs, seen = fused_case
    kfpn_heads, yolo_levels = seen
    assert all(v.dtype == torch.bfloat16 for v in kfpn_heads.values())
    assert all(t.dtype == torch.bfloat16 for level in yolo_levels for t in level)
    for k in ("boxes", "scores", "boxes_real"):  # the stages after the networks are float32
        assert outs["port"][k].dtype == np.float32, k
    assert_within_envelope(envelope(_as_dets(outs["f32"]), _as_dets(outs["port"]), B),
                           envelope(_as_dets(outs["f32"]), _as_dets(outs["bf16"]), B), "fused 3D branch")
    j_rate, j_px, j_score, j_n = row_envelope(outs["f32"], outs["bf16"])
    p_rate, p_px, p_score, p_n = row_envelope(outs["f32"], outs["port"])
    assert j_n > 0 and p_n > 0 and (outs["f32"]["source"][outs["f32"]["valid"]] == 2).any(), "vacuous"
    assert p_rate >= j_rate - MATCH_SLACK, (p_rate, j_rate)
    assert p_px <= DET_MULT * j_px + ROW_FLOOR, (p_px, j_px)
    assert p_score <= DET_MULT * j_score + DET_FLOOR, (p_score, j_score)


def test_detector_bf16_answers_and_other_dtypes_raise():
    det = Detector(dtype="bfloat16", device="cpu")
    sd = det.model.state_dict()
    for i in range(3):
        sd[f"fpn{i}_hm_cen.2.bias"] += 2.0
    det.model.load_state_dict(sd)
    pts, val = _scans(1)
    out = det.detect_batch(pts, val)
    assert out["mask"].any() and out["boxes_real"].dtype == np.float32
    assert np.isfinite(out["boxes_real"]).all()
    from sfa3d_tpu_torch.pipeline import detect_frames

    raw = detect_frames(det.model, pts, val, device="cpu", return_heads=True)
    assert raw["bev"].dtype == torch.float32
    assert all(v.dtype == torch.bfloat16 for v in raw["heads"].values())
    for dtype in ("float16", "bf16"):
        with pytest.raises(ValueError, match="compute dtype"):
            Detector(dtype=dtype, device="cpu")


def test_to_inference_dtype_casts_conv_weights_once():
    from sfa3d_tpu_torch.models.resnet import FlaxBatchNorm2d

    model = create_model("fpn_resnet_18").init_weights(torch.Generator().manual_seed(0)).eval()
    assert to_inference_dtype(model, "float32") is model
    assert all(p.dtype == torch.float32 for p in model.parameters())
    to_inference_dtype(to_inference_dtype(model, "bfloat16"), "bfloat16")
    convs = [m for m in model.modules() if isinstance(m, torch.nn.Conv2d)]
    bns = [m for m in model.modules() if isinstance(m, FlaxBatchNorm2d)]
    assert convs and bns
    assert all(m.weight.dtype == torch.bfloat16 and len(m._forward_pre_hooks) == 1 for m in convs)
    assert all(t.dtype == torch.float32 for m in bns for t in (m.weight, m.bias, m.running_mean, m.running_var))
    with pytest.raises(ValueError, match="compute dtype"):
        to_inference_dtype(model, "float16")


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_batchnorm_takes_bfloat16_to_float32(mode):
    from sfa3d_tpu_torch.models.resnet import FlaxBatchNorm2d

    g = torch.Generator().manual_seed(3)
    x16 = (3.0 * torch.randn(4, 8, 6, 6, generator=g) + 1.0).to(torch.bfloat16)
    outs = []
    for x in (x16, x16.float()):
        bn = FlaxBatchNorm2d(8)
        with torch.no_grad():
            bn.weight.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(4))
            bn.running_var.fill_(2.0)
        bn.train(mode == "train")
        outs.append((bn(x), bn.running_mean.clone(), bn.running_var.clone()))
    (y16, m16, v16), (y32, m32, v32) = outs
    assert y16.dtype == torch.float32
    assert torch.equal(y16, y32) and torch.equal(m16, m32) and torch.equal(v16, v32)


@pytest.mark.parametrize("fused", [False, True], ids=["lidar", "fused"])
def test_serve_dtype_bfloat16_replies(tmp_path, fused):
    from sfa3d_tpu_torch.data.png import write_png_rgb

    scan = tmp_path / "000000.bin"
    synthetic_scene(seed=3)[0].astype(np.float32).tofile(scan)
    request = {"id": 7, "lidar": str(scan)}
    argv = ["--dtype", "bfloat16", "--platform", "cpu"]
    if fused:
        image = np.random.default_rng(5).integers(0, 256, (375, 1242, 3), dtype=np.uint8)
        write_png_rgb(str(tmp_path / "frame.png"), image)
        request["image"] = str(tmp_path / "frame.png")
        argv.append("--fused")
    stdout = io.StringIO()
    stats = serve.main(argv, stdin=io.StringIO(json.dumps(request) + "\n"), stdout=stdout)
    (reply,) = [json.loads(line) for line in stdout.getvalue().splitlines()]
    assert reply["id"] == 7 and "error" not in reply and stats["served"] == 1
    assert ("fused" in reply) if fused else ("detections" in reply)
