"""The port's fusion layer (IoU, the three loop functions, projection, the
fusers, rescoring, calibration, fuse_frame) against the JAX package on the
CPU. On the CPU the loop entries run their plain PyTorch versions, the ones
`chip_smoke.py` holds the CUDA kernels against on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfa3d_tpu.fusion import boxes2d as jboxes2d
from sfa3d_tpu.fusion import fuse as jfuse
from sfa3d_tpu.fusion import iou as jiou
from sfa3d_tpu.fusion import nms as jnms
from sfa3d_tpu.fusion.pipeline import fuse_frame as jfuse_frame
from sfa3d_tpu.geometry import calibration as jcalib
from sfa3d_tpu.geometry import transforms as jtransforms
from sfa3d_tpu_torch.fusion import boxes2d, fuse, nms
from sfa3d_tpu_torch.fusion.iou import iou_xywh, pairwise_iou_xywh
from sfa3d_tpu_torch.fusion.pipeline import fuse_frame
from sfa3d_tpu_torch.geometry.calibration import KittiCalibration, read_calib_file
from sfa3d_tpu_torch.geometry.transforms import lidar_to_camera_box
from sfa3d_tpu_torch.ops import fusion_loops

ULP1 = 1.2e-7  # one float32 ulp below 1: XLA:CPU's FMA contraction inside a jitted IoU
# soft-NMS scores: XLA's exp and PyTorch's differ by an ulp or two, and each
# step's decay multiplies into the score (the masks and indices are exact)
SOFT_NMS_RTOL = 1e-6
# A fused coordinate is a weighted mean truncated to an integer. Where its
# exact value is an integer (YOLO and SFA boxes sharing a coordinate),
# XLA:CPU's fused multiply-add and the port's separately rounded steps can
# land one ulp apart on either side of it, and the truncation one pixel
# apart. Such a 1 px difference is allowed only where the port's
# untruncated value lies within TRUNC_EDGE of an integer.
TRUNC_EDGE = 1e-3
T = torch.from_numpy


def _boxes(rng, n, grid=False):
    if grid:  # coarse positions: many overlaps and exact ties of IoU
        xy = rng.integers(0, 10, (n, 2)).astype(np.float32) * 10
    else:
        xy = rng.uniform(0, 200, (n, 2)).astype(np.float32)
    return np.concatenate([xy, rng.uniform(4, 60, (n, 2)).astype(np.float32)], 1)


def _loop_case(rng, name, b, k):
    boxes = np.stack([_boxes(rng, k, grid=name == "grid") for _ in range(b)])
    scores = rng.uniform(0, 1, (b, k)).astype(np.float32)
    valid = rng.random((b, k)) < 0.8
    if name == "equal_scores":
        scores[:] = 0.5
    if name == "all_invalid":
        valid[1] = False
    if name == "duplicates":  # identical boxes: IoU exactly 1
        boxes[:, 1::2] = boxes[:, ::2][:, : k // 2]
    if name == "select_candidates":  # class-offset boxes of the YOLO NMS
        cls = rng.integers(0, 3, (b, k)).astype(np.float32)
        boxes[..., :2] += cls[..., None] * 4096.0
        scores = np.sort(scores, axis=1)[:, ::-1].copy()
    return boxes, scores, valid


LOOP_CASES = [("random", 3, 114), ("equal_scores", 2, 114), ("all_invalid", 3, 64),
              ("duplicates", 2, 50), ("grid", 2, 100), ("select_candidates", 2, 256)]


def test_pairwise_iou_matches_jax():
    rng = np.random.default_rng(0)
    b1, b2 = _boxes(rng, 300), _boxes(rng, 200, grid=True)
    b1[:20, 2:] = 0  # degenerate boxes: union 0 -> IoU 0
    b2[:10] = b2[10:20]  # duplicates
    b2[20:30, 0] = b2[30:40, 0] + b2[30:40, 2]  # touching edges
    got = pairwise_iou_xywh(T(b1), T(b2)).numpy()
    with jax.disable_jit():  # op by op: every step rounded on its own
        want = np.asarray(jiou.pairwise_iou_xywh(jnp.asarray(b1), jnp.asarray(b2)))
    np.testing.assert_array_equal(got, want)
    jitted = np.asarray(jax.jit(jiou.pairwise_iou_xywh)(b1, b2))
    np.testing.assert_allclose(got, jitted, rtol=0, atol=ULP1)
    batched = pairwise_iou_xywh(T(np.stack([b1, b1])), T(np.stack([b2, b2]))).numpy()
    np.testing.assert_array_equal(batched[1], got)
    assert float(iou_xywh([0, 0, 10, 10], [5, 0, 10, 10])) == pytest.approx(1 / 3)
    assert float(iou_xywh([0, 0, 0, 0], [0, 0, 0, 0])) == 0.0


@pytest.mark.parametrize("name,b,k", LOOP_CASES, ids=[c[0] for c in LOOP_CASES])
def test_loop_functions_match_jax(name, b, k):
    rng = np.random.default_rng(sum(map(ord, name)))
    boxes, scores, valid = _loop_case(rng, name, b, k)
    keep = nms.hard_nms(T(boxes), T(scores), T(valid), 0.45).numpy()
    soft, surv = (t.numpy() for t in nms.soft_nms_gaussian(T(boxes), T(scores), T(valid)))
    jhard = jax.jit(jnms.hard_nms)
    for f in range(b):
        np.testing.assert_array_equal(keep[f], np.asarray(jhard(boxes[f], scores[f], valid[f], 0.45)))
        ws, wv = (np.asarray(t) for t in jnms.soft_nms_gaussian(boxes[f], scores[f], valid[f]))
        np.testing.assert_array_equal(surv[f], wv)
        np.testing.assert_allclose(soft[f], ws, rtol=SOFT_NMS_RTOL, atol=1e-12)
    if name == "all_invalid":
        assert not keep[1].any() and not surv[1].any() and not soft[1].any()
    else:
        assert keep.any() and (~keep & valid).any(), "nothing suppressed: vacuous"

    # the match: YOLO boxes near the SFA ones, so some pairs clear 0.5
    ks = min(k, 50)
    sfa = boxes[:, :ks] + rng.normal(0, 3, (b, ks, 4)).astype(np.float32)
    sfa_valid = rng.random((b, ks)) < 0.8
    if name == "all_invalid":
        sfa_valid[1] = False
    idx, matched = (t.numpy() for t in fusion_loops.greedy_match(
        T(boxes), T(valid), T(sfa), T(sfa_valid), 0.5))
    for f in range(b):
        want_idx, want_m = (np.asarray(t) for t in jfuse.greedy_match(
            jfuse.DetectionSet(boxes[f], scores[f], np.zeros(k, np.int32), valid[f]),
            jfuse.DetectionSet(sfa[f], scores[f, :ks], np.zeros(ks, np.int32), sfa_valid[f]), 0.5))
        np.testing.assert_array_equal(idx[f], want_idx)
        np.testing.assert_array_equal(matched[f], want_m)
    if name != "all_invalid":
        assert (idx >= 0).any(), "no match: vacuous"


def test_single_frame_calls_equal_the_batch():
    rng = np.random.default_rng(5)
    boxes, scores, valid = _loop_case(rng, "random", 2, 40)
    keep = nms.hard_nms(T(boxes), T(scores), T(valid), 0.5)
    soft = nms.soft_nms_gaussian(T(boxes), T(scores), T(valid))
    assert torch.equal(nms.hard_nms(T(boxes[1]), T(scores[1]), T(valid[1]), 0.5), keep[1])
    one = nms.soft_nms_gaussian(T(boxes[1]), T(scores[1]), T(valid[1]))
    assert torch.equal(one[0], soft[0][1]) and torch.equal(one[1], soft[1][1])


def test_soft_nms_decay_multiplies_by_the_float32_reciprocal():
    """The fused JAX program divides by a constant sigma, which XLA compiles
    as a multiplication by float32(1 / sigma); the port does the same."""
    rng = np.random.default_rng(7)
    boxes, scores, valid = _loop_case(rng, "grid", 1, 80)
    got_s, got_v = (t.numpy()[0] for t in nms.soft_nms_gaussian(T(boxes), T(scores), T(valid), sigma=0.3))
    fused_form = jax.jit(lambda b, s, v: jnms.soft_nms_gaussian(b, s, v, sigma=0.3))
    want_s, want_v = (np.asarray(t) for t in fused_form(boxes[0], scores[0], valid[0]))
    np.testing.assert_array_equal(got_v, want_v)
    np.testing.assert_allclose(got_s, want_s, rtol=SOFT_NMS_RTOL, atol=1e-12)
    assert fusion_loops.inv_sigma(0.5) == 2.0
    assert fusion_loops.inv_sigma(0.3) == float(np.float32(1 / 0.3))


def test_greedy_match_ties_take_the_lowest_index():
    yolo = np.asarray([[10, 10, 20, 20], [10, 10, 20, 20], [100, 100, 5, 5]], np.float32)
    sfa = np.asarray([[0, 0, 1, 1], [10, 10, 20, 20], [10, 10, 20, 20]], np.float32)
    idx, matched = fusion_loops.greedy_match(T(yolo[None]), T(np.ones((1, 3), bool)),
                                             T(sfa[None]), T(np.ones((1, 3), bool)), 0.7)
    assert idx.tolist() == [[1, 2, -1]] and matched.tolist() == [[False, True, True]]
    # threshold 0 still needs a positive IoU
    idx, _ = fusion_loops.greedy_match(T(yolo[None, 2:]), T(np.ones((1, 1), bool)),
                                       T(sfa[None]), T(np.ones((1, 3), bool)), 0.0)
    assert idx.tolist() == [[-1]]


def _sets(rng, b, ky=16, ks=12, scale=200.0):
    yb = _boxes(rng, ky * b).reshape(b, ky, 4)
    sb = np.concatenate([yb[:, :ks, :2] + rng.normal(0, 2, (b, ks, 2)), yb[:, :ks, 2:]], -1)
    sb = np.trunc(sb).astype(np.float32)
    yb = np.trunc(yb)
    ys = rng.uniform(0, 1, (b, ky)).astype(np.float32)
    ss = rng.uniform(0, 1, (b, ks)).astype(np.float32)
    ys[:, 0], ss[:, 0] = 0.0, 0.0  # zero total confidence: equal weights
    yc = rng.integers(0, 3, (b, ky)).astype(np.int32)
    sc = rng.integers(0, 3, (b, ks)).astype(np.int32)
    yv, sv = rng.random((b, ky)) < 0.9, rng.random((b, ks)) < 0.9
    return (yb, ys, yc, yv), (sb, ss, sc, sv)


def _jset(a, f):
    return jfuse.DetectionSet(*(jnp.asarray(x[f]) for x in a))


def _tset(a):
    return fuse.DetectionSet(*(T(np.ascontiguousarray(x)) for x in a))


def assert_truncated_equal(got, want, untruncated):
    """Integer boxes equal, except 1 px where the exact value sits on an
    integer (see TRUNC_EDGE). Returns the number of such elements."""
    off = got != want
    if off.any():
        assert np.all(np.abs(got[off] - want[off]) == 1), (got[off], want[off])
        u = untruncated[off]
        assert np.all(np.abs(u - np.round(u)) < TRUNC_EDGE), u
    return int(off.sum())


@pytest.mark.parametrize("fuser,thr", [("fuse_weighted", 0.5), ("fuse_bayesian", 0.5),
                                       ("fuse_union_nms", 0.3)])
def test_fusers_match_jax(fuser, thr, monkeypatch):
    rng = np.random.default_rng(11)
    y, s = _sets(rng, 3)
    got, got_src = getattr(fuse, fuser)(_tset(y), _tset(s), thr)
    with monkeypatch.context() as m:
        m.setattr(torch, "trunc", lambda t: t)
        untruncated = getattr(fuse, fuser)(_tset(y), _tset(s), thr)[0].boxes.numpy()
    n_fused = 0
    for f in range(3):
        want, want_src = getattr(jfuse, fuser)(_jset(y, f), _jset(s, f), thr)
        np.testing.assert_array_equal(got_src[f].numpy(), np.asarray(want_src))
        np.testing.assert_array_equal(got.valid[f].numpy(), np.asarray(want.valid))
        np.testing.assert_array_equal(got.classes[f].numpy(), np.asarray(want.classes))
        assert_truncated_equal(got.boxes[f].numpy(), np.asarray(want.boxes), untruncated[f])
        np.testing.assert_array_equal(got.scores[f].numpy(), np.asarray(want.scores))
        n_fused += int((np.asarray(want_src) == 2).sum()) + int((~np.asarray(want.valid)).sum())
    assert n_fused > 0, "no pair fused and nothing suppressed: vacuous"
    one, one_src = getattr(fuse, fuser)(_tset([a[2] for a in y]), _tset([a[2] for a in s]), thr)
    assert torch.equal(one.boxes, got.boxes[2]) and torch.equal(one_src, got_src[2])


def test_fusion_arithmetic_matches_jax():
    c = np.linspace(0, 1, 101).astype(np.float32)
    for mv in (100.0, 50.0):
        np.testing.assert_array_equal(fuse.confidence_to_variance(T(c), mv).numpy(),
                                      np.asarray(jfuse.confidence_to_variance(c, mv)))
    rng = np.random.default_rng(3)
    m1, m2 = rng.uniform(0, 500, (2, 64)).astype(np.float32)
    v1, v2 = rng.uniform(0, 5000, (2, 64)).astype(np.float32)
    v1[:4] = 0.0
    got = fuse.fuse_gaussian_parameters(T(m1), T(v1), T(m2), T(v2))
    with jax.disable_jit():
        want = jfuse.fuse_gaussian_parameters(m1, v1, m2, v2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("mode", ["max", "demote"])
def test_rescore_3d_from_camera_matches_jax(mode):
    rng = np.random.default_rng(13)
    cam, sfa2d = _sets(rng, 2)
    s3 = rng.uniform(0, 1, (2, sfa2d[0].shape[1])).astype(np.float32)
    got = fuse.rescore_3d_from_camera(_tset(cam), _tset(sfa2d), T(s3), 0.5, mode=mode).numpy()
    for f in range(2):
        want = jfuse.rescore_3d_from_camera(_jset(cam, f), _jset(sfa2d, f), jnp.asarray(s3[f]), 0.5,
                                            mode=mode)
        np.testing.assert_array_equal(got[f], np.asarray(want))
    assert (got != s3).any(), "no score changed: vacuous"
    with pytest.raises(ValueError, match="unknown rescore mode"):
        fuse.rescore_3d_from_camera(_tset(cam), _tset(sfa2d), T(s3), mode="min")


def _boxes_real(rng, k):
    cls = rng.integers(0, 3, k).astype(np.float32)
    x = rng.uniform(3, 45, k)
    y = rng.uniform(-15, 15, k)
    z = rng.uniform(-1.8, -1.2, k)
    hwl = np.stack([rng.uniform(1.4, 1.8, k), rng.uniform(1.5, 2.0, k), rng.uniform(3.5, 4.5, k)], 1)
    yaw = rng.uniform(-np.pi, np.pi, k)
    real = np.concatenate([cls[:, None], x[:, None], y[:, None], z[:, None], hwl, yaw[:, None]], 1)
    real[0, 1:4] = [0.2, 0.0, -1.0]  # straddles the camera plane: dropped
    real[1, 1:4] = [-5.0, 1.0, -1.0]  # behind the camera
    return real.astype(np.float32)


def test_project_boxes_to_image_matches_jax():
    rng = np.random.default_rng(17)
    calib = KittiCalibration(None)
    k = 40
    real = np.stack([_boxes_real(rng, k) for _ in range(2)])
    scores = rng.uniform(0, 1, (2, k)).astype(np.float32)
    mask = rng.random((2, k)) < 0.9
    mats = [np.tile(np.asarray(m, np.float32)[None], (2, 1, 1)) for m in (calib.V2C, calib.R0, calib.P2)]
    hw = np.float32([[375, 1242], [300, 1000]])
    got, got_v = boxes2d.project_boxes_to_image(T(real), T(scores), T(mask), *map(T, mats),
                                                img_h=T(hw[:, 0]), img_w=T(hw[:, 1]), conf_gate=0.2)
    got, got_v = got.numpy(), got_v.numpy()
    for f in range(2):
        want, want_v = (np.asarray(t) for t in jboxes2d.project_boxes_to_image(
            real[f], scores[f], mask[f], calib.V2C, calib.R0, calib.P2,
            img_h=hw[f, 0], img_w=hw[f, 1], conf_gate=0.2))
        np.testing.assert_array_equal(got_v[f], want_v)
        np.testing.assert_array_equal(got[f], want)
        assert not want_v[:2].any()  # the box at the camera plane and the one behind
    assert got_v.sum() > 10
    one, one_v = boxes2d.project_boxes_to_image(T(real[0]), T(scores[0]), T(mask[0]), calib.V2C,
                                                calib.R0, calib.P2, img_h=375, img_w=1242,
                                                conf_gate=0.2)
    assert torch.equal(one_v, T(got_v[0])) and np.array_equal(one.numpy(), got[0])


def test_lidar_to_camera_box_matches_jax():
    rng = np.random.default_rng(19)
    real = _boxes_real(rng, 30)[:, 1:]
    calib = KittiCalibration(None)
    got = lidar_to_camera_box(T(real), T(calib.V2C.astype(np.float32)), T(calib.R0.astype(np.float32)))
    want = jtransforms.lidar_to_camera_box(jnp.asarray(real), jnp.asarray(calib.V2C, jnp.float32),
                                           jnp.asarray(calib.R0, jnp.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    default = lidar_to_camera_box(T(real))
    np.testing.assert_allclose(default.numpy(), got.numpy(), rtol=0, atol=1e-5)


def test_calibration_matches_jax(tmp_path):
    path = tmp_path / "000001.txt"
    rows = {"P0": np.arange(12.0), "P2": np.arange(12.0) + 0.5, "R0_rect": np.eye(3).ravel() * 0.9,
            "Tr_velo_to_cam": np.arange(12.0) / 7}
    path.write_text("\n".join(f"{k}: " + " ".join(f"{v:.9e}" for v in vals) for k, vals in rows.items())
                    + "\n\n# note: 1 2\nbad line\n")
    got, want = read_calib_file(str(path)), jcalib.read_calib_file(str(path))
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    for p in (str(path), None):
        a, b = KittiCalibration(p), jcalib.KittiCalibration(p)
        for attr in ("P2", "P3", "V2C", "R0", "f_u", "b_x"):
            np.testing.assert_array_equal(getattr(a, attr), getattr(b, attr))
    pts = np.random.default_rng(1).uniform(5, 40, (8, 3))
    np.testing.assert_array_equal(KittiCalibration(None).project_velo_to_image(pts),
                                  jcalib.KittiCalibration(None).project_velo_to_image(pts))
    c = KittiCalibration(None)
    c.set_matrices(P2=np.ones((3, 4)))
    assert c.f_u == 1.0


@pytest.mark.parametrize("mode,gnms", [("bayesian", True), ("bayesian", False), ("weighted", False),
                                       ("nms", False)])
def test_fuse_frame_matches_jax(mode, gnms):
    rng = np.random.default_rng(23)
    calib = KittiCalibration(None)
    real = _boxes_real(rng, 50)
    scores = rng.uniform(0, 1, 50).astype(np.float32)
    mask = scores > 0.2
    # YOLO boxes where the 3D boxes project, jittered, plus clutter
    sfa2d, v = boxes2d.project_boxes_to_image(T(real), T(scores), T(mask), calib.V2C, calib.R0,
                                              calib.P2, img_h=375, img_w=1242, conf_gate=0.2)
    # nonzero integer offsets: no fused mean is exactly an integer (TRUNC_EDGE)
    jitter = rng.choice([-3, -2, -1, 1, 2, 3], (min(20, int(v.sum())), 4))
    near = sfa2d.numpy()[v.numpy()][:20] + jitter
    yolo = np.concatenate([near, np.trunc(_boxes(rng, 10))]).astype(int).tolist()
    ys = rng.uniform(0.2, 1, len(yolo)).tolist()
    yc = rng.integers(0, 3, len(yolo)).tolist()
    kw = dict(mode=mode, use_gaussian_nms=gnms, sfa_conf_gate=0.2, max_yolo=32)
    got = fuse_frame(yolo, ys, yc, real, scores, mask, calib, (375, 1242), device="cpu", **kw)
    want = jfuse_frame(yolo, ys, yc, real, scores, mask, calib, (375, 1242), **kw)
    for key in ("boxes", "classes", "source"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=SOFT_NMS_RTOL, atol=1e-12)
    if mode != "nms":
        assert (got["source"] == 2).any(), "no fused pair: vacuous"
    with pytest.raises(ValueError, match="mode must be one of"):
        fuse_frame(yolo, ys, yc, real, scores, mask, calib, (375, 1242), mode="vote", device="cpu")
