"""The port's YOLOv8 (model, weight bridge, decode, selection, letterbox,
checkpoint loading) against the JAX package on the CPU, at small canvases."""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfa3d_tpu.models import yolov8 as jyolo
from sfa3d_tpu_torch.models.port import yolo_state_dict_from_jax
from sfa3d_tpu_torch.models.yolov8 import (
    YOLOv8,
    YOLOv8Detector,
    decode_predictions,
    forward_levels,
    infer_yolo_meta,
    letterbox,
    load_yolo_checkpoint,
    scale_depths,
    scale_widths,
    select_detections,
)

HEADS_TOL = 1e-4  # float32 conv sums in another order than XLA's
# decoded px: the DFL expectation's few-ulp differences (exp, the 16-bin sum
# in another order) times strides up to 32, plus 2 float32 ulps of a
# coordinate that reaches ~1000 px
DECODE_ATOL, DECODE_RTOL = 1e-4, 2.4e-7


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's side runs on one intra-op thread. In this test process
    (after the forward tests, JAX's 8-device CPU client and cv2 loaded), the
    first contiguous float32 `torch.exp` large enough for MKL's threaded
    vector math comes back with one of its eight chunks accurate to only
    1.5e-4 relative (6e-8 on later calls and on one thread): the DFL decode
    then drifts by up to 1.9e-3 px. One thread keeps that path off."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _perturbed_variables(model, shape, seed):
    """JAX init with BatchNorm statistics, affine terms and biases drawn at
    random, so that every parameter's mapping is exercised."""
    variables = model.init(jax.random.PRNGKey(seed), jnp.zeros(shape, jnp.float32), train=False)
    variables = jax.tree_util.tree_map(lambda t: np.array(t), variables)
    rng = np.random.default_rng(seed + 10)

    def perturb(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                perturb(v)
            elif k in ("var", "scale"):
                tree[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif k in ("mean", "bias"):
                tree[k] = (v + rng.normal(0, 0.1, v.shape)).astype(np.float32)

    perturb(variables)
    return variables


@pytest.fixture(scope="module")
def yolo_pair():
    jmodel = jyolo.YOLOv8(scale="n", num_classes=80)
    variables = _perturbed_variables(jmodel, (1, 64, 64, 3), 1)
    model = YOLOv8("n", 80)
    model.load_state_dict(yolo_state_dict_from_jax(variables, "n", 80), strict=True)
    return jmodel, variables, model.eval()


def test_widths_and_depths_are_the_published_n_scale():
    assert scale_widths("n") == [16, 32, 64, 128, 256]
    assert scale_depths("n") == [1, 2, 2, 1]
    assert scale_widths("n") == jyolo.YOLOv8(scale="n").widths()


@pytest.mark.parametrize("num_classes", [80, 3])
def test_yolo_state_dict_from_jax_equals_export(num_classes):
    jmodel = jyolo.YOLOv8(scale="n", num_classes=num_classes)
    variables = _perturbed_variables(jmodel, (1, 64, 64, 3), 2)
    ours = yolo_state_dict_from_jax(variables, "n", num_classes)
    ref = jyolo.export_ultralytics_state_dict(variables, "n", num_classes)
    assert list(ours) == list(ref)
    for k, v in ref.items():
        assert ours[k].dtype == (torch.int64 if k.endswith("num_batches_tracked") else torch.float32), k
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    model = YOLOv8("n", num_classes)
    model.load_state_dict(ours, strict=True)
    assert set(model.state_dict()) == set(ref)


@pytest.mark.parametrize("hw", [(64, 64), (96, 160)], ids=["64x64", "96x160"])
def test_yolo_heads_match_jax(yolo_pair, rng, hw):
    jmodel, variables, model = yolo_pair
    images = rng.uniform(0, 1, (2, *hw, 3)).astype(np.float32)
    want = jmodel.apply(variables, jnp.asarray(images), train=False)
    with torch.inference_mode():
        got = forward_levels(model, torch.from_numpy(images))
    assert len(got) == len(want) == 3
    for lvl, ((gb, gc), (wb, wc)) in enumerate(zip(got, want)):
        stride = 8 * 2 ** lvl
        assert gb.shape == wb.shape == (2, hw[0] // stride, hw[1] // stride, 64)
        assert gc.shape == wc.shape == (2, hw[0] // stride, hw[1] // stride, 80)
        np.testing.assert_allclose(gb.numpy(), np.asarray(wb), rtol=0, atol=HEADS_TOL, err_msg=f"box {lvl}")
        np.testing.assert_allclose(gc.numpy(), np.asarray(wc), rtol=0, atol=HEADS_TOL, err_msg=f"cls {lvl}")


def test_decode_predictions_matches_jax(rng):
    levels = [(rng.normal(0, 2, (2, h, w, 64)).astype(np.float32),
               rng.normal(0, 2, (2, h, w, 5)).astype(np.float32))
              for h, w in ((8, 20), (4, 10), (2, 5))]
    wb, ws = jyolo.decode_predictions([(jnp.asarray(b), jnp.asarray(c)) for b, c in levels])
    gb, gs = decode_predictions([(torch.from_numpy(b), torch.from_numpy(c)) for b, c in levels])
    assert gb.shape == wb.shape == (2, 210, 4)
    assert gs.shape == ws.shape == (2, 210, 5)
    np.testing.assert_allclose(gb.numpy(), np.asarray(wb), rtol=DECODE_RTOL, atol=DECODE_ATOL)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=0, atol=1e-6)


def _candidates(rng, a, c):
    """Crowded candidates: anchors on a coarse grid (many overlaps), a few
    exactly tied confidences, some classes shared."""
    xy = rng.integers(0, 12, (a, 2)).astype(np.float32) * 8
    wh = rng.uniform(8, 40, (a, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], 1)
    scores = rng.uniform(0, 1, (a, c)).astype(np.float32) ** 3
    scores[::7, 0] = 0.75  # ties across anchors
    return boxes, scores


@pytest.mark.parametrize("max_det,pre_nms", [(16, 0), (100, 0), (8, 24)])
def test_select_detections_matches_jax(rng, max_det, pre_nms):
    boxes, scores = zip(*[_candidates(rng, 300, 4) for _ in range(2)])
    boxes, scores = np.stack(boxes), np.stack(scores)
    got = select_detections(torch.from_numpy(boxes), torch.from_numpy(scores), conf_thresh=0.25,
                            iou_thresh=0.45, max_det=max_det, pre_nms=pre_nms)
    got = [t.numpy() for t in got]
    n_valid = 0
    for f in range(2):
        want = [np.asarray(t) for t in jyolo.select_detections(
            jnp.asarray(boxes[f]), jnp.asarray(scores[f]), conf_thresh=0.25, iou_thresh=0.45,
            max_det=max_det, pre_nms=pre_nms)]
        v = want[3]
        np.testing.assert_array_equal(got[3][f], v)
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(g[f][v], w[v])
        n_valid += int(v.sum())
    assert n_valid > 0, "no detection survived; the test would be vacuous"
    # one image at a time gives the same as the batch
    single = select_detections(torch.from_numpy(boxes[1]), torch.from_numpy(scores[1]),
                               max_det=max_det, pre_nms=pre_nms)
    for g, s in zip(got, single):
        np.testing.assert_array_equal(g[1], s.numpy())


@pytest.mark.parametrize("src_hw,canvas", [((375, 1242), (224, 640)), ((375, 1242), 640),
                                           ((120, 200), (128, 224)), ((64, 64), 64)],
                         ids=["kitti_rect", "kitti_square", "upscale", "no_resize"])
def test_letterbox_matches_cv2_version(rng, src_hw, canvas):
    img = rng.integers(0, 256, (*src_hw, 3)).astype(np.uint8)
    img[: src_hw[0] // 2] = cv2.GaussianBlur(img[: src_hw[0] // 2], (9, 9), 3)  # smooth + noisy halves
    got, r, pad = letterbox(img, canvas)
    want, wr, wpad = jyolo.letterbox(img, canvas)
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    assert r == wr and pad == wpad
    np.testing.assert_array_equal(got, want)  # the uint8 resize is cv2's, bit for bit
    if canvas == (224, 640):
        assert got.shape == (224, 640, 3) and pad == (0, 15)
    fimg = img.astype(np.float32) / 255.0  # float images: cv2's float path
    np.testing.assert_allclose(letterbox(fimg, canvas)[0], jyolo.letterbox(fimg, canvas)[0],
                               rtol=0, atol=2e-6)


def _resize_cases():
    rng = np.random.default_rng(5)
    cases = [((375, 1242, 3), (214, 640)), ((200, 300, 3), (100, 150)), ((120, 200, 3), (128, 213)),
             ((7, 5), (31, 2)), ((1, 9, 3), (4, 1)), ((64, 64, 4), (64, 65))]
    for _ in range(40):  # random sizes, up- and downscaling on either axis
        h, w, nh, nw = (int(v) for v in rng.integers(1, 400, 4))
        cases.append(((h, w, 3), (nh, nw)))
    return cases


@pytest.mark.parametrize("chunk", range(4))
def test_resize_uint8_equals_cv2(chunk):
    from sfa3d_tpu_torch.models.yolov8 import _resize_bilinear

    rng = np.random.default_rng(chunk)
    for shape, (nh, nw) in _resize_cases()[chunk::4]:
        img = rng.integers(0, 256, shape).astype(np.uint8)
        got = _resize_bilinear(img, nh, nw)
        want = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR).reshape(got.shape)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want, err_msg=f"{shape} -> {(nh, nw)}")


def test_checkpoint_round_trip(tmp_path):
    jmodel = jyolo.YOLOv8(scale="n", num_classes=3)
    variables = _perturbed_variables(jmodel, (1, 64, 64, 3), 4)
    sd = yolo_state_dict_from_jax(variables, "n", 3)
    assert infer_yolo_meta(sd) == ("n", 3)
    layouts = {
        "raw.pt": dict(sd),
        "wrapped.pt": {"model": dict(sd)},
        "yolo_wrapper.pt": {**{f"model.{k}": v for k, v in sd.items()},
                            "criterion.bce.weight": torch.ones(1)},
    }
    for name, obj in layouts.items():
        torch.save(obj, tmp_path / name)
        model = load_yolo_checkpoint(str(tmp_path / name))
        assert (model.scale, model.num_classes) == ("n", 3)
        for k, v in model.state_dict().items():
            assert torch.equal(v, sd[k]), (name, k)
    # the JAX importer reads the port's file
    jvars = jyolo.load_yolo_variables(str(tmp_path / "raw.pt"))
    np.testing.assert_array_equal(np.asarray(jvars["params"]["stem"]["conv"]["kernel"]),
                                  np.asarray(variables["params"]["stem"]["conv"]["kernel"]))
    torch.save({"model": YOLOv8("n", 3)}, tmp_path / "pickled.pt")
    with pytest.raises(ValueError, match="ultralytics"):
        load_yolo_checkpoint(str(tmp_path / "pickled.pt"))
    with pytest.raises(FileNotFoundError):
        load_yolo_checkpoint(str(tmp_path / "missing.pt"))


def test_detector_runs_on_cpu_and_undoes_the_letterbox(rng):
    det = YOLOv8Detector(device="cpu", imgsz=(64, 96), max_det=20, seed=3)
    img = rng.integers(0, 256, (90, 150, 3)).astype(np.uint8)
    boxes, scores, classes = det(img, conf=0.25)
    assert len(boxes) == len(scores) == len(classes) > 0
    for (x, y, w, h), s, c in zip(boxes, scores, classes):
        assert 0 <= x <= 150 and 0 <= y <= 90 and w >= 0 and h >= 0 and x + w <= 150 and y + h <= 90
        assert s >= 0.25 and 0 <= c < 80
    assert not det.model.training
