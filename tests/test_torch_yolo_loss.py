"""The port's YOLOv8 loss (`losses/yolo_loss.py`: anchors, CIoU, the
task-aligned assigner, DFL, the v8 loss) against the JAX package's on the
CPU, on numpy-seeded head outputs at a 64 x 128 canvas.

- The assignment (fg_mask, target_gt_idx) is exact, also on crafted ties
  (anchors with identical predictions; two identical ground-truth boxes).
- float32: the loss terms within 1e-6 relative (atan, pow, exp and log
  differ by an ulp between XLA and PyTorch; sums run in another order;
  XLA's float32 atan is not correctly rounded, PyTorch's nearly is).
- float64: the loss terms within 1e-10 relative, and the gradients with
  respect to the level outputs within 1e-10 of their largest. The JAX loss
  and DFL expectation pin float32 (`astype(jnp.float32)`, float32 anchors
  and bins), which in float64 rounds every value to float32; the float64
  comparison lifts those pins (`jax_float64`: the two modules' `jnp` with
  float32 spelled float64, under a scoped `jax.enable_x64`), which changes
  nothing in float32. The float64 ground-truth boxes are float64 too.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfa3d_tpu.losses import yolo_loss as jloss
from sfa3d_tpu.models import yolov8 as jyolo
from sfa3d_tpu_torch.losses import yolo_loss as ploss

HW = (64, 128)
C, G = 3, 6
F32_RTOL, F64_RTOL = 1e-6, 1e-10


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's side runs on one intra-op thread: these tensors are small,
    and in a loaded multi-worker run more threads only wait on each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Float64Pins:
    """jax.numpy with `float32` spelled `float64`."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@contextlib.contextmanager
def jax_float64():
    """x64 on, and the float32 pins of the JAX YOLO model and loss lifted
    to float64, for the duration of the block."""
    saved = jyolo.jnp, jloss.jnp
    jyolo.jnp = jloss.jnp = _Float64Pins()
    try:
        with jax.enable_x64(True):
            yield
    finally:
        jyolo.jnp, jloss.jnp = saved


def level_outputs(rng, b, dtype):
    """Per level (box_logits (b, h, w, 64), cls_logits (b, h, w, C)), NHWC."""
    out = []
    for s in (8, 16, 32):
        h, w = HW[0] // s, HW[1] // s
        out.append((rng.normal(0, 2, (b, h, w, 64)).astype(dtype), rng.normal(-1, 2, (b, h, w, C)).astype(dtype)))
    return out


def ground_truth(rng, b):
    """(b, G, 4) xyxy pixel boxes, labels, mask (two padded slots a frame)."""
    xy = rng.uniform(0, [HW[1] - 8, HW[0] - 8], (b, G, 2))
    wh = rng.uniform(6, 48, (b, G, 2))
    boxes = np.concatenate([xy, np.minimum(xy + wh, [HW[1], HW[0]])], -1).astype(np.float32)
    labels = rng.integers(0, C, (b, G)).astype(np.int32)
    mask = np.ones((b, G), bool)
    mask[:, -2:] = False
    return boxes, labels, mask


def _torch_levels(levels, grad=False):
    return [(torch.tensor(bx, requires_grad=grad), torch.tensor(cl, requires_grad=grad)) for bx, cl in levels]


def _jax_loss(levels, gt):
    return jloss.yolo_loss([(jnp.asarray(bx), jnp.asarray(cl)) for bx, cl in levels],
                           *(jnp.asarray(a) for a in gt), imgsz=HW)


def test_anchors_equal_jax():
    want = jloss.make_anchors(HW)
    got = ploss.make_anchors(HW)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_ciou_matches_jax(dtype):
    rng = np.random.default_rng(1)
    a = np.sort(rng.uniform(0, 50, (500, 2, 2)), axis=1).reshape(500, 4)[:, [0, 2, 1, 3]].astype(dtype)
    b = np.sort(rng.uniform(0, 50, (500, 2, 2)), axis=1).reshape(500, 4)[:, [0, 2, 1, 3]].astype(dtype)
    ctx = jax.enable_x64(True) if dtype == np.float64 else contextlib.nullcontext()
    with ctx:
        for kind in ("iou", "ciou"):
            want = np.asarray(jloss.iou_xyxy(jnp.asarray(a), jnp.asarray(b), kind=kind))
            got = ploss.iou_xyxy(torch.from_numpy(a), torch.from_numpy(b), kind=kind).numpy()
            tol = 1e-6 if dtype == np.float32 else 1e-13
            np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max(), err_msg=kind)


def _assign_inputs(rng, b, dtype, tie=False):
    n_anchor = sum((HW[0] // s) * (HW[1] // s) for s in (8, 16, 32))
    anc, strides = (np.asarray(t) for t in jloss.make_anchors(HW))
    anc_px = (anc * strides[:, None]).astype(np.float32)
    scores = rng.uniform(0, 1, (b, n_anchor, C)).astype(dtype)
    centres = anc_px[None] + rng.normal(0, 3, (b, n_anchor, 2))
    half = rng.uniform(4, 30, (b, n_anchor, 2))
    pd = np.concatenate([centres - half, centres + half], -1).astype(dtype)
    boxes, labels, mask = ground_truth(rng, b)
    if tie:
        # every anchor inside box 0 of frame 0 predicts that box with the same
        # scores (their align metrics tie: the top 10 are the 10 lowest
        # indices), and boxes 1 and 2 of each frame are one box with one
        # label (every anchor they both claim is a tie of overlaps)
        boxes[0, 0] = (20.0, 8.0, 76.0, 56.0)
        inside = ((anc_px[:, 0] > 20) & (anc_px[:, 0] < 76) & (anc_px[:, 1] > 8) & (anc_px[:, 1] < 56))
        scores[0, inside] = scores[0, 0]
        pd[0, inside] = boxes[0, 0] + np.float32(1.5)
        boxes[:, 2], labels[:, 2] = boxes[:, 1], labels[:, 1]
    return scores, pd, anc_px, labels, boxes, mask


@pytest.mark.parametrize("dtype,tie", [(np.float32, False), (np.float64, False), (np.float32, True)])
def test_assigner_matches_jax(dtype, tie):
    rng = np.random.default_rng(2)
    inputs = _assign_inputs(rng, 3, dtype, tie)
    ctx = jax.enable_x64(True) if dtype == np.float64 else contextlib.nullcontext()
    with ctx:
        want = {k: np.asarray(v) for k, v in jloss.task_aligned_assign(*(jnp.asarray(a) for a in inputs)).items()}
    got = {k: v.numpy() for k, v in ploss.task_aligned_assign(*(torch.from_numpy(a) for a in inputs)).items()}
    assert want["fg_mask"].sum() > 20
    np.testing.assert_array_equal(got["fg_mask"], want["fg_mask"])
    np.testing.assert_array_equal(got["target_gt_idx"], want["target_gt_idx"])
    np.testing.assert_array_equal(got["target_bboxes"], want["target_bboxes"])
    tol = 1e-6 if dtype == np.float32 else 1e-12
    np.testing.assert_allclose(got["target_scores"], want["target_scores"], rtol=0,
                               atol=tol * want["target_scores"].max())
    if tie:  # the ties were decided by the lower index
        anc = inputs[2]
        inside = np.flatnonzero((anc[:, 0] > 20) & (anc[:, 0] < 76) & (anc[:, 1] > 8) & (anc[:, 1] < 56))
        claimed = np.flatnonzero(want["fg_mask"][0] & (want["target_gt_idx"][0] == 0))
        assert set(inside[:10]) <= set(claimed) < set(inside) | set(claimed), (inside[:12], claimed)
        assert (want["target_gt_idx"][want["fg_mask"]] != 2).all()


def test_topk_mask_takes_lower_index_on_ties():
    metric = np.zeros((1, 2, 12), np.float32)
    metric[0, 0, [1, 4, 5, 9]] = 0.5  # four tied, k = 3: the three lowest
    metric[0, 1, [2, 3]] = [0.25, 0.75]
    want = np.asarray(jloss._topk_mask(jnp.asarray(metric), 3))
    got = ploss._topk_mask(torch.from_numpy(metric), 3).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, 0].nonzero()[0].tolist() == [1, 4, 5]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_dfl_loss_matches_jax(dtype):
    rng = np.random.default_rng(3)
    logits = rng.normal(0, 2, (40, 4, 16)).astype(dtype)
    target = rng.uniform(0, 14.99, (40, 4)).astype(dtype)
    ctx = jax.enable_x64(True) if dtype == np.float64 else contextlib.nullcontext()
    with ctx:
        want = np.asarray(jloss._dfl_loss(jnp.asarray(logits), jnp.asarray(target)))
    got = ploss._dfl_loss(torch.from_numpy(logits), torch.from_numpy(target)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6 if dtype == np.float32 else 1e-13)


def test_yolo_loss_float32_matches_jax():
    rng = np.random.default_rng(4)
    levels = level_outputs(rng, 2, np.float32)
    gt = ground_truth(rng, 2)
    want = {k: float(v) for k, v in _jax_loss(levels, gt).items()}
    got = {k: float(v) for k, v in ploss.yolo_loss(_torch_levels(levels), *(torch.from_numpy(a) for a in gt),
                                                    imgsz=HW).items()}
    assert want["num_fg"] > 10 and got["num_fg"] == want["num_fg"]
    for k in ("total", "box", "cls", "dfl"):
        assert abs(got[k] - want[k]) <= F32_RTOL * abs(want[k]), (k, got[k], want[k])


def test_yolo_loss_float64_and_gradients_match_jax():
    rng = np.random.default_rng(5)
    levels = level_outputs(rng, 2, np.float64)
    boxes, labels, mask = ground_truth(rng, 2)
    gt = (boxes.astype(np.float64), labels, mask)  # float32 boxes: a float32 atan in the CIoU
    with jax_float64():
        def total(lv):
            return jloss.yolo_loss(lv, *(jnp.asarray(a) for a in gt), imgsz=HW)["total"]

        jlevels = [(jnp.asarray(bx), jnp.asarray(cl)) for bx, cl in levels]
        want = {k: float(v) for k, v in jloss.yolo_loss(jlevels, *(jnp.asarray(a) for a in gt), imgsz=HW).items()}
        want_grads = jax.tree_util.tree_map(np.asarray, jax.grad(total)(jlevels))
    tl = _torch_levels(levels, grad=True)
    losses = ploss.yolo_loss(tl, *(torch.from_numpy(a) for a in gt), imgsz=HW)
    losses["total"].backward()
    assert losses["total"].dtype == torch.float64 and want["num_fg"] > 10
    for k in ("total", "box", "cls", "dfl", "num_fg"):
        assert abs(losses[k].item() - want[k]) <= F64_RTOL * abs(want[k]), (k, float(losses[k]), want[k])
    got_grads = [(bx.grad.numpy(), cl.grad.numpy()) for bx, cl in tl]
    scale = max(np.abs(w).max() for pair in want_grads for w in pair)
    assert scale > 0
    for gpair, wpair in zip(got_grads, want_grads):
        for g, w in zip(gpair, wpair):
            np.testing.assert_allclose(g, w, rtol=0, atol=F64_RTOL * scale)
