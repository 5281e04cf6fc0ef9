"""The port's YOLOv8 training path against the JAX package's on the CPU:
flax's BatchNorm update in YOLOv8, optax's warmup-cosine schedule and
masked AdamW, one training epoch (`parallel/yolo_step.py`), the eval pass,
2D mAP, the ultralytics checkpoint both ways, and the training CLI.

- The epoch: S = 3 steps of B = 2 frames at 64 x 128, YOLOv8n with 3
  classes from one JAX init, AdamW with a 2-step warmup (the first update's
  learning rate is 0) and EMA, JAX's own hflip draws. In float64 (JAX under
  a scoped `jax.enable_x64` with the YOLO float32 pins lifted, see
  tests/test_torch_yolo_loss.py) the epoch's mean losses within 1e-10
  relative, every parameter and BatchNorm statistic within 1e-10
  absolute, the EMA within 1e-10 plus 4 float32 ulps of the largest
  parameter change (its decay d goes through a float32 exp, an ulp apart
  between numpy and XLA). The ground-truth boxes are float64 there too.
- The schedule within 1e-12 relative of optax's in float64 (optax's own
  float32 cosine keeps about 6 digits near the end of the decay). optax
  computes a schedule in float32 even under x64, so the AdamW and epoch
  comparisons give optax.adamw the port's float64 learning rates (a
  table indexed by the step count); AdamW within 1e-12 of optax.adamw in
  float64.
- The eval pass on JAX-initialised float32 weights: boxes within 1e-4 px,
  classes and valid flags exact.
"""

import json

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import optax
import pytest
import torch

from sfa3d_tpu.eval.map2d import evaluate_map2d as jevaluate_map2d
from sfa3d_tpu.models import yolov8 as jyolo
from sfa3d_tpu.parallel import yolo_step as jstep
from sfa3d_tpu_torch.eval.map2d import evaluate_map2d
from sfa3d_tpu_torch.models.port import yolo_state_dict_from_jax
from sfa3d_tpu_torch.models.resnet import FlaxBatchNorm2d
from sfa3d_tpu_torch.models.yolov8 import (
    YOLOv8,
    export_ultralytics_state_dict,
    load_yolo_checkpoint,
    save_ultralytics_checkpoint,
)
from sfa3d_tpu_torch.parallel import yolo_step
from sfa3d_tpu_torch.runtime.schedules import OptimizerSpec, warmup_cosine_decay_schedule
from tests.test_torch_yolo_loss import jax_float64

HW = (64, 128)
N_FRAMES, S, B, G, C = 5, 3, 2, 8, 3
LR, WD, WARMUP, DECAY_STEPS = 1e-2, 5e-4, 2, 6
EMA_DECAY, EMA_TAU = 0.999, 2.0
EMA_ULPS = 4 * 2.0 ** -24
F64_TOL = 1e-10
BOX_ATOL = 1e-4


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's side runs on one intra-op thread: these tensors are small,
    and in a loaded multi-worker run more threads only wait on each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _split(rng):
    """N_FRAMES random frames with G box slots (the data/yolo2d.py layout)."""
    images = rng.integers(0, 256, (N_FRAMES, *HW, 3)).astype(np.uint8)
    xy = rng.uniform(0, [HW[1] - 12, HW[0] - 12], (N_FRAMES, G, 2))
    wh = rng.uniform(8, 40, (N_FRAMES, G, 2))
    boxes = np.concatenate([xy, np.minimum(xy + wh, [HW[1], HW[0]])], -1).astype(np.float32)
    mask = rng.random((N_FRAMES, G)) < 0.7
    return {"images": images, "boxes": boxes, "labels": rng.integers(0, C, (N_FRAMES, G)).astype(np.int32),
            "mask": mask}


@pytest.fixture(scope="module")
def jax_init():
    model = jyolo.YOLOv8(scale="n", num_classes=C)
    variables = model.init(jax.random.PRNGKey(3), jnp.zeros((1, *HW, 3), jnp.float32), train=True)
    return jtu.tree_map(np.asarray, variables)


def _port_model(variables, dtype=torch.float32):
    model = YOLOv8("n", C)
    model.load_state_dict(yolo_state_dict_from_jax(variables, "n", C), strict=True)
    return model.to(dtype)


def test_yolo_batchnorm_follows_flax():
    """ConvBnSiLU's BatchNorm is flax's (eps 1e-3, momentum 0.97, the
    biased running variance) in training and in eval mode."""
    import flax.linen as fnn

    rng = np.random.default_rng(0)
    x = rng.normal(1.0, 2.0, (2, 3, 3, 5))
    with jax.enable_x64(True):
        bn = fnn.BatchNorm(use_running_average=False, momentum=0.97, epsilon=1e-3, dtype=jnp.float64,
                           param_dtype=jnp.float64)
        v = bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
        v = {"params": {"scale": jnp.asarray(rng.uniform(0.5, 1.5, 5)), "bias": jnp.asarray(rng.normal(0, 1, 5))},
             "batch_stats": {"mean": jnp.asarray(rng.normal(0, 1, 5)), "var": jnp.asarray(rng.uniform(0.5, 2, 5))}}
        y, mut = bn.apply(v, jnp.asarray(x), mutable=["batch_stats"])
        y_eval = fnn.BatchNorm(use_running_average=True, epsilon=1e-3, dtype=jnp.float64).apply(
            {"params": v["params"], "batch_stats": mut["batch_stats"]}, jnp.asarray(x))
    yolo_bn = YOLOv8("n", C).model[0].bn
    assert isinstance(yolo_bn, FlaxBatchNorm2d) and (yolo_bn.eps, yolo_bn.flax_momentum) == (1e-3, 0.97)
    layer = FlaxBatchNorm2d(5, eps=yolo_bn.eps, momentum=yolo_bn.flax_momentum).double()
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(np.asarray(v["params"]["scale"])))
        layer.bias.copy_(torch.from_numpy(np.asarray(v["params"]["bias"])))
        layer.running_mean.copy_(torch.from_numpy(np.asarray(v["batch_stats"]["mean"])))
        layer.running_var.copy_(torch.from_numpy(np.asarray(v["batch_stats"]["var"])))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    out = layer.train()(xt).permute(0, 2, 3, 1).detach().numpy()
    np.testing.assert_allclose(out, np.asarray(y), atol=1e-12)
    np.testing.assert_allclose(layer.running_mean.numpy(), np.asarray(mut["batch_stats"]["mean"]), atol=1e-12)
    np.testing.assert_allclose(layer.running_var.numpy(), np.asarray(mut["batch_stats"]["var"]), atol=1e-12)
    out_eval = layer.eval()(xt).permute(0, 2, 3, 1).detach().numpy()
    np.testing.assert_allclose(out_eval, np.asarray(y_eval), atol=1e-12)


@pytest.mark.parametrize("warmup,decay,peak,end", [(3, 40, 1e-3, 1e-5), (1, 2, 0.5, 0.0), (7, 8, 2e-3, 2e-5)])
def test_warmup_cosine_schedule_matches_optax(warmup, decay, peak, end):
    want = optax.warmup_cosine_decay_schedule(0.0, peak, warmup_steps=warmup, decay_steps=decay, end_value=end)
    got = warmup_cosine_decay_schedule(0.0, peak, warmup, decay, end)
    assert got(0) == 0.0  # the first update's learning rate
    with jax.enable_x64(True):  # optax in float64: its float32 cosine keeps ~6 digits near the end
        wants = [float(want(step)) for step in range(decay + 5)]
    for step, w in enumerate(wants):
        assert abs(got(step) - w) <= 1e-12 * abs(w), (step, got(step), w)


def test_adamw_matches_optax_with_the_ndim_mask():
    rng = np.random.default_rng(1)
    shapes = {"w": (4, 3, 3, 2), "b": (4,), "g": (6, 5)}
    params = {k: rng.normal(0, 1, s) for k, s in shapes.items()}
    grads = [{k: rng.normal(0, 1, s) for k, s in shapes.items()} for _ in range(4)]
    port_sched = warmup_cosine_decay_schedule(0.0, 1e-2, 2, 6, 1e-4)
    with jax.enable_x64(True):
        tx = optax.adamw(_table_schedule(port_sched, 8), weight_decay=0.1,
                         mask=jtu.tree_map(lambda p: p.ndim > 1, params))
        jp = jtu.tree_map(jnp.asarray, params)
        opt = tx.init(jp)
        for g in grads:
            upd, opt = tx.update(jtu.tree_map(jnp.asarray, g), opt, jp)
            jp = optax.apply_updates(jp, upd)
        want = jtu.tree_map(np.asarray, jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    spec = OptimizerSpec("adamw", port_sched, weight_decay=0.1)
    opt_t = spec.build(tp.values())
    assert [len(gr["params"]) for gr in opt_t.param_groups] == [2, 1]
    for step, g in enumerate(grads):
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        spec.apply_schedule(opt_t, step)
        opt_t.step()
    for k in shapes:
        np.testing.assert_allclose(tp[k].detach().numpy(), want[k], rtol=0, atol=1e-12, err_msg=k)


def _table_schedule(sched, n):
    """The port's schedule as a float64 table that optax indexes by its step
    count (optax's own schedules compute in float32 even under x64)."""
    table = np.asarray([sched(i) for i in range(n)], np.float64)
    return lambda count: jnp.asarray(table)[count]


def _compare_tree(got_sd, want_sd, atol, what):
    for k, w in want_sd.items():
        if k.endswith("num_batches_tracked") or k.endswith("dfl.conv.weight"):
            continue
        g = got_sd[k].detach().double().numpy()
        np.testing.assert_allclose(g, w.double().numpy(), rtol=0, atol=atol, err_msg=f"{what} {k}")


def test_epoch_matches_jax_float64(jax_init):
    data = _split(np.random.default_rng(4))
    # float64 boxes: float32 ones put a float32 atan of each box's aspect
    # ratio into the assigner's CIoU, which XLA and PyTorch round differently
    data["boxes"] = data["boxes"].astype(np.float64)
    idx = np.random.default_rng(5).integers(0, N_FRAMES, (S, B)).astype(np.int32)
    v64 = jtu.tree_map(lambda a: np.asarray(a, np.float64), jax_init)
    with jax_float64():
        model = jyolo.YOLOv8(scale="n", num_classes=C, dtype=jnp.float64)
        sched = _table_schedule(warmup_cosine_decay_schedule(0.0, LR, WARMUP, DECAY_STEPS, LR * 0.01), S)
        tx = optax.adamw(sched, weight_decay=WD, mask=jtu.tree_map(lambda p: p.ndim > 1, v64["params"]))
        state = jstep.create_train_state(model, v64, tx, ema=True)
        epoch_fn = jstep.make_yolo_epoch_fn(model, tx, HW, ema_decay=EMA_DECAY, ema_tau=EMA_TAU)
        key = jax.random.PRNGKey(11)
        flips = np.stack([np.asarray(jax.random.bernoulli(k, 0.5, (B,))) for k in jax.random.split(key, S)])
        state, metrics = epoch_fn(state, {k: jnp.asarray(v) for k, v in data.items()}, jnp.asarray(idx), key)
        after = jtu.tree_map(np.asarray, state)
        metrics = {k: float(v) for k, v in metrics.items()}
    assert 0 < flips.sum() < flips.size

    pmodel = _port_model(v64, torch.float64)
    spec = OptimizerSpec("adamw", warmup_cosine_decay_schedule(0.0, LR, WARMUP, DECAY_STEPS, LR * 0.01), weight_decay=WD)
    pstate = yolo_step.create_train_state(pmodel, spec, ema=True)
    pepoch = yolo_step.make_yolo_epoch_fn(pmodel, spec, HW, ema_decay=EMA_DECAY, ema_tau=EMA_TAU, device="cpu")
    pstate, pmetrics = pepoch(pstate, {k: torch.from_numpy(v) for k, v in data.items()}, torch.from_numpy(idx),
                              flips=torch.from_numpy(flips))
    assert pstate.step == S
    for k, w in metrics.items():
        assert abs(pmetrics[k].item() - w) <= F64_TOL * abs(w), (k, pmetrics[k].item(), w)
    want_sd = yolo_state_dict_from_jax({"params": after.params, "batch_stats": after.batch_stats}, "n", C)
    start_sd = yolo_state_dict_from_jax(v64, "n", C)
    moved = max((want_sd[k] - start_sd[k]).abs().max().item() for k in want_sd if k.endswith("weight"))
    assert moved > 1e-3  # the parameters moved in the epoch
    _compare_tree(pmodel.state_dict(), want_sd, F64_TOL, "state")
    # d = ema_decay_at(t) goes through a float32 exp, which differs by an ulp
    # between numpy and XLA: the EMA is held within EMA_ULPS of the largest
    # parameter change more (as tests/test_torch_train.py holds KFPN's)
    want_ema = yolo_state_dict_from_jax({"params": after.ema_params, "batch_stats": after.batch_stats}, "n", C)
    _compare_tree(pstate.ema_params, {k: want_ema[k] for k in pstate.ema_params}, F64_TOL + EMA_ULPS * moved, "ema")


def test_eval_fn_matches_jax(jax_init):
    images = np.random.default_rng(6).integers(0, 256, (8, *HW, 3)).astype(np.uint8)
    model = jyolo.YOLOv8(scale="n", num_classes=C)
    variables = {"params": jax_init["params"], "batch_stats": jax_init["batch_stats"]}
    want = [np.asarray(t) for t in jstep.make_yolo_eval_fn(model)(variables, jnp.asarray(images))]
    pmodel = _port_model(jax_init)
    got = [t.numpy() for t in yolo_step.make_yolo_eval_fn(pmodel, device="cpu")(torch.from_numpy(images))]
    assert want[3].sum() > 100
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=BOX_ATOL)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-6)
    # other parameters (here the init's own, doubled biases) through `params`
    params = {k: p.detach() * 2 if k.endswith("bias") else p.detach() for k, p in pmodel.named_parameters()}
    swapped = _port_model(jax_init)
    with torch.no_grad():
        for k, p in swapped.named_parameters():
            p.copy_(params[k])
    a = yolo_step.make_yolo_eval_fn(pmodel, device="cpu")(torch.from_numpy(images), params)
    b = yolo_step.make_yolo_eval_fn(swapped, device="cpu")(torch.from_numpy(images))
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_map2d_equals_jax():
    rng = np.random.default_rng(7)
    gts, dets = [], []
    for _ in range(6):
        n = int(rng.integers(0, 6))
        xy = rng.uniform(0, 200, (n, 2))
        g = np.concatenate([xy, xy + rng.uniform(5, 60, (n, 2))], -1)
        gts.append({"boxes": g, "classes": rng.integers(0, 2, n)})  # class 2 has no ground truth
        m = int(rng.integers(0, 9))
        src = g[rng.integers(0, max(n, 1), m)] if n else rng.uniform(0, 200, (m, 4))
        d = src + rng.normal(0, 4, (m, 4))
        dets.append({"boxes": d, "scores": rng.uniform(0, 1, m), "classes": rng.integers(0, 3, m)})
    got, want = evaluate_map2d(dets, gts, num_classes=3), jevaluate_map2d(dets, gts, num_classes=3)
    assert got.keys() == want.keys() and 0 < want["mAP50"] < 1
    for k in want:
        assert got[k] == want[k] or (np.isnan(got[k]) and np.isnan(want[k])), k


def test_ultralytics_checkpoint_cross_loads(tmp_path, jax_init):
    model = _port_model(jax_init)
    ema = {k: p.detach() + 0.5 for k, p in model.named_parameters() if p.requires_grad}
    path = save_ultralytics_checkpoint(model, str(tmp_path / "port.pt"), params=ema)
    sd = torch.load(path, weights_only=True)
    assert sd.keys() == model.state_dict().keys() and "model.22.dfl.conv.weight" in sd
    assert sd["model.0.bn.num_batches_tracked"].dtype == torch.int64
    loaded = load_yolo_checkpoint(path)
    for k, v in loaded.state_dict().items():
        want = ema.get(k, model.state_dict()[k])
        assert torch.equal(v, want.to(v.dtype)), k
    # the JAX importer reads the port's file; the port reads the JAX writer's
    jvars = jyolo.load_yolo_variables(path)
    back = yolo_state_dict_from_jax(jtu.tree_map(np.asarray, jvars), "n", C)
    for k, v in export_ultralytics_state_dict(model, ema).items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(back[k], v), k
    jyolo.save_ultralytics_checkpoint(jax_init, str(tmp_path / "jax.pt"), scale="n", num_classes=C)
    from_jax = load_yolo_checkpoint(str(tmp_path / "jax.pt"))
    for k, v in yolo_state_dict_from_jax(jax_init, "n", C).items():
        assert torch.equal(from_jax.state_dict()[k], v), k


JAX_REPORT_KEYS = {"imgsz", "scale", "num_classes", "train_frames", "val_frames", "epochs", "batch_size", "lr",
                   "ema_decay", "ema_tau", "seed", "wall_seconds", "history", "best", "checkpoints_dir"}


def test_yolo_train_cli_runs_and_detector_loads_best(tmp_path):
    """6 port-written mini-KITTI frames (5 train, 1 val) at 64 x 128, batch
    2, 3 epochs with eval every epoch, on the CPU."""
    from sfa3d_tpu_torch.cli.yolo_train import main
    from sfa3d_tpu_torch.data.synthetic import write_mini_kitti
    from sfa3d_tpu_torch.models.yolov8 import YOLOv8Detector

    root = write_mini_kitti(str(tmp_path / "kitti"), n_frames=6)
    out = tmp_path / "report.json"
    report = main(["--dataset_dir", root, "--imgsz", "64x128", "--epochs", "3", "--eval_every", "1",
                   "--batch_size", "2", "--warmup_epochs", "1", "--platform", "cpu",
                   "--checkpoints_dir", str(tmp_path / "ck"), "--out", str(out)])
    assert set(report) == JAX_REPORT_KEYS and json.loads(out.read_text())["epochs"] == 3
    assert (report["train_frames"], report["val_frames"]) == (5, 1) and len(report["history"]) == 3
    assert all(np.isfinite(row["loss"]["total"]) for row in report["history"])
    det = YOLOv8Detector.from_weights(str(tmp_path / "ck" / "best.pt"), device="cpu", imgsz=(64, 128))
    assert (det.model.scale, det.model.num_classes) == ("n", 3)
    boxes, scores, classes = det(np.zeros((375, 1242, 3), np.uint8), conf=0.001)
    assert len(boxes) == len(scores) == len(classes)
    with pytest.raises(NotImplementedError):
        main(["--dataset_dir", root, "--compilation_cache", "/tmp/c", "--platform", "cpu"])
