"""The port's training runtime on the CPU: schedules and optimizers against
optax, the flax BatchNorm update, the EMA recurrence, the eval step against
JAX's, checkpoints (exact resume), the refused flags, and one run of the
training CLI whose checkpoint `Detector` loads.

Tolerances: the JAX schedules compute in float32 (outside x64 mode, and
one_cycle always) and the port's in float64, so schedules agree within a
few float32 roundings (SCHED_RTOL); the optimizer updates on float64 toy
parameters within 1e-12 where the JAX schedule is float64 too. The EMA
decay 1 - exp(-t / tau) loses most digits to cancellation at small t, where
numpy's and XLA's float32 exp round one ulp apart: d is held within 2 ulps
of 1 absolute (what reaches the EMA through 1 - d).
"""

import os

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import optax
import pytest
import torch

from sfa3d_tpu.config.train import OptimConfig as JOptimConfig
from sfa3d_tpu.models import create_model as jcreate_model
from sfa3d_tpu.parallel import create_train_state as jcreate_train_state
from sfa3d_tpu.parallel import make_eval_step as jmake_eval_step
from sfa3d_tpu.parallel.train_step import ema_decay_at as jema_decay_at
from sfa3d_tpu.pipeline import init_detector as jinit_detector
from sfa3d_tpu.runtime import schedules as jschedules
from sfa3d_tpu_torch.config.train import OptimConfig, parse_train_configs
from sfa3d_tpu_torch.models import create_model
from sfa3d_tpu_torch.models.port import state_dict_from_jax
from sfa3d_tpu_torch.models.resnet import FlaxBatchNorm2d
from sfa3d_tpu_torch.parallel import create_train_state, ema_decay_at, make_eval_step, make_train_step
from sfa3d_tpu_torch.runtime import checkpoint, schedules

SCHED_RTOL = 1e-6  # a few float32 roundings
HW = 64


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads: the suite runs six test processes on the CPU at
    once, and eight threads each would mostly wait on one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def init_state_dict():
    """One JAX-recipe init of KFPN-18 (`init_weights` draws for seconds on
    the CPU), copied into every model the tests make."""
    return create_model("fpn_resnet_18").init_weights(torch.Generator().manual_seed(0)).state_dict()


def _model(init_state_dict):
    model = create_model("fpn_resnet_18")
    model.load_state_dict(init_state_dict)
    return model


def _batch(seed, s=1, b=2, hm=HW // 4, dtype=np.float32):
    """A raster and targets in the port's layout (NCHW raster)."""
    rng = np.random.default_rng(seed)
    k = 50
    mask = np.zeros((s, b, k), np.float32)
    mask[..., :3] = 1
    idx = (rng.integers(0, hm * hm, (s, b, k)) * mask).astype(np.int32)
    gt = rng.uniform(0, 0.9, (s, b, hm, hm, 3)).astype(np.float32) ** 4
    flat = gt.reshape(s, b, hm * hm, 3)
    for si in range(s):
        for bi in range(b):
            flat[si, bi, idx[si, bi, :3], [0, 1, 2]] = 1.0
    m = mask[..., None]
    tg = {"hm_cen": gt, "cen_offset": rng.uniform(0, 1, (s, b, k, 2)) * m,
          "direction": rng.uniform(-1, 1, (s, b, k, 2)) * m, "z_coor": rng.uniform(0, 4, (s, b, k, 1)) * m,
          "dim": rng.uniform(0.5, 4, (s, b, k, 3)) * m, "obj_mask": mask}
    tg = {key: torch.from_numpy(v.astype(dtype)) for key, v in tg.items()}
    tg["indices_center"] = torch.from_numpy(idx)
    return {"bev": torch.from_numpy(rng.uniform(0, 1, (s, b, 3, HW, HW)).astype(dtype)), "targets": tg}


@pytest.mark.parametrize("lr_type", ["cosin", "multi_step", "one_cycle"])
def test_schedules_match_optax_at_every_step(lr_type):
    cfg = dict(lr=3e-3, lr_type=lr_type, steps=(4, 7), optimizer_type="sgd")
    for num_epochs, spe in ((10, 3), (23, 1)):
        lr = schedules.create_lr_schedule(OptimConfig(**cfg), num_epochs, spe)
        jlr = jax.jit(jschedules.create_lr_schedule(JOptimConfig(**cfg), num_epochs, spe))
        mom = schedules.create_momentum_schedule(OptimConfig(**cfg), num_epochs, spe)
        jmom = jschedules.create_momentum_schedule(JOptimConfig(**cfg), num_epochs, spe)
        assert (mom is None) == (jmom is None) == (lr_type != "one_cycle")
        for step in range(num_epochs * spe + 5):
            assert lr(step) == pytest.approx(float(jlr(jnp.int32(step))), rel=SCHED_RTOL), step
            if mom is not None:
                assert mom(step) == pytest.approx(float(jmom(jnp.int32(step))), rel=SCHED_RTOL), step
    rf, jrf = schedules.range_finder_schedule(7, steps_per_epoch=2), jschedules.range_finder_schedule(7, steps_per_epoch=2)
    assert all(rf(s) == pytest.approx(float(jrf(jnp.int32(s))), rel=SCHED_RTOL) for s in range(16))


@pytest.mark.parametrize("optimizer_type,lr_type,wd", [("sgd", "cosin", 0.0), ("adam", "multi_step", 1e-2),
                                                        ("sgd", "one_cycle", 0.0)])
def test_optimizer_updates_match_optax(optimizer_type, lr_type, wd):
    """Six updates of float64 toy parameters under the same gradients: the
    torch.optim optimizer with the schedule set before every step against
    the optax transformation."""
    cfg = dict(optimizer_type=optimizer_type, lr=1e-2, lr_type=lr_type, steps=(2, 4), weight_decay=wd)
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(5, 3))
    grads = [rng.normal(size=(5, 3)) * 10.0 ** rng.integers(-6, 1) for _ in range(6)]
    spec = schedules.create_optimizer(OptimConfig(**cfg), num_epochs=6, steps_per_epoch=1)
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = spec.build([p])
    for step, g in enumerate(grads):
        p.grad = torch.from_numpy(g.copy())
        spec.apply_schedule(opt, step)
        opt.step()
    with jax.enable_x64(True):
        tx = jschedules.create_optimizer(JOptimConfig(**cfg), num_epochs=6, steps_per_epoch=1)
        jp = jnp.asarray(p0)
        st = tx.init(jp)
        for g in grads:
            upd, st = tx.update(jnp.asarray(g), st, jp)
            jp = optax.apply_updates(jp, upd)
        want = np.asarray(jp)
    # one_cycle's JAX schedules are float32 even in x64 mode
    tol = 1e-6 * np.abs(want - p0).max() if lr_type == "one_cycle" else 1e-12
    np.testing.assert_allclose(p.detach().numpy(), want, rtol=0, atol=tol)


def test_batchnorm_running_stats_follow_flax():
    """Training-mode running mean and BIASED variance with momentum 0.9, as
    flax.linen.BatchNorm; torch's own BatchNorm2d takes the unbiased
    variance (n / (n - 1) larger)."""
    import flax.linen as fnn

    x = np.random.default_rng(1).normal(1.0, 2.0, (2, 2, 2, 5))  # NHWC: 8 values a channel
    with jax.enable_x64(True):
        bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5, dtype=jnp.float64,
                           param_dtype=jnp.float64)
        # flax makes the statistics float32; the float64 step starts them float64
        variables = jtu.tree_map(lambda a: a.astype(jnp.float64), bn.init(jax.random.PRNGKey(0), jnp.asarray(x)))
        y, upd = bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
        want_y = np.asarray(y)
        want_mean, want_var = (np.asarray(upd["batch_stats"][k]) for k in ("mean", "var"))
    layer = FlaxBatchNorm2d(5).double().train()
    got_y = layer(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).detach().numpy()
    np.testing.assert_allclose(got_y, want_y, rtol=0, atol=1e-12)
    np.testing.assert_allclose(layer.running_mean.numpy(), want_mean, rtol=0, atol=1e-15)
    np.testing.assert_allclose(layer.running_var.numpy(), want_var, rtol=0, atol=1e-15)
    plain = torch.nn.BatchNorm2d(5, momentum=0.1).double().train()
    plain(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert np.abs(plain.running_var.numpy() - want_var).max() > 1e-3  # the trap
    assert set(layer.state_dict()) == set(plain.state_dict())
    assert int(layer.num_batches_tracked) == 1


def test_ema_decay_and_recurrence(init_state_dict):
    for step in (0, 1, 2, 17, 5000):
        assert ema_decay_at(step, 0.999, 2000.0) == pytest.approx(
            float(jema_decay_at(jnp.int32(step), 0.999, 2000.0)), rel=0, abs=1.2e-7)
    model = _model(init_state_dict)
    spec = schedules.create_optimizer(OptimConfig(optimizer_type="sgd", lr=1e-2), 10, 1)
    state = create_train_state(model, spec, ema=True)
    name, p = next(iter(model.named_parameters()))
    assert state.ema_params[name].data_ptr() != p.data_ptr()  # a real copy
    step = make_train_step(model, spec, ema_decay=0.99, ema_tau=3.0, device="cpu")
    e = p.detach().clone()
    for i in range(3):
        state, _ = step(state, _batch(i))
        d = np.float32(1.0) - ema_decay_at(i + 1, 0.99, 3.0)
        e = e + float(d) * (p.detach() - e)
        assert torch.equal(state.ema_params[name], e)
    assert state.step == 3
    with pytest.raises(ValueError, match="ema=True"):
        make_train_step(model, spec, ema_decay=0.9, device="cpu")(create_train_state(model, spec), _batch(0))


def test_eval_step_matches_jax():
    jm = jcreate_model("fpn_resnet_18")
    variables = jtu.tree_map(np.array, jinit_detector(jm, jax.random.PRNGKey(1), input_size=(HW, HW)))
    for i in range(3):  # peaks above the floor, and BN statistics that are not the identity
        variables["params"][f"fpn{i}_hm_cen"]["conv2"]["bias"] += 2.0
    rng = np.random.default_rng(4)
    variables["batch_stats"] = jtu.tree_map(lambda v: (v + rng.uniform(0.1, 0.5, v.shape)).astype(np.float32),
                                            variables["batch_stats"])
    jtx = jschedules.create_optimizer(JOptimConfig(), 10, 1)
    jstats = jmake_eval_step(jm)(jcreate_train_state(jm, variables, jtx), {
        "bev": jnp.asarray(_batch(5)["bev"][0].permute(0, 2, 3, 1).numpy()),
        "targets": {k: jnp.asarray(v[0].numpy()) for k, v in _batch(5)["targets"].items()}})
    model = create_model("fpn_resnet_18")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    state = create_train_state(model, schedules.create_optimizer(OptimConfig(), 10, 1))
    b = _batch(5)
    stats = make_eval_step(model, device="cpu")(state, {"bev": b["bev"][0],
                                                        "targets": {k: v[0] for k, v in b["targets"].items()}})
    for k, v in jstats.items():
        assert float(stats[k]) == pytest.approx(float(v), rel=1e-5), k
    assert not model.training


def test_train_step_after_inference_at_the_same_shape(init_state_dict):
    """Serving and training share the model's cached upsample matrices: a
    step after an inference-mode forward at the same shape must train."""
    from sfa3d_tpu_torch.pipeline import forward_heads

    model = _model(init_state_dict).eval()
    b = _batch(21)
    forward_heads(model, b["bev"][0].permute(0, 2, 3, 1))  # under torch.inference_mode
    spec = schedules.create_optimizer(OptimConfig(), 10, 1)
    state, stats = make_train_step(model, spec, device="cpu")(create_train_state(model, spec), b)
    assert np.isfinite(float(stats["total_loss"])) and state.step == 1


@pytest.mark.parametrize("optimizer_type", ["sgd", "adam"])
def test_resume_continues_schedule_and_optimizer_exactly(tmp_path, optimizer_type, init_state_dict):
    """Two steps straight == step, save, load into a fresh model and
    optimizer, step: parameters, BatchNorm statistics, moments and EMA bit
    for bit."""
    cfg = OptimConfig(optimizer_type=optimizer_type, lr=1e-2, lr_type="one_cycle" if optimizer_type == "sgd"
                      else "cosin")
    batches = [_batch(10), _batch(11)]

    def fresh():
        model = _model(init_state_dict)
        spec = schedules.create_optimizer(cfg, num_epochs=4, steps_per_epoch=1)
        return model, spec, create_train_state(model, spec, ema=True)

    model, spec, straight = fresh()
    step = make_train_step(model, spec, ema_decay=0.9, ema_tau=2.0, device="cpu")
    for b in batches:
        straight, _ = step(straight, b)

    model, spec, state = fresh()
    state, _ = make_train_step(model, spec, ema_decay=0.9, ema_tau=2.0, device="cpu")(state, batches[0])
    path = checkpoint.save_checkpoint(str(tmp_path), "run", state, epoch=1)
    assert os.path.basename(path) == "Model_run_epoch_1.pth"
    model2, spec2, resumed = fresh()
    resumed, epoch = checkpoint.load_checkpoint(path, resumed)
    assert epoch == 1 and resumed.step == 1
    resumed, _ = make_train_step(model2, spec2, ema_decay=0.9, ema_tau=2.0, device="cpu")(resumed, batches[1])

    assert resumed.step == straight.step == 2
    for (k, a), (_, b) in zip(straight.model.state_dict().items(), resumed.model.state_dict().items()):
        assert torch.equal(a, b), k
    for k in straight.ema_params:
        assert torch.equal(straight.ema_params[k], resumed.ema_params[k]), k
    sa, sb = straight.optimizer.state_dict(), resumed.optimizer.state_dict()
    for i, st in sa["state"].items():
        for key, v in st.items():
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(sb["state"][i][key])), (i, key)
    assert sa["param_groups"][0]["lr"] == sb["param_groups"][0]["lr"]


def test_checkpoint_files_and_loading(tmp_path, init_state_dict):
    model = _model(init_state_dict)
    spec = schedules.create_optimizer(OptimConfig(), 3, 1)
    state = create_train_state(model, spec, ema=True)
    with torch.no_grad():
        for e in state.ema_params.values():
            e.add_(1.0)
    for epoch in (1, 2, 3):
        checkpoint.save_checkpoint(str(tmp_path), "fn", state, epoch)
    assert checkpoint.latest_checkpoint(str(tmp_path), "fn").endswith("Model_fn_epoch_3.pth")
    checkpoint.prune_checkpoints(str(tmp_path), "fn", 2)
    assert sorted(os.listdir(tmp_path)) == ["Model_fn_epoch_2.pth", "Model_fn_epoch_3.pth"]
    assert checkpoint.latest_checkpoint(str(tmp_path / "none"), "fn") is None
    path = checkpoint.latest_checkpoint(str(tmp_path), "fn")
    raw, ema = checkpoint.load_params_only(path), checkpoint.load_params_only(path, use_ema=True)
    name = next(iter(state.ema_params))
    assert torch.equal(ema[name], raw[name] + 1.0)
    assert torch.equal(raw["bn1.running_var"], ema["bn1.running_var"])

    from sfa3d_tpu_torch.detector import Detector

    det = Detector(checkpoint=path, device="cpu", use_ema=True)
    assert torch.equal(det.model.state_dict()[name], ema[name])
    # a state without EMA drops the stored one; a checkpoint without EMA seeds it
    plain_state = create_train_state(create_model("fpn_resnet_18"), spec)
    assert checkpoint.load_checkpoint(path, plain_state)[0].ema_params is None
    state.ema_params = None
    checkpoint.save_checkpoint(str(tmp_path), "noema", state, 1)
    seeded, _ = checkpoint.load_checkpoint(str(tmp_path / "Model_noema_epoch_1.pth"),
                                           create_train_state(create_model("fpn_resnet_18"), spec, ema=True))
    assert torch.equal(seeded.ema_params[name], seeded.params[name].detach())
    with pytest.raises(ValueError, match="ema_params"):
        checkpoint.load_params_only(str(tmp_path / "Model_noema_epoch_1.pth"), use_ema=True)
    orbax_dir = tmp_path / "Model_fn_epoch_9"
    orbax_dir.mkdir()
    with pytest.raises(NotImplementedError, match="Orbax"):
        checkpoint.load_checkpoint(str(orbax_dir), plain_state)


@pytest.mark.parametrize("flag", [["--mesh_shape", "2"], ["--compilation_cache", "/tmp/c"],
                                  ["--imagenet_pretrained"], ["--dataset", "argoverse", "--mesh_shape", "4"],
                                  ["--profile_dir", "/tmp/p"], ["--compilation_cache"], ["--arch", "resnet_18"]])
def test_unported_flags_raise(flag):
    with pytest.raises(NotImplementedError):
        parse_train_configs(flag)
    cfg = parse_train_configs(["--mesh_shape", "1"])
    assert cfg.model.compute_dtype == "bfloat16" and cfg.runtime.batch_size == 16
    assert cfg.optim.effective_batch == 64 and cfg.runtime.platform is None
    cfg = parse_train_configs(["--val_ap", "--val_ap_samples", "3"])  # ported: runs cli/eval at each checkpoint
    assert cfg.runtime.val_ap and cfg.runtime.val_ap_samples == 3


def test_train_cli_runs_and_detector_loads_its_checkpoint(tmp_path):
    """4 synthetic frames, batch 2, effective batch 2, one epoch, on the CPU
    at the full raster: two train steps, the validation loss, a checkpoint
    with EMA weights that Detector loads, and --val_ap: the KITTI AP of 2
    val frames on that checkpoint's EMA weights (cli/eval.py)."""
    from sfa3d_tpu_torch.cli.train import main
    from sfa3d_tpu_torch.data.synthetic import synthetic_scene, write_mini_kitti
    from sfa3d_tpu_torch.detector import Detector

    root = write_mini_kitti(str(tmp_path / "kitti"), n_frames=4)
    main(["--dataset_dir", root, "--root-dir", str(tmp_path / "run"), "--batch_size", "2",
          "--effective_batch", "2", "--num_epochs", "1", "--checkpoint_freq", "1", "--platform", "cpu",
          "--compute_dtype", "float32", "--num_workers", "2", "--ema_decay", "0.99", "--print_freq", "1",
          "--saved_fn", "cli", "--val_ap", "--val_ap_samples", "2", "--peak_thresh", "0.0"])
    ckdir = tmp_path / "run" / "checkpoints" / "cli"
    path = str(ckdir / "Model_cli_epoch_1.pth")
    payload = torch.load(path, weights_only=True)
    assert payload["step"] == 2 and payload["epoch"] == 1 and "ema_params" in payload
    log = (tmp_path / "run" / "logs" / "cli" / "logger_cli.txt").read_text()
    assert "val_loss" in log and "save a checkpoint" in log
    assert "val AP (EMA weights) (epoch 1): mAP" in log
    for use_ema in (False, True):
        det = Detector(checkpoint=path, device="cpu", use_ema=use_ema)
        dets = det.detect(synthetic_scene(0)[0])
        assert isinstance(dets, list)
