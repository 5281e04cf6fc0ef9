"""The training options the port took in slice 12, on the CPU: the deconv
arch (`--arch resnet_18`) under the trainer, `--profile_dir`, and
`--compilation_cache` still refused.

- One accumulated `resnet_18` step (S = 2 x B = 2 frames on a 64 x 64
  raster, the heads on the 16 x 16 grid of the targets) against JAX's
  `make_train_step` from the same `TrainState` (carried across with
  `load_train_state_from_jax`, which takes the deconv bridge for a
  `DeconvCenterNet`), in float64 under a scoped `jax.enable_x64`, SGD and
  Adam: loss terms (relative), every parameter and BatchNorm statistic
  (absolute) and the optimizer moments (relative to each tensor's largest)
  within F64_TOL = 1e-10, as the KFPN steps are held
  (tests/test_torch_train.py). JAX's deconv model pins its deconv
  BatchNorms to float32; the float64 run lifts that pin for the block (the
  module's `jnp.float32` spelled float64), as tests/test_torch_yolo_loss.py
  does for YOLOv8.
- `cli.train --arch resnet_18 --platform cpu` trains an epoch (EMA on,
  `--val_ap`), and its checkpoint, keyed `deconv_layers.*`, loads in
  `cli.eval --arch resnet_18`.
- `--profile_dir DIR` writes a Chrome trace of the epoch into DIR.
"""

import contextlib

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

import sfa3d_tpu.models.centernet_deconv as jdeconv
from sfa3d_tpu.config.train import OptimConfig as JOptimConfig
from sfa3d_tpu.models import create_model as jcreate_model
from sfa3d_tpu.parallel import create_train_state as jcreate_train_state
from sfa3d_tpu.parallel import make_train_step as jmake_train_step
from sfa3d_tpu.pipeline import init_detector as jinit_detector
from sfa3d_tpu.runtime.schedules import create_optimizer as jcreate_optimizer
from sfa3d_tpu_torch.config.train import OptimConfig, parse_train_configs
from sfa3d_tpu_torch.models import create_model
from sfa3d_tpu_torch.models.port import _find_moments, deconv_state_dict_from_jax, load_train_state_from_jax
from sfa3d_tpu_torch.parallel import create_train_state, make_train_step
from sfa3d_tpu_torch.runtime.schedules import create_optimizer
from tests.test_torch_train import HM, HW, synthetic_batch, to_torch

F64_TOL = 1e-10


@pytest.fixture(autouse=True)
def one_torch_thread():
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
def deconv_float64():
    """x64 on, and the float32 pin of the JAX deconv BatchNorms lifted to
    float64, for the duration of the block."""
    saved = jdeconv.jnp
    jdeconv.jnp = _Float64Pins()
    try:
        with jax.enable_x64(True):
            yield
    finally:
        jdeconv.jnp = saved


@pytest.fixture(scope="module")
def jax_variables():
    """A JAX deconv init with He-scaled deconv kernels (the init's N(0,
    0.001) kernels pass almost nothing to the heads: a step that moves
    nothing would compare nothing)."""
    variables = jtu.tree_map(np.array, jinit_detector(jcreate_model("resnet_18"), jax.random.PRNGKey(0),
                                                      input_size=(HW, HW)))
    rng = np.random.default_rng(3)
    for i in range(3):
        k = variables["params"][f"deconv{i}"]["kernel"]
        variables["params"][f"deconv{i}"]["kernel"] = rng.normal(0, np.sqrt(2.0 / (4 * k.shape[-1])), k.shape)
    return variables


@pytest.mark.parametrize("optimizer_type,lr", [("sgd", 1e-2), ("adam", 1e-3)])
def test_deconv_step_matches_jax_float64(jax_variables, optimizer_type, lr):
    optim_kw = dict(optimizer_type=optimizer_type, lr=lr, lr_type="cosin")
    rng = np.random.default_rng(7)
    b1, b2 = synthetic_batch(rng, np.float64), synthetic_batch(rng, np.float64)
    with deconv_float64():
        jm = jcreate_model("resnet_18", dtype=jnp.float64)
        tx = jcreate_optimizer(JOptimConfig(**optim_kw), num_epochs=10, steps_per_epoch=1)
        st = jcreate_train_state(jm, jtu.tree_map(lambda a: np.asarray(a, np.float64), jax_variables), tx, ema=True)
        step = jmake_train_step(jm, tx, ema_decay=0.999, ema_tau=2.0)
        st1, _ = step(st, b1)
        before = jtu.tree_map(np.asarray, st1)
        st2, jstats = step(st1, b2)
        after = jtu.tree_map(np.asarray, st2)
        jstats = {k: float(v) for k, v in jstats.items()}

    model = create_model("resnet_18").to(torch.float64)
    heads = model.eval()(torch.zeros(1, 3, HW, HW, dtype=torch.float64))
    assert all(v.shape[-2:] == (HM, HM) for v in heads.values())  # the targets' grid
    ptx = create_optimizer(OptimConfig(**optim_kw), num_epochs=10, steps_per_epoch=1)
    state = load_train_state_from_jax(create_train_state(model, ptx, ema=True), before)
    pstep = make_train_step(model, ptx, ema_decay=0.999, ema_tau=2.0, device="cpu")
    state, stats = pstep(state, to_torch(b2))

    for k, v in jstats.items():
        assert abs(float(stats[k]) - v) <= F64_TOL * abs(v), (k, float(stats[k]), v)

    def sd(tree=None):
        out = deconv_state_dict_from_jax({"params": after.params if tree is None else tree,
                                          "batch_stats": after.batch_stats})
        return {k: v.double().numpy() for k, v in out.items()}

    want = sd()
    got = {k: v.double().numpy() for k, v in state.model.state_dict().items()}
    assert any(k.startswith("deconv_layers.") for k in got)
    for k, w in want.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(got[k], w, rtol=0, atol=F64_TOL, err_msg=k)
    names = [k for k, _ in state.model.named_parameters()]
    params = dict(state.model.named_parameters())
    if optimizer_type == "adam":
        node = _find_moments(after.opt_state, "mu")
        moments = {"exp_avg": node.mu, "exp_avg_sq": node.nu}
    else:
        moments = {"momentum_buffer": _find_moments(after.opt_state, "trace").trace}
    for key, tree in moments.items():
        w = sd(tree)
        for k in names:
            g = state.optimizer.state[params[k]][key].double().numpy()
            assert np.abs(g - w[k]).max() <= F64_TOL * max(np.abs(w[k]).max(), 1e-300), (key, k)
    start = deconv_state_dict_from_jax({"params": before.params, "batch_stats": before.batch_stats})
    assert max(np.abs(want[k] - start[k].double().numpy()).max() for k in names) > 1e4 * F64_TOL
    assert state.step == int(after.step) == 2


def test_train_cli_deconv_epoch_and_eval(tmp_path):
    """--arch resnet_18 through the CLI on the CPU: an epoch of 2 steps with
    EMA and --val_ap, --profile_dir's trace; the checkpoint through the
    eval CLI with --arch resnet_18."""
    from sfa3d_tpu_torch.cli.eval import main as eval_main
    from sfa3d_tpu_torch.cli.train import main
    from sfa3d_tpu_torch.data.synthetic import write_mini_kitti

    root = write_mini_kitti(str(tmp_path / "kitti"), n_frames=4, cameras=False)
    prof = tmp_path / "prof"
    main(["--dataset_dir", root, "--root-dir", str(tmp_path / "run"), "--arch", "resnet_18", "--saved_fn", "dc",
          "--batch_size", "2", "--effective_batch", "2", "--num_epochs", "1", "--checkpoint_freq", "1",
          "--platform", "cpu", "--compute_dtype", "float32", "--num_workers", "2", "--ema_decay", "0.99",
          "--val_ap", "--val_ap_samples", "2", "--peak_thresh", "0.0", "--profile_dir", str(prof)])
    path = tmp_path / "run" / "checkpoints" / "dc" / "Model_dc_epoch_1.pth"
    payload = torch.load(path, weights_only=True)
    assert payload["step"] == 2
    assert "deconv_layers.0.weight" in payload["state_dict"] and "deconv_layers.0.weight" in payload["ema_params"]
    assert not any(k.startswith("fpn") for k in payload["state_dict"])
    log = (tmp_path / "run" / "logs" / "dc" / "logger_dc.txt").read_text()
    assert "model resnet_18: " in log and "val AP (EMA weights) (epoch 1): mAP" in log
    trace = (prof / "trace_rank0.json").read_text()
    assert '"traceEvents"' in trace and "aten::convolution" in trace
    res = eval_main(["--dataset_dir", root, "--arch", "resnet_18", "--pretrained_path", str(path),
                     "--num_samples", "2", "--peak_thresh", "0.0", "--platform", "cpu", "--use_ema"])
    assert 0.0 <= res["mAP"] <= 1.0
    with pytest.raises(RuntimeError, match="Missing key"):  # a deconv checkpoint is no KFPN
        eval_main(["--dataset_dir", root, "--pretrained_path", str(path), "--num_samples", "1",
                   "--platform", "cpu"])


def test_compilation_cache_still_refused_and_ported_flags_parse():
    for argv in (["--compilation_cache"], ["--compilation_cache", "/tmp/c"]):
        with pytest.raises(NotImplementedError, match="--compilation_cache"):
            parse_train_configs(argv)
    cfg = parse_train_configs(["--arch", "resnet_18", "--profile_dir", "/tmp/p", "--imagenet_pretrained"])
    assert cfg.model.arch == "resnet_18" and cfg.model.num_layers == 18
    assert cfg.runtime.profile_dir == "/tmp/p" and cfg.model.imagenet_pretrained
