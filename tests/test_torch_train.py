"""One accumulated train step of the port (`parallel/train_step.py`) against
the JAX package's `make_train_step`, on the CPU: KFPN-18 on a 64x64 raster,
S = 2 micro-batches of B = 2 frames.

Both sides start the compared step from the same numbers: JAX makes one
step, and its state (params, batch_stats, optax moments, step, EMA) is
carried into the port with `load_train_state_from_jax`; then both make the
next step on a second batch. The port must match:

- in float64 (JAX under a scoped `jax.enable_x64`, never a global switch:
  xdist workers share a process across files), to 1e-10: the loss terms
  (relative), every parameter and BatchNorm running statistic (absolute),
  and the optimizer moments (relative to each tensor's largest), for SGD
  and for Adam. The EMA takes d in float32 through `exp`, which differs
  by an ulp between numpy and XLA; it is held within 4 float32 ulps of
  (1 - d) times the step's largest change;
- in float32 (the port's strict-fp32 rule), SGD with the one_cycle
  momentum schedule: the loss terms within 1e-6 relative, BatchNorm
  statistics within 1e-5 of each tensor's largest, every parameter within
  1% of the step's largest parameter change (float32 conv gradients that
  sum with heavy cancellation, such as a BatchNorm bias's, keep only a few
  digits), and the EMA within the same. Adam is left to float64: its
  first updates are about lr * sign(g) and turn float32 noise in a
  near-zero gradient into a full-size difference.
"""

import contextlib

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

from sfa3d_tpu.config.train import OptimConfig as JOptimConfig
from sfa3d_tpu.models import create_model as jcreate_model
from sfa3d_tpu.parallel import create_train_state as jcreate_train_state
from sfa3d_tpu.parallel import make_train_step as jmake_train_step
from sfa3d_tpu.pipeline import init_detector as jinit_detector
from sfa3d_tpu.runtime.schedules import create_optimizer as jcreate_optimizer
from sfa3d_tpu_torch.config.train import OptimConfig
from sfa3d_tpu_torch.models import create_model
from sfa3d_tpu_torch.models.port import _find_moments, load_train_state_from_jax, state_dict_from_jax
from sfa3d_tpu_torch.parallel import create_train_state, make_train_step
from sfa3d_tpu_torch.runtime.schedules import create_optimizer

HW, HM, S, B = 64, 16, 2, 2
EMA_DECAY, EMA_TAU = 0.999, 2.0
F64_TOL = 1e-10
F32_LOSS_RTOL, F32_STAT_RTOL, F32_PARAM_SHARE = 1e-6, 1e-5, 1e-2
EMA_ULPS = 4 * 2.0 ** -24


def synthetic_batch(rng, dtype):
    """S x B frames: a uniform raster and targets with 3 objects a frame
    (peaks of 1 on a heatmap of Gaussian-like values below 1)."""
    k = 50
    bev = rng.uniform(0, 1, (S, B, HW, HW, 3))
    obj_mask = np.zeros((S, B, k))
    obj_mask[..., :3] = 1
    inds = (rng.integers(0, HM * HM, (S, B, k)) * obj_mask).astype(np.int32)
    hm = rng.uniform(0, 0.9, (S, B, HM, HM, 3)) ** 4
    for si in range(S):
        for bi in range(B):
            for j in range(3):
                y, x = np.unravel_index(inds[si, bi, j], (HM, HM))
                hm[si, bi, y, x, int(rng.integers(0, 3))] = 1.0
    m = obj_mask[..., None]
    targets = {
        "hm_cen": hm,
        "cen_offset": rng.uniform(0, 1, (S, B, k, 2)) * m,
        "direction": rng.uniform(-1, 1, (S, B, k, 2)) * m,
        "z_coor": rng.uniform(0, 4, (S, B, k, 1)) * m,
        "dim": rng.uniform(0.5, 4, (S, B, k, 3)) * m,
        "obj_mask": obj_mask,
    }
    targets = {key: v.astype(dtype) for key, v in targets.items()}
    targets["indices_center"] = inds
    return {"bev": bev.astype(dtype), "targets": targets}


def to_torch(batch):
    return {"bev": torch.from_numpy(batch["bev"]).permute(0, 1, 4, 2, 3),
            "targets": {k: torch.from_numpy(v) for k, v in batch["targets"].items()}}


@pytest.fixture(scope="module")
def jax_variables():
    model = jcreate_model("fpn_resnet_18")
    return jtu.tree_map(np.asarray, jinit_detector(model, jax.random.PRNGKey(0), input_size=(HW, HW)))


def run_pair(jax_variables, optim_kw, dtype):
    """JAX: two steps from the init; the port: the second step from JAX's
    first. Returns (JAX state before / after the second step, its stats,
    the port's state and stats after it)."""
    f64 = dtype == np.float64
    rng = np.random.default_rng(7)
    b1, b2 = synthetic_batch(rng, dtype), synthetic_batch(rng, dtype)
    with jax.enable_x64(True) if f64 else contextlib.nullcontext():
        jm = jcreate_model("fpn_resnet_18", dtype=jnp.float64 if f64 else jnp.float32)
        tx = jcreate_optimizer(JOptimConfig(**optim_kw), num_epochs=10, steps_per_epoch=1)
        st = jcreate_train_state(jm, jtu.tree_map(lambda a: np.asarray(a, dtype), jax_variables), tx, ema=True)
        step = jmake_train_step(jm, tx, ema_decay=EMA_DECAY, ema_tau=EMA_TAU)
        st1, _ = step(st, b1)
        before = jtu.tree_map(np.asarray, st1)
        st2, jstats = step(st1, b2)
        after = jtu.tree_map(np.asarray, st2)
        jstats = {k: float(v) for k, v in jstats.items()}

    model = create_model("fpn_resnet_18").to(torch.float64 if f64 else torch.float32)
    ptx = create_optimizer(OptimConfig(**optim_kw), num_epochs=10, steps_per_epoch=1)
    state = load_train_state_from_jax(create_train_state(model, ptx, ema=True), before)
    assert state.step == 1
    pstep = make_train_step(model, ptx, ema_decay=EMA_DECAY, ema_tau=EMA_TAU, device="cpu")
    state, stats = pstep(state, to_torch(b2))
    return before, after, jstats, state, {k: float(v) for k, v in stats.items()}


def _sd(state, tree=None):
    """A JAX state's params (or a params-shaped tree) in the port's layout,
    as float64 numpy."""
    sd = state_dict_from_jax({"params": state.params if tree is None else tree,
                              "batch_stats": state.batch_stats})
    return {k: v.double().numpy() for k, v in sd.items()}


def _moments(state, optimizer_type):
    if optimizer_type == "adam":
        node = _find_moments(state.opt_state, "mu")
        return {"exp_avg": node.mu, "exp_avg_sq": node.nu}
    return {"momentum_buffer": _find_moments(state.opt_state, "trace").trace}


def _check_ema(before, after, state, names, atol=0.0):
    """The EMA within EMA_ULPS of the step's change of the EMA, plus `atol`
    (float32: the parameters' own tolerance)."""
    want = _sd(after, after.ema_params)
    moved = _sd(after)
    start = _sd(before, before.ema_params)
    for k in names:
        scale = np.abs(moved[k] - start[k]).max()
        err = np.abs(state.ema_params[k].double().numpy() - want[k]).max()
        assert err <= EMA_ULPS * scale + atol + 1e-15, (k, err, scale)


@pytest.mark.parametrize("optimizer_type,lr", [("sgd", 1e-2), ("adam", 1e-3)])
def test_accumulated_step_matches_jax_float64(jax_variables, optimizer_type, lr):
    optim_kw = dict(optimizer_type=optimizer_type, lr=lr, lr_type="cosin")
    before, after, jstats, state, stats = run_pair(jax_variables, optim_kw, np.float64)
    for k, v in jstats.items():
        assert abs(stats[k] - v) <= F64_TOL * abs(v), (k, stats[k], v)
    want = _sd(after)
    got = {k: v.double().numpy() for k, v in state.model.state_dict().items()}
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[k], w, rtol=0, atol=F64_TOL, err_msg=k)
    names = [k for k, _ in state.model.named_parameters()]
    params = dict(state.model.named_parameters())
    for key, tree in _moments(after, optimizer_type).items():
        w = _sd(after, tree)
        for k in names:
            g = state.optimizer.state[params[k]][key].double().numpy()
            assert np.abs(g - w[k]).max() <= F64_TOL * max(np.abs(w[k]).max(), 1e-300), (key, k)
    if optimizer_type == "adam":
        assert all(float(state.optimizer.state[p]["step"]) == 2 for p in params.values())
    _check_ema(before, after, state, names)
    assert state.step == int(after.step) == 2
    # the step moved the parameters well past the tolerance (not vacuous)
    assert max(np.abs(want[k] - _sd(before)[k]).max() for k in names) > 1e4 * F64_TOL


def test_accumulated_step_matches_jax_float32(jax_variables):
    optim_kw = dict(optimizer_type="sgd", lr=1e-2, lr_type="one_cycle")
    before, after, jstats, state, stats = run_pair(jax_variables, optim_kw, np.float32)
    for k, v in jstats.items():
        assert abs(stats[k] - v) <= F32_LOSS_RTOL * abs(v), (k, stats[k], v)
    want, start = _sd(after), _sd(before)
    got = {k: v.double().numpy() for k, v in state.model.state_dict().items()}
    names = [k for k, _ in state.model.named_parameters()]
    largest_change = max(np.abs(want[k] - start[k]).max() for k in names)
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        if k in names:
            assert np.abs(got[k] - w).max() <= F32_PARAM_SHARE * largest_change, k
        else:
            assert np.abs(got[k] - w).max() <= F32_STAT_RTOL * np.abs(w).max(), k
    _check_ema(before, after, state, names, atol=F32_PARAM_SHARE * largest_change)
