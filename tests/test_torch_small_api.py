"""The last small public functions of the port against the JAX package's, on
the CPU:

- `ops/bev.py::make_bev_map`: a seeded KITTI-sized raw scan (120,000
  points, 26,000 of them in the front range, the others out of some bound) to the
  (608, 608, 3) float32 HWC raster, bit for bit against JAX's (the
  intensity and height channels and the density's bits);
- `ops/rotated_iou.py::iou_bev_rotated` / `iou_3d` on seeded single pairs
  (overlapping, disjoint, touching, nested, rotated), within IOU_TOL = 1e-6
  of JAX's (XLA's fused multiply-adds, tests/test_torch_kitti_eval.py's
  tolerance);
- `models::get_num_parameters` equal to JAX's count for fpn_resnet_18,
  resnet_18, fpn_resnet_34 and resnet_34;
- `runtime/checkpoint.py::load_pretrained_params` replaces the parameters
  and BatchNorm statistics and keeps the optimizer state and the step;
- `runtime/logger.py::time_synchronized` is monotone, and synchronizes
  the card first on a CUDA device;
- `config/kitti.py`'s inverse calibration matrices equal JAX's exactly.
"""

import importlib
import warnings

import jax
import numpy as np
import pytest
import torch

from sfa3d_tpu.models import create_model as jcreate_model
from sfa3d_tpu.models import get_num_parameters as jget_num_parameters
from sfa3d_tpu.ops.bev import make_bev_map as jmake_bev_map
from sfa3d_tpu.pipeline import init_detector as jinit_detector
from sfa3d_tpu_torch.models import create_model, get_num_parameters
from sfa3d_tpu_torch.ops.bev import make_bev_map
from sfa3d_tpu_torch.ops.rotated_iou import iou_3d, iou_bev_rotated
from sfa3d_tpu_torch.runtime import checkpoint, logger

jiou = importlib.import_module("sfa3d_tpu.ops.rotated_iou")
IOU_TOL = 1e-6


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def kitti_sized_scan(rng, n=120_000, n_in=26_000):
    """n_in points in KITTI's front range (under MAX_POINTS_FILTERED, as in a
    real scan), the others behind, beside, above or below it, intensities
    in [0, 1], in a shuffled order."""
    inside = np.stack([rng.uniform(0, 50, n_in), rng.uniform(-25, 25, n_in),
                       rng.uniform(-2.73, 1.27, n_in), rng.uniform(0, 1, n_in)], 1)
    m = n - n_in
    outside = np.stack([rng.uniform(-80, 0, m), rng.uniform(-80, 80, m), rng.uniform(-4, 3, m), rng.uniform(0, 1, m)], 1)
    outside[m // 2:, 0] += 80.0  # ahead of the range, or beside or above or below it
    outside[m // 2:, 1] = np.where(np.abs(outside[m // 2:, 1]) < 25, outside[m // 2:, 1] + 60, outside[m // 2:, 1])
    scan = np.concatenate([inside, outside]).astype(np.float32)
    return scan[rng.permutation(n)]


def test_make_bev_map_bit_exact_against_jax():
    scan = kitti_sized_scan(np.random.default_rng(2020))
    want = np.asarray(jmake_bev_map(scan))
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # nothing truncated
        got = make_bev_map(scan, device="cpu")
    assert got.shape == (608, 608, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert (got[..., 2] > 0).sum() > 10_000  # a full raster, not a vacuous one


def iou_pairs(rng, n=48):
    """(n, 7) box pairs [x, y, z, h, w, l, yaw]: random overlaps, and the
    edge cases (the same box, disjoint, touching, nested, a quarter turn)."""
    a = np.stack([rng.uniform(-3, 3, n), rng.uniform(-3, 3, n), rng.uniform(-2, 0, n), rng.uniform(1, 2, n),
                  rng.uniform(1, 3, n), rng.uniform(2, 5, n), rng.uniform(-np.pi, np.pi, n)], 1)
    b = a + np.concatenate([rng.normal(0, 1, (n, 3)), rng.normal(0, 0.3, (n, 3)), rng.normal(0, 0.5, (n, 1))], 1)
    b[:, 3:6] = np.abs(b[:, 3:6]) + 0.2
    edge = np.array([1.0, 2.0, -1.0, 1.5, 1.8, 4.0, 0.3])
    cases = [edge, edge + [10, 0, 0, 0, 0, 0, 0], edge + [4.0, 0, 0, 0, 0, 0, 0],
             edge * [1, 1, 1, 1, 0.5, 0.5, 1], edge + [0, 0, 0, 0, 0, 0, np.pi / 2]]
    a = np.concatenate([a, np.stack([edge] * len(cases))])
    b = np.concatenate([b, np.stack(cases)])
    return a.astype(np.float32), b.astype(np.float32)


def test_single_pair_ious_match_jax():
    a, b = iou_pairs(np.random.default_rng(9))
    bev = [0, 1, 4, 5, 6]
    want_bev = np.asarray(jax.jit(jax.vmap(jiou.iou_bev_rotated))(a[:, bev], b[:, bev]))
    want_3d = np.asarray(jax.jit(jax.vmap(jiou.iou_3d))(a, b))
    got_bev = np.array([float(iou_bev_rotated(torch.from_numpy(x[bev]), torch.from_numpy(y[bev])))
                        for x, y in zip(a, b)])
    got_3d = np.array([float(iou_3d(torch.from_numpy(x), torch.from_numpy(y))) for x, y in zip(a, b)])
    np.testing.assert_allclose(got_bev, want_bev, rtol=0, atol=IOU_TOL)
    np.testing.assert_allclose(got_3d, want_3d, rtol=0, atol=IOU_TOL)
    assert iou_bev_rotated(torch.from_numpy(a[-5, bev]), torch.from_numpy(b[-5, bev])).dim() == 0
    assert abs(got_3d[-5] - 1.0) < IOU_TOL and got_3d[-4] == 0.0  # the same box; a disjoint one
    assert 0.05 < np.median(want_bev[:-5]) < 0.95  # the seeded pairs overlap partly


@pytest.mark.parametrize("arch", ["fpn_resnet_18", "resnet_18", "fpn_resnet_34", "resnet_34"],
                         ids=["kfpn", "deconv", "kfpn34", "deconv34"])
def test_get_num_parameters_equals_jax(arch):
    jm = jcreate_model(arch)
    shapes = jax.eval_shape(lambda: jinit_detector(jm, jax.random.PRNGKey(0), input_size=(64, 64)))
    want = jget_num_parameters(shapes["params"])
    model = create_model(arch)
    assert get_num_parameters(model) == want
    assert want < sum(v.numel() for v in model.state_dict().values())  # BatchNorm statistics not counted


def test_load_pretrained_params_keeps_the_optimizer_state():
    from sfa3d_tpu_torch.config.train import OptimConfig
    from sfa3d_tpu_torch.parallel import create_train_state
    from sfa3d_tpu_torch.runtime.schedules import create_optimizer

    model = create_model("fpn_resnet_18").init_weights(torch.Generator().manual_seed(0))
    state = create_train_state(model, create_optimizer(OptimConfig(), num_epochs=1, steps_per_epoch=1))
    out = model(torch.rand(1, 3, 64, 64))
    sum(v.sum() for v in out.values()).backward()
    state.optimizer.step()
    state.step = 5
    moments = {k: {n: t.clone() for n, t in s.items()} for k, s in state.optimizer.state.items()}
    assert moments
    other = create_model("fpn_resnet_18").init_weights(torch.Generator().manual_seed(1)).state_dict()
    other["bn1.running_mean"] = torch.full((64,), 0.25)
    assert checkpoint.load_pretrained_params(state, other) is state
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, other[k]), k
    assert state.step == 5
    for p, s in state.optimizer.state.items():
        for n, t in s.items():
            assert torch.equal(t, moments[p][n]), n
    # the parameters are still the optimizer's
    assert {id(p) for g in state.optimizer.param_groups for p in g["params"]} == \
        {id(p) for p in state.model.parameters()}


def test_time_synchronized_is_monotone_and_syncs_the_card(monkeypatch):
    stamps = [logger.time_synchronized("cpu") for _ in range(50)]
    assert all(b >= a for a, b in zip(stamps, stamps[1:]))
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: synced.append(device))
    t0 = logger.time_synchronized("cpu")
    t1 = logger.time_synchronized("cuda")
    assert synced == ["cuda"] and t1 >= t0


def test_kitti_inverse_calibrations_equal_jax():
    from sfa3d_tpu.config import kitti as jcnf
    from sfa3d_tpu_torch.config import kitti as cnf

    for name in ("R0_inv", "Tr_velo_to_cam_inv", "P2_inv"):
        np.testing.assert_array_equal(getattr(cnf, name), getattr(jcnf, name), err_msg=name)
