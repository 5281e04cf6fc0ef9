"""The port's deconv arch (`resnet_18`, `models/centernet_deconv.py`) against
the JAX package's `DeconvCenterNet` on the CPU: the transposed convolution
on odd and even inputs, the heads with bridged weights, the state_dict
layout of `sfa3d_tpu/models/port.py::port_deconv_state_dict`, and
`detect_frames` at full size.

Tolerances: HEADS_TOL 1e-4 on the heads (float32 conv sums in another order
than XLA's, through 17 convs and 3 deconvs), DECONV_TOL 1e-5 on one
transposed convolution (a 16-term sum per input channel), and DET_TOL 1e-3
on detections (the repo's detection parity tolerance)."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfa3d_tpu.data.synthetic import synthetic_scene
from sfa3d_tpu.models import create_model as jcreate_model
from sfa3d_tpu.models.port import port_deconv_state_dict
from sfa3d_tpu.ops.bev import filter_and_pad_points as jfilter_and_pad_points
from sfa3d_tpu.pipeline import detect_frames as jdetect_frames
from sfa3d_tpu_torch.detector import Detector
from sfa3d_tpu_torch.models import create_model
from sfa3d_tpu_torch.models.centernet_deconv import DeconvCenterNet
from sfa3d_tpu_torch.models.port import deconv_state_dict_from_jax
from sfa3d_tpu_torch.pipeline import detect_frames, forward_heads

HEADS_TOL = 1e-4
DECONV_TOL = 1e-5
DET_TOL = 1e-3


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's side runs on one intra-op thread: in a loaded multi-worker
    run more threads only wait on each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _variables(hw, seed, hm_bump=0.0):
    """JAX init of the deconv model with BatchNorm statistics and affine
    terms drawn at random (every parameter's mapping exercised)."""
    jmodel = jcreate_model("resnet_18")
    variables = jmodel.init(jax.random.PRNGKey(seed), jnp.zeros((1, *hw, 3), jnp.float32), train=False)
    variables = jax.tree_util.tree_map(lambda t: np.array(t), variables)
    rng = np.random.default_rng(seed + 10)

    def perturb(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                perturb(v)
            elif k in ("var", "scale"):
                tree[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif k == "mean":
                tree[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)

    perturb(variables["batch_stats"])
    for name, node in variables["params"].items():
        if name.startswith("deconv_bn"):
            perturb(node)
    if hm_bump:
        # the init's N(0, 0.001) deconv kernels give a flat heatmap whose top
        # 50 are float32 ties; He-scaled kernels give distinct peaks
        for i in range(3):
            k = variables["params"][f"deconv{i}"]["kernel"]
            variables["params"][f"deconv{i}"]["kernel"] = rng.normal(
                0, np.sqrt(2.0 / (4 * k.shape[-1])), k.shape).astype(np.float32)
        variables["params"]["head_hm_cen"]["conv2"]["bias"] += hm_bump
    return jmodel, variables


@pytest.mark.parametrize("hw", [(4, 6), (5, 7), (1, 1)], ids=["even", "odd", "one"])
def test_conv_transpose_same_equals_torch_padding_1(hw):
    """flax ConvTranspose(k 4, s 2, 'SAME', transpose_kernel=True) is torch
    ConvTranspose2d(k 4, s 2, p 1) with the bridged kernel, at any size."""
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (2, *hw, 8)).astype(np.float32)
    layer = fnn.ConvTranspose(16, (4, 4), strides=(2, 2), padding="SAME", transpose_kernel=True, use_bias=False)
    params = layer.init(jax.random.PRNGKey(0), jnp.asarray(x))
    kernel = np.asarray(params["params"]["kernel"])  # (kH, kW, O, I)
    want = np.asarray(layer.apply(params, jnp.asarray(x)))
    conv = torch.nn.ConvTranspose2d(8, 16, 4, stride=2, padding=1, bias=False)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()))
        got = conv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 2 * hw[0], 2 * hw[1], 16)
    np.testing.assert_allclose(got, want, rtol=0, atol=DECONV_TOL)


def test_deconv_state_dict_round_trips_the_reference_layout():
    """Key for key: the port's bridge gives the reference deconv PoseResNet
    names (`deconv_layers.{3i}`, `{3i+1}`, `{head}.0/.2`) that the JAX
    package's `port_deconv_state_dict` reads back into the same variables,
    and DeconvCenterNet loads it with strict=True."""
    _, variables = _variables((64, 64), 2)
    sd = deconv_state_dict_from_jax(variables)
    model = DeconvCenterNet()
    assert list(sd) == list(model.state_dict())
    model.load_state_dict(sd, strict=True)
    back = port_deconv_state_dict({k: v.numpy() for k, v in sd.items()})
    flat_want = jax.tree_util.tree_leaves_with_path(variables)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_got) == len(flat_want)
    for path, v in flat_want:
        np.testing.assert_array_equal(flat_got[path], v, err_msg=jax.tree_util.keystr(path))
    assert [k for k in sd if k.startswith("deconv_layers.")][:2] == ["deconv_layers.0.weight",
                                                                      "deconv_layers.1.weight"]


@pytest.mark.parametrize("hw", [(64, 64), (96, 64)], ids=["64x64", "96x64"])
def test_deconv_heads_match_jax(hw):
    jmodel, variables = _variables(hw, 3)
    model = create_model("resnet_18")
    assert isinstance(model, DeconvCenterNet)
    model.load_state_dict(deconv_state_dict_from_jax(variables), strict=True)
    model.eval()
    bev = np.random.default_rng(4).uniform(0, 1, (2, *hw, 3)).astype(np.float32)
    want = jmodel.apply(variables, jnp.asarray(bev), train=False)
    got = forward_heads(model, torch.from_numpy(bev))
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape == (2, hw[0] // 4, hw[1] // 4, want[k].shape[-1]), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=HEADS_TOL, err_msg=k)


def test_init_weights_follows_the_jax_init():
    model = DeconvCenterNet().init_weights(torch.Generator().manual_seed(0))
    sd = model.state_dict()
    assert torch.all(sd["hm_cen.2.bias"] == -2.19)
    assert float(sd["dim.2.weight"].std()) < 0.002 and float(sd["deconv_layers.3.weight"].std()) < 0.002
    assert torch.all(sd["deconv_layers.1.running_var"] == 1) and torch.all(sd["cen_offset.0.bias"] == 0)


def test_detect_frames_with_resnet_18_matches_jax(tmp_path):
    jmodel, variables = _variables((608, 608), 5, hm_bump=2.0)
    sd = deconv_state_dict_from_jax(variables)
    model = create_model("resnet_18")
    model.load_state_dict(sd, strict=True)
    model.eval()
    scan, _ = synthetic_scene(seed=6)
    pts, valid = jfilter_and_pad_points(scan)
    want = jdetect_frames(jmodel, variables, pts[None], valid[None], K=50, peak_thresh=0.2)
    want = {k: np.asarray(v) for k, v in want.items()}
    got = detect_frames(model, pts[None], valid[None], K=50, peak_thresh=0.2, device="cpu")
    got = {k: v.numpy() for k, v in got.items()}
    # scores are distinct, so the top-K order is the same on both sides
    np.testing.assert_array_equal(got["mask"], want["mask"])
    assert want["mask"].sum() > 0, "fixture produced no detections; the test would be vacuous"
    np.testing.assert_allclose(got["boxes_real"], want["boxes_real"], rtol=0, atol=DET_TOL)
    ref = want["boxes_real"][0][want["mask"][0]]

    # the same weights through a .pth checkpoint and Detector(arch="resnet_18")
    path = tmp_path / "Model_resnet_18.pth"
    torch.save(sd, path)
    det = Detector(arch="resnet_18", checkpoint=str(path), device="cpu")
    dets = det.detect(scan)
    assert len(dets) == len(ref)
    rows = np.asarray([[d["class_id"], d["x"], d["y"], d["z"], d["h"], d["w"], d["l"], d["yaw"]] for d in dets])
    np.testing.assert_allclose(rows, ref, rtol=0, atol=DET_TOL)  # in score order, as format_detections gives them
