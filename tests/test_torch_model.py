"""The port's KFPN, weight bridge and clamped sigmoid against the JAX
package on the CPU, at a 64x64 BEV."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfa3d_tpu.models import clamped_sigmoid as jclamped_sigmoid
from sfa3d_tpu.models import create_model as jcreate_model
from sfa3d_tpu.models.port import export_kfpn_state_dict
from sfa3d_tpu.pipeline import init_detector as jinit_detector
from sfa3d_tpu_torch.models import clamped_sigmoid, create_model
from sfa3d_tpu_torch.models.port import load_torch_checkpoint, state_dict_from_jax
from sfa3d_tpu_torch.pipeline import forward_heads

HEADS_TOL = 1e-4  # float32 conv sums in another order than XLA's


@pytest.fixture(scope="module")
def jax_variables():
    """JAX init at 64x64, with BatchNorm statistics and affine terms and all
    biases drawn at random so that every parameter's mapping is exercised."""
    model = jcreate_model("fpn_resnet_18")
    variables = jinit_detector(model, jax.random.PRNGKey(3), input_size=(64, 64))
    variables = jax.tree_util.tree_map(lambda t: np.array(t), variables)
    rng = np.random.default_rng(11)

    def perturb(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                perturb(v)
            elif k in ("var", "scale"):
                tree[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif k in ("mean", "bias"):
                tree[k] = (v + rng.normal(0, 0.1, v.shape)).astype(np.float32)

    perturb(variables)
    return model, variables


def test_state_dict_from_jax_equals_export(jax_variables):
    _, variables = jax_variables
    ours = state_dict_from_jax(variables, num_layers=18)
    ref = export_kfpn_state_dict(variables, num_layers=18)
    assert list(ours) == list(ref)
    for k, v in ref.items():
        assert ours[k].dtype == (torch.int64 if k.endswith("num_batches_tracked") else torch.float32), k
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)


def test_kfpn_heads_match_jax(jax_variables, rng):
    jmodel, variables = jax_variables
    model = create_model("fpn_resnet_18")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    model.eval()
    bev = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    want = jmodel.apply(variables, jnp.asarray(bev), train=False)
    got = forward_heads(model, torch.from_numpy(bev))
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].shape == w.shape == (2, 16, 16, w.shape[-1])
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0, atol=HEADS_TOL, err_msg=k)


def test_random_init_follows_the_jax_recipe():
    gen = torch.Generator().manual_seed(0)
    model = create_model("fpn_resnet_18").init_weights(gen)
    again = create_model("fpn_resnet_18").init_weights(torch.Generator().manual_seed(0))
    for (k, a), b in zip(model.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), k
    for i in range(3):
        assert torch.all(getattr(model, f"fpn{i}_hm_cen")[2].bias == -2.19)
        assert getattr(model, f"fpn{i}_dim")[2].weight.std() < 0.002
    w = model.conv1.weight
    assert abs(w.std().item() - (1 / (3 * 49)) ** 0.5) < 0.02
    assert torch.all(model.bn1.running_var == 1) and torch.all(model.bn1.running_mean == 0)


def test_clamped_sigmoid_forward_and_straight_through_grad():
    x = np.linspace(-15, 15, 301).astype(np.float32)
    want = np.asarray(jclamped_sigmoid(jnp.asarray(x)))
    t = torch.from_numpy(x).requires_grad_(True)
    p = clamped_sigmoid(t)
    # XLA's and PyTorch's float32 sigmoid may differ by one ulp
    np.testing.assert_allclose(p.detach().numpy(), want, rtol=1.2e-7, atol=0)
    np.testing.assert_allclose(
        p.detach().numpy(), np.clip(1 / (1 + np.exp(-x.astype(np.float64))), 1e-4, 1 - 1e-4),
        rtol=0, atol=1e-7,
    )
    p.sum().backward()
    s = torch.sigmoid(torch.from_numpy(x))
    np.testing.assert_allclose(t.grad.numpy(), (s * (1 - s)).numpy(), rtol=1e-6, atol=0)
    below = x < -9.3  # sigmoid below the 1e-4 clamp
    assert below.any() and (t.grad.numpy()[below] > 0).all()


def test_clamped_sigmoid_runs_at_least_float32():
    x = torch.zeros(4, dtype=torch.bfloat16)
    assert clamped_sigmoid(x).dtype == torch.float32
    assert clamped_sigmoid(x.double()).dtype == torch.float64


def test_load_torch_checkpoint_unwraps_and_strips(jax_variables, tmp_path):
    _, variables = jax_variables
    sd = state_dict_from_jax(variables)
    path = tmp_path / "Model_fpn_resnet_18_epoch_1.pth"
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}}, path)
    loaded = load_torch_checkpoint(str(path))
    assert list(loaded) == list(sd)
    model = create_model("fpn_resnet_18")
    model.load_state_dict(loaded, strict=True)

    from sfa3d_tpu_torch.detector import Detector

    det = Detector(checkpoint=str(path), device="cpu")
    for k, v in det.model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    assert not det.model.training


def test_unported_options_raise(tmp_path):
    from sfa3d_tpu_torch.detector import Detector

    with pytest.raises(ValueError, match="unknown arch"):
        create_model("dla_34")
    with pytest.raises(ValueError, match="unknown compute dtype"):  # bfloat16 is served since slice 12
        Detector(device="cpu", dtype="float16")
    with pytest.raises(NotImplementedError, match="Orbax"):
        Detector(checkpoint=str(tmp_path), device="cpu")
