"""The JAX package's KFPN reformulations, `create_model(..., s2d_stem=,
fused_heads=)`, loaded into the port's one KFPN on the CPU at a 64 x 64 BEV.

The port builds no variant: `state_dict_from_jax` turns a variant's
variables back into the standard layout (the s2d stem kernel into the 7x7
one, the fused conv pairs into the five towers).

- JAX's `convert_variables_to_s2d` and `fuse_head_params` (and both) of a
  standard init bridge to exactly the standard init's state_dict.
- The port's KFPN on each variant's variables (a perturbed standard init
  converted by JAX's converters, BatchNorm terms drawn at random) matches
  JAX's variant model within HEADS_TOL = 1e-4 (float32 conv sums in
  another order than XLA's, tests/test_torch_model.py's tolerance).
- Variables that no standard KFPN computes raise ValueError: a fresh s2d
  init (taps outside the 7x7 window) and a fused 1x1 conv whose heads mix.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfa3d_tpu.models import create_model as jcreate_model
from sfa3d_tpu.models.kfpn import convert_variables_to_s2d as jconvert_variables_to_s2d
from sfa3d_tpu.models.kfpn import fuse_head_params as jfuse_head_params
from sfa3d_tpu.pipeline import init_detector as jinit_detector
from sfa3d_tpu_torch.models import create_model
from sfa3d_tpu_torch.models.port import state_dict_from_jax
from sfa3d_tpu_torch.pipeline import forward_heads

HEADS_TOL = 1e-4
HW = (64, 64)
VARIANTS = {"s2d_stem": dict(s2d_stem=True), "fused_heads": dict(fused_heads=True),
            "both": dict(s2d_stem=True, fused_heads=True)}


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _perturbed(variables, seed):
    """BatchNorm statistics and affine terms and every bias drawn at random,
    so that each parameter's mapping shows."""
    variables = jax.tree_util.tree_map(np.array, variables)
    rng = np.random.default_rng(seed)

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


def _converted(variables, kw):
    """JAX's own converters: standard variables -> the variant's."""
    if kw.get("s2d_stem"):
        variables = jconvert_variables_to_s2d(variables)
    if kw.get("fused_heads"):
        variables = jfuse_head_params(variables)
    return jax.tree_util.tree_map(np.asarray, variables)


@pytest.fixture(scope="module")
def standard():
    """A perturbed JAX init of the standard KFPN."""
    return _perturbed(jinit_detector(jcreate_model("fpn_resnet_18"), jax.random.PRNGKey(3), input_size=HW), 11)


@pytest.fixture(scope="module")
def bev():
    return np.random.default_rng(5).uniform(0, 1, (2, *HW, 3)).astype(np.float32)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variant_variables_bridge_to_the_standard_state_dict(standard, variant):
    want = state_dict_from_jax(standard)
    got = state_dict_from_jax(_converted(standard, VARIANTS[variant]))
    assert list(got) == list(want)
    for k, w in want.items():
        assert torch.equal(got[k], w), k


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_port_kfpn_matches_jax_variant(standard, bev, variant):
    kw = VARIANTS[variant]
    variables = _converted(standard, kw)
    want = jcreate_model("fpn_resnet_18", **kw).apply(variables, jnp.asarray(bev), train=False)
    model = create_model("fpn_resnet_18")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    got = forward_heads(model.eval(), torch.from_numpy(bev))
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(w), rtol=0, atol=HEADS_TOL, err_msg=k)


@pytest.mark.parametrize("case", ["fresh_s2d_init", "mixed_fused_heads"])
def test_variables_no_standard_kfpn_computes_raise(standard, case):
    if case == "fresh_s2d_init":
        variables = jinit_detector(jcreate_model("fpn_resnet_18", s2d_stem=True), jax.random.PRNGKey(4),
                                   input_size=HW)
        variables, match = jax.tree_util.tree_map(np.array, variables), "7x7 window"
    else:
        variables, match = jax.tree_util.tree_map(np.array, _converted(standard, VARIANTS["fused_heads"])), "mixes"
        variables["params"]["fused1_conv2"]["kernel"][0, 0, 0, -1] = 0.5  # cen_offset's hidden unit into z_coor
    with pytest.raises(ValueError, match=match):
        state_dict_from_jax(variables)


def test_create_model_builds_the_standard_layout():
    model = create_model("fpn_resnet_18")
    assert model.conv1.weight.shape == (64, 3, 7, 7) and hasattr(model, "fpn0_hm_cen")
    assert not any(k.startswith("fused") for k in model.state_dict())
