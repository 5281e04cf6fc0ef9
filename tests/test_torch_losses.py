"""The port's detection losses (`sfa3d_tpu_torch/losses/`) against the JAX
package's on the CPU in float32: the loss terms within 1e-6 relative, and
the gradient of the total loss with respect to each raw head output within
1e-6 of that head's largest |gradient| (against `jax.grad`).

The focal term is a float32 sum of B x H x W x C log terms, which PyTorch
and XLA add in other orders: at 2 x 16 x 16 x 3 the terms agree within
4.4e-7 over eight seeds, at 2 x 32 x 32 x 3 within 1.4e-6. The tests use
the smaller heatmap."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfa3d_tpu.losses import losses as jlosses
from sfa3d_tpu.models import clamped_sigmoid as jclamped_sigmoid
from sfa3d_tpu_torch.losses import compute_loss, focal_loss
from sfa3d_tpu_torch.models import clamped_sigmoid

RTOL = 1e-6
HEADS = {"hm_cen": 3, "cen_offset": 2, "direction": 2, "z_coor": 1, "dim": 3}


def make_data(rng, b=2, hm=16, k=50, n_obj=6):
    outputs = {h: rng.normal(0, 2.0, (b, hm, hm, c)).astype(np.float32) for h, c in HEADS.items()}
    outputs["dim"] += 1.5
    mask = np.zeros((b, k), np.float32)
    mask[:, :n_obj] = 1
    idx = (rng.integers(0, hm * hm, (b, k)) * mask).astype(np.int32)
    gt = rng.uniform(0, 0.95, (b, hm, hm, 3)).astype(np.float32) ** 3
    for bi in range(b):
        for j in range(n_obj):
            y, x = divmod(int(idx[bi, j]), hm)
            gt[bi, y, x, j % 3] = 1.0
    m = mask[..., None]
    tg = {
        "hm_cen": gt,
        "cen_offset": (rng.uniform(0, 1, (b, k, 2)) * m).astype(np.float32),
        "direction": (rng.uniform(-1, 1, (b, k, 2)) * m).astype(np.float32),
        "z_coor": (rng.uniform(0, 4, (b, k, 1)) * m).astype(np.float32),
        "dim": (rng.uniform(0.5, 4, (b, k, 3)) * m).astype(np.float32),
        "indices_center": idx,
        "obj_mask": mask,
    }
    # a few regression residuals above beta = 1, the balanced L1's other branch
    tg["dim"][:, :2] += 3.0 * m[:, :2]
    return outputs, tg


@pytest.mark.parametrize("seed", range(3))
def test_compute_loss_and_head_gradients_match_jax(seed):
    outputs, tg = make_data(np.random.default_rng(seed))
    jout = {k: jnp.asarray(v) for k, v in outputs.items()}
    jtg = {k: jnp.asarray(v) for k, v in tg.items()}
    (_, jstats), jgrads = jax.value_and_grad(lambda o: jlosses.compute_loss(o, jtg), has_aux=True)(jout)

    tout = {k: torch.from_numpy(v).requires_grad_(True) for k, v in outputs.items()}
    total, stats = compute_loss(tout, {k: torch.from_numpy(v) for k, v in tg.items()})
    total.backward()
    for k, v in jstats.items():
        assert float(stats[k].detach()) == pytest.approx(float(v), rel=RTOL), k
    for k, g in jgrads.items():
        g = np.asarray(g)
        assert np.abs(g).max() > 0, k
        np.testing.assert_allclose(tout[k].grad.numpy(), g, rtol=0, atol=RTOL * np.abs(g).max(), err_msg=k)


def test_focal_loss_without_positives_matches_jax():
    outputs, tg = make_data(np.random.default_rng(4))
    gt = np.minimum(tg["hm_cen"], 0.9)
    pred = 1.0 / (1.0 + np.exp(-outputs["hm_cen"]))
    got = focal_loss(torch.from_numpy(pred), torch.from_numpy(gt))
    want = jlosses.focal_loss(jnp.asarray(pred), jnp.asarray(gt))
    assert np.isfinite(float(got)) and float(got) == pytest.approx(float(want), rel=RTOL)


def test_clamped_sigmoid_straight_through_gradient():
    """Below the 1e-4 floor the value is clamped, but the gradient stays the
    sigmoid's (with torch.clamp's zero gradient a positive cell pushed below
    the floor never recovers), as in the JAX package."""
    x = torch.tensor(-12.0, requires_grad=True)
    y = clamped_sigmoid(x)
    assert float(y) == float(np.float32(1e-4)) == float(jclamped_sigmoid(jnp.float32(-12.0)))
    assert float(clamped_sigmoid(torch.tensor(12.0))) == float(np.float32(1.0) - np.float32(1e-4))
    y.backward()
    expect = float(jax.grad(jax.nn.sigmoid)(jnp.float32(-12.0)))
    assert float(x.grad) == pytest.approx(expect, rel=1e-6) and expect > 0
    logit = torch.tensor(-12.0, requires_grad=True)
    focal_loss(clamped_sigmoid(logit.reshape(1, 1, 1, 1)), torch.ones(1, 1, 1, 1)).backward()
    assert float(logit.grad) < 0, "a positive cell must push its logit up"
