"""The port's training targets (`sfa3d_tpu_torch/ops/targets.py`) against
the JAX package's `build_targets` (jitted, as the loader runs it) on the
CPU: indices and masks bit-exact, the centre offsets, z and dimensions
exact, the heatmap and direction (exp, sin, cos) within 2 float32 ulps
relative (HM_RTOL)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfa3d_tpu.ops import targets as jtargets
from sfa3d_tpu_torch.ops.targets import _gaussian_splat, build_targets, compute_radius

HM_RTOL = 2.4e-7  # exp / sin / cos: one ulp between XLA's and PyTorch's libm, twice
M = 50


def make_labels(rng, b=4):
    """Random rows around the detection range, with the edge cases the
    targets must get right: every class incl. ignore ids -1 and -3, labels
    outside the range, on the max x and y boundaries and on y = min, zero
    dimensions, and padded slots past n_valid."""
    lab = np.zeros((b, M, 8), np.float32)
    lab[..., 0] = rng.integers(-3, 3, (b, M))
    lab[..., 1] = rng.uniform(-2, 52, (b, M))
    lab[..., 2] = rng.uniform(-27, 27, (b, M))
    lab[..., 3] = rng.uniform(-3.0, 1.5, (b, M))
    lab[..., 4:7] = rng.uniform(0.3, 5.0, (b, M, 3))
    lab[..., 7] = rng.uniform(-4, 4, (b, M))
    lab[:, 0, 1] = 50.0  # x on the max boundary: the guard row
    lab[:, 1, 2] = 25.0  # y on the max boundary: centre x == hm_w
    lab[:, 2, 2] = -25.0  # y on the min boundary: column 0
    lab[:, 3, 1] = 0.0
    lab[:, 4, 5] = 0.0  # zero width: inactive
    lab[:, 5, 0] = -1  # ignore every class
    lab[:, 6, 0] = -3  # ignore class 1
    lab[:, 5:7, 1:4] = [20.0, 0.0, -1.0]
    n_valid = rng.integers(20, M + 1, b).astype(np.int32)
    hflip = np.arange(b) % 2 == 1
    return lab, n_valid, hflip


def jax_targets(lab, n_valid, hflip):
    outs = [jtargets.build_targets(jnp.asarray(lab[i]), jnp.int32(n_valid[i]), jnp.bool_(hflip[i]))
            for i in range(len(lab))]
    return {k: np.stack([np.asarray(o[k]) for o in outs]) for k in outs[0]}


@pytest.mark.parametrize("seed", range(4))
def test_build_targets_matches_jax(seed):
    lab, n_valid, hflip = make_labels(np.random.default_rng(seed))
    got = build_targets(torch.from_numpy(lab), torch.from_numpy(n_valid), torch.from_numpy(hflip))
    want = jax_targets(lab, n_valid, hflip)
    assert set(got) == set(want)
    for k in ("indices_center", "obj_mask", "cen_offset", "z_coor", "dim"):
        assert got[k].dtype == torch.from_numpy(want[k]).dtype, k
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    for k in ("hm_cen", "direction"):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=HM_RTOL, atol=1e-30, err_msg=k)
    hm = got["hm_cen"].numpy()
    assert (hm == 1.0).sum() > 0 and got["obj_mask"].sum() > 10  # not vacuous
    # the edge rows: on the max x boundary never a positive; on the max y
    # boundary neither, flipped or not; the ignore slots paint 0.9999 at most
    assert not got["obj_mask"][:, 0].any() and not got["obj_mask"][:, 1].any()
    assert not got["obj_mask"][:, 5:7].any()
    assert hm.max() <= 1.0 and np.isclose(hm, np.float32(0.9999)).any()


def test_hflip_mirrors_the_centre_exactly():
    """A label at y = 3 m: flipped, its centre is hm_w - c, and the offsets
    of the two versions add up to one cell."""
    lab = np.zeros((2, M, 8), np.float32)
    lab[:, 0] = [1, 20.0, 3.0, -1.0, 1.5, 1.6, 3.9, 0.3]
    got = build_targets(torch.from_numpy(lab), torch.tensor([1, 1]), torch.tensor([False, True]))
    want = jax_targets(lab, np.int32([1, 1]), np.array([False, True]))
    np.testing.assert_array_equal(got["indices_center"].numpy(), want["indices_center"])
    np.testing.assert_array_equal(got["cen_offset"].numpy(), want["cen_offset"])
    cx = got["cen_offset"][:, 0, 0] + (got["indices_center"][:, 0] % 152).float()
    assert float(cx[0] + cx[1]) == pytest.approx(152.0, abs=2e-5)
    assert float(got["direction"][0, 0, 0]) == -float(got["direction"][1, 0, 0])


def test_compute_radius_and_splat_match_jax():
    rng = np.random.default_rng(3)
    h = torch.from_numpy(np.ceil(rng.uniform(0.1, 40, 500)).astype(np.float32))
    w = torch.from_numpy(np.ceil(rng.uniform(0.1, 40, 500)).astype(np.float32))
    got = compute_radius((h, w)).numpy()
    want = np.asarray(jax.jit(jtargets.compute_radius)((jnp.asarray(h.numpy()), jnp.asarray(w.numpy()))))
    # the integer radius is what the targets use: exact. The float radius
    # within 1e-5: under jit XLA contracts b * b - 4 * c into a fused
    # multiply-add before the square root
    np.testing.assert_array_equal(got.astype(np.int32), want.astype(np.int32))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    centers = rng.integers(-3, 40, (6, 2)).astype(np.int32)
    radii = np.int32([0, 1, 2, 5, 9, 30])
    got = _gaussian_splat(torch.from_numpy(centers), torch.from_numpy(radii), 37, 41).numpy()
    splat = jax.jit(jax.vmap(lambda c, r: jtargets._gaussian_splat(c, r, 37, 41)))
    want = np.asarray(splat(jnp.asarray(centers), jnp.asarray(radii)))
    np.testing.assert_allclose(got, want, rtol=HM_RTOL, atol=1e-30)
    assert ((got > 0) == (want > 0)).all()


def test_frames_of_a_batch_are_independent():
    lab, n_valid, hflip = make_labels(np.random.default_rng(9))
    whole = build_targets(torch.from_numpy(lab), torch.from_numpy(n_valid), torch.from_numpy(hflip))
    for i in range(len(lab)):
        one = build_targets(torch.from_numpy(lab[i:i + 1]), torch.from_numpy(n_valid[i:i + 1]),
                            torch.from_numpy(hflip[i:i + 1]))
        for k in whole:
            assert torch.equal(whole[k][i:i + 1], one[k]), k
