"""`sfa3d_tpu_torch/slam/stereo.py` against `sfa3d_tpu/slam/stereo.py` and
cv2 on the JAX writer's mini-KITTI stereo pair (375 x 1242, a true 0.54 m
baseline along x), both packages reading the files JAX's writer wrote.

- The matcher, given the same descriptors, returns cv2.BFMatcher(
  NORM_HAMMING, crossCheck=True)'s list sorted by distance exactly (pairs,
  order, distances), on cv2's descriptors of the pair and on random
  descriptors with many ties, also when it reduces the distances a few
  query rows at a time.
- The port's whole stack (its ORB, matcher and chain, its own sampler)
  meets tests/test_slam.py's bounds on the pair: success, >= 100 inliers,
  R within 3 degrees of identity, |t_x| > 0.98; its matches are cv2's 1814.
- Against JAX's result, with JAX's minimal sets (drawn as `epipolar.py`
  draws them, handed over as `sample_idx`): the same match count and
  inliers, R within 0.5 degrees and t within 1 degree (measured 0 and
  0.0016: the port solves in float64, JAX in float32). With the port's own
  draws the answer moves with the draws, as JAX's does with its key: over
  keys 1-7 JAX's R lies 0.41 to 1.59 degrees and its t 0.76 to 36.8
  degrees from its key-0 answer. So R within 0.5 and t within 1 degree of
  JAX's key-0 answer is not met on the port's own sampler (1.15 and 6.54
  degrees measured); the test holds that answer to the ground-truth
  bounds and to within JAX's own spread over keys 0-7.
- Given cv2's matches and JAX's draws in float64 (JAX under enable_x64),
  F, E, R and t equal JAX's within 1e-9 and the masks are equal.
- `save_estimated_calibration` writes JAX's bytes given the same result.
"""

import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfa3d_tpu.geometry.calibration import read_calib_file
from sfa3d_tpu.slam import epipolar as jepi
from sfa3d_tpu.slam import stereo as jstereo
from sfa3d_tpu_torch.data.png import read_png_grey
from sfa3d_tpu_torch.slam import epipolar as tepi
from sfa3d_tpu_torch.slam import stereo as tstereo


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_draws(valid, iterations, sample_size, key):
    n = valid.shape[0]
    probs = valid.astype(jnp.float32)
    probs = probs / jnp.maximum(probs.sum(), 1.0)
    return np.asarray(jax.vmap(
        lambda k: jax.random.choice(k, n, shape=(sample_size,), replace=False, p=probs)
    )(jax.random.split(key, iterations)))


def angle_deg(Ra, Rb):
    return np.degrees(np.arccos(np.clip((np.trace(Ra @ Rb.T) - 1) / 2, -1, 1)))


def direction_deg(ta, tb):
    cos = abs(np.dot(ta, tb)) / (np.linalg.norm(ta) * np.linalg.norm(tb))
    return np.degrees(np.arccos(min(1.0, cos)))


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    from sfa3d_tpu.data.synthetic import write_mini_kitti

    root = write_mini_kitti(str(tmp_path_factory.mktemp("stereo") / "kitti"), n_frames=1)
    left, right = (read_png_grey(f"{root}/training/image_{s}/000000.png") for s in (2, 3))
    K = read_calib_file(f"{root}/training/calib/000000.txt")["P2"].reshape(3, 4)[:, :3]
    jresult = jstereo.perform_targetless_stereo_calibration(left, right, K, min_matches=30)
    p1, p2 = jstereo.match_orb_features(left, right)
    valid = np.arange(1024) < min(len(p1), 1024)
    sample_idx = jax_draws(valid, 256, 8, jax.random.PRNGKey(0))
    return {"left": left, "right": right, "K": K, "jax": jresult, "matches": (p1, p2),
            "sample_idx": sample_idx, "root": root}


def test_matcher_equals_cv2_on_the_pair(pair):
    orb = cv2.ORB_create(5000)
    _, d1 = orb.detectAndCompute(pair["left"], None)
    _, d2 = orb.detectAndCompute(pair["right"], None)
    want = sorted(cv2.BFMatcher(cv2.NORM_HAMMING, crossCheck=True).match(d1, d2), key=lambda m: m.distance)
    qi, ti, dist = tstereo.match_descriptors(torch.as_tensor(d1), torch.as_tensor(d2))
    assert len(want) == 1814
    assert [(m.queryIdx, m.trainIdx, m.distance) for m in want] == list(
        zip(qi.tolist(), ti.tolist(), dist.to(torch.float32).tolist()))


@pytest.mark.parametrize("seed", [0, 1])
def test_matcher_equals_cv2_on_tied_descriptors(seed):
    """Descriptors that differ in few bits and repeat: many equal distances,
    where the first index and the stable sort decide."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (40, 32), dtype=np.uint8)
    d1 = base[rng.integers(0, 40, 300)] ^ (rng.random((300, 32)) < 0.02).astype(np.uint8)
    d2 = base[rng.integers(0, 40, 280)] ^ (rng.random((280, 32)) < 0.02).astype(np.uint8)
    want = sorted(cv2.BFMatcher(cv2.NORM_HAMMING, crossCheck=True).match(d1, d2), key=lambda m: m.distance)
    qi, ti, dist = tstereo.match_descriptors(torch.as_tensor(d1), torch.as_tensor(d2))
    assert len(want) > 10
    assert [(m.queryIdx, m.trainIdx, m.distance) for m in want] == list(
        zip(qi.tolist(), ti.tolist(), dist.to(torch.float32).tolist()))
    bits = np.unpackbits(d1[:, None, :] ^ d2[None, :, :], axis=2).sum(2)
    assert np.array_equal(tstereo.hamming_distances(torch.as_tensor(d1), torch.as_tensor(d2)).numpy(), bits)


@pytest.fixture(scope="module")
def own_sampler(pair):
    """The port's whole stack on the pair, its own sampler."""
    return tstereo.perform_targetless_stereo_calibration(pair["left"], pair["right"], pair["K"],
                                                         min_matches=30, device="cpu")


@pytest.mark.parametrize("rows", [1, 7, 64])
def test_matcher_blocks_equal_cv2(monkeypatch, rows):
    """The same list when the distances are reduced a few query rows at a
    time: ties between blocks keep the first query."""
    rng = np.random.default_rng(rows)
    base = rng.integers(0, 256, (30, 32), dtype=np.uint8)
    d1 = base[rng.integers(0, 30, 200)] ^ (rng.random((200, 32)) < 0.02).astype(np.uint8)
    d2 = base[rng.integers(0, 30, 180)] ^ (rng.random((180, 32)) < 0.02).astype(np.uint8)
    monkeypatch.setattr(tstereo, "MATCH_BLOCK_BYTES", 4 * 180 * rows)
    want = sorted(cv2.BFMatcher(cv2.NORM_HAMMING, crossCheck=True).match(d1, d2), key=lambda m: m.distance)
    qi, ti, dist = tstereo.match_descriptors(torch.as_tensor(d1), torch.as_tensor(d2))
    assert len(want) > 10
    assert [(m.queryIdx, m.trainIdx, m.distance) for m in want] == list(
        zip(qi.tolist(), ti.tolist(), dist.to(torch.float32).tolist()))


def test_whole_stack_meets_the_ground_truth_bounds(pair, own_sampler):
    result = own_sampler
    assert result.success, result.reason
    assert result.n_matches == pair["jax"].n_matches == 1814
    assert result.n_inliers >= 100
    assert angle_deg(result.R, np.eye(3)) < 3.0
    t = result.t / np.linalg.norm(result.t)
    assert abs(t[0]) > 0.98, t


def test_whole_stack_own_sampler_within_jax_key_spread(pair, own_sampler):
    """The port's own-sampler R and t no farther from JAX's key-0 answer
    than JAX's own answers over keys 1-7 (on cv2's matches, which equal the
    port's) lie from it."""
    want = pair["jax"]
    p1, p2 = pair["matches"]
    m = min(len(p1), 1024)
    a, b = np.zeros((1024, 2), np.float32), np.zeros((1024, 2), np.float32)
    a[:m], b[:m] = p1[:m], p2[:m]
    valid = np.arange(1024) < m
    K = jnp.asarray(pair["K"], jnp.float32)
    spread_R, spread_t = [], []
    for key in range(1, 8):
        F, mask = jepi.estimate_fundamental_ransac(a, b, valid, jax.random.PRNGKey(key), threshold=3.0)
        R, t, _ = jepi.recover_pose(jepi.essential_from_fundamental(F, K, K), a, b, K, mask)
        spread_R.append(angle_deg(np.asarray(R), want.R))
        spread_t.append(direction_deg(np.asarray(t), want.t))
    got = own_sampler
    assert angle_deg(got.R, want.R) <= max(spread_R), (angle_deg(got.R, want.R), spread_R)
    assert direction_deg(got.t, want.t) <= max(spread_t), (direction_deg(got.t, want.t), spread_t)


def test_whole_stack_on_jax_draws_agrees_with_jax(pair):
    want = pair["jax"]
    got = tstereo.perform_targetless_stereo_calibration(pair["left"], pair["right"], pair["K"], min_matches=30,
                                                        sample_idx=pair["sample_idx"], device="cpu")
    assert got.success and want.success
    assert (got.n_matches, got.n_inliers) == (want.n_matches, want.n_inliers)
    assert got.cheirality_fraction == pytest.approx(want.cheirality_fraction, abs=1e-6)
    assert angle_deg(got.R, want.R) < 0.5
    assert direction_deg(got.t, want.t) < 1.0


def test_chain_on_cv2_matches_float64_equals_jax(pair):
    p1, p2 = pair["matches"]
    a = np.zeros((1024, 2))
    b = np.zeros((1024, 2))
    m = min(len(p1), 1024)
    a[:m], b[:m] = p1[:m], p2[:m]
    valid = np.arange(1024) < m
    K = pair["K"].astype(np.float64)
    with jax.enable_x64(True):
        jF, jmask = jepi.estimate_fundamental_ransac(a, b, valid, jax.random.PRNGKey(0), threshold=3.0)
        jE = jepi.essential_from_fundamental(jF, jnp.asarray(K), jnp.asarray(K))
        jR, jt, jfrac = (np.asarray(v) for v in jepi.recover_pose(jE, a, b, jnp.asarray(K), jmask))
        jF, jE, jmask = np.asarray(jF), np.asarray(jE), np.asarray(jmask)
    tF, tmask = tepi.estimate_fundamental_ransac(a, b, valid, sample_idx=pair["sample_idx"], threshold=3.0,
                                                 device="cpu")
    tE = tepi.essential_from_fundamental(tF, K, K)
    tR, tt, tfrac = tepi.recover_pose(tE, a, b, K, tmask)
    assert np.array_equal(tmask.numpy(), jmask)
    for got, want in ((tF, jF), (tE, jE), (tR, jR), (tt, jt)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=1e-9)
    assert float(tfrac) == pytest.approx(float(jfrac), abs=1e-7)


@pytest.mark.parametrize("success", [True, False])
def test_save_estimated_calibration_writes_jax_bytes(pair, tmp_path, success):
    calib = read_calib_file(os.path.join(pair["root"], "training", "calib", "000000.txt"))
    rng = np.random.default_rng(3)
    result = dict(success=success, R=rng.normal(size=(3, 3)), t=rng.normal(size=3), n_matches=10,
                  n_inliers=9, cheirality_fraction=0.9)
    jstereo.save_estimated_calibration(str(tmp_path / "j.txt"), calib, jstereo.StereoCalibResult(**result))
    tstereo.save_estimated_calibration(str(tmp_path / "t.txt"), calib, tstereo.StereoCalibResult(**result))
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    assert ("R_stereo_estimated" in (tmp_path / "t.txt").read_text()) == success


def test_failure_reasons_equal_jax(pair):
    want = jstereo.perform_targetless_stereo_calibration(pair["left"], pair["right"], pair["K"], min_matches=5000)
    got = tstereo.perform_targetless_stereo_calibration(pair["left"], pair["right"], pair["K"], min_matches=5000,
                                                        device="cpu")
    assert (got.success, got.n_matches, got.reason) == (want.success, want.n_matches, want.reason)


def test_stereo_runs_on_cuda_unless_asked(pair, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tstereo.perform_targetless_stereo_calibration(pair["left"], pair["right"], pair["K"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tstereo.match_orb_features(pair["left"], pair["right"])
