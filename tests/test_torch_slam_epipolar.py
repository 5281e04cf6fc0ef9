"""`sfa3d_tpu_torch/slam/epipolar.py` against `sfa3d_tpu/slam/epipolar.py` on
`tests/test_slam.py::stereo_problem`'s geometry (a 0.3 rad yaw and a unit
baseline, 0.3 px noise, gross outliers), with JAX's own minimal sets: the
test draws them as `epipolar.py` does (`jax.random.split` + `choice`
without replacement over the valid slots) and hands them over as
`sample_idx`.

Tolerances: float64 (JAX under `enable_x64`): F, E, R, t, the triangulated
points and the Sampson distances within 1e-9, the masks and the
cheirality fraction equal. float32: the port's estimators solve in float64
whatever the inputs' type, so its F / F[2, 2], E, R and t lie within 1e-6
of its float64 run on the same float32-rounded inputs and its mask equals
that run's. Against JAX's float32 chain: F / F[2, 2] within 1e-3 of its
largest entry, E, R and t within 1e-4 or twice JAX's own float32 error
against the float64 solution where that is larger (2.4e-4 measured on E
and t of the padded problem), the points (triangulated in float32 by both)
within 1e-3 relative, the masks equal but for points whose distance lies
within 1e-3 (relative) of the threshold.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfa3d_tpu.slam import epipolar as jepi
from sfa3d_tpu.slam.pnp import rodrigues as jrodrigues
from sfa3d_tpu_torch.slam import epipolar as tepi

K = np.array([[720.0, 0, 609.0], [0, 720.0, 172.0], [0, 0, 1.0]], np.float32)
THRESHOLD = 2.0
# (n, n_outliers, padded slots) per problem
PROBLEMS = {"128-20-outliers": (128, 20, 0), "96-30-outliers-padded": (96, 30, 32)}


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


def stereo_problem(seed, n, n_outliers, pad):
    rng = np.random.default_rng(seed)
    R_gt = np.asarray(jrodrigues(np.array([0.02, 0.3, -0.01])), np.float64)
    t_gt = np.array([-0.54, 0.005, 0.01])
    t_gt = t_gt / np.linalg.norm(t_gt)
    X = np.stack([rng.uniform(-10, 10, n), rng.uniform(-4, 4, n), rng.uniform(5, 40, n)], axis=1)
    Kd = K.astype(np.float64)
    uv1 = X @ Kd.T
    uv1 = uv1[:, :2] / uv1[:, 2:3] + rng.normal(0, 0.3, (n, 2))
    uv2 = (X @ R_gt.T + t_gt) @ Kd.T
    uv2 = uv2[:, :2] / uv2[:, 2:3] + rng.normal(0, 0.3, (n, 2))
    idx = rng.permutation(n)[:n_outliers]
    uv2[idx] += rng.uniform(30, 150, (n_outliers, 2))
    uv1 = np.concatenate([uv1, rng.uniform(0, 500, (pad, 2))])
    uv2 = np.concatenate([uv2, rng.uniform(0, 500, (pad, 2))])
    valid = np.arange(n + pad) < n
    return uv1, uv2, valid, R_gt, t_gt


def chain(module, uv1, uv2, valid, Kx, ransac_kwargs):
    """F-RANSAC -> E -> recover_pose -> triangulate the inliers, as numpy."""
    F, mask = module.estimate_fundamental_ransac(uv1, uv2, valid, threshold=THRESHOLD, **ransac_kwargs)
    F = np.asarray(F)
    if module is tepi:
        E = tepi.essential_from_fundamental(torch.as_tensor(F), Kx, Kx)
        R, t, frac = tepi.recover_pose(E, uv1, uv2, Kx, mask)
    else:
        E = jepi.essential_from_fundamental(jnp.asarray(F), jnp.asarray(Kx), jnp.asarray(Kx))
        R, t, frac = jepi.recover_pose(E, uv1, uv2, jnp.asarray(Kx), jnp.asarray(mask))
    R, t = np.asarray(R), np.asarray(t)
    Kinv = np.linalg.inv(Kx.astype(np.float64)).astype(Kx.dtype)
    n1 = (np.concatenate([uv1, np.ones((len(uv1), 1), uv1.dtype)], 1) @ Kinv.T)[:, :2]
    n2 = (np.concatenate([uv2, np.ones((len(uv2), 1), uv2.dtype)], 1) @ Kinv.T)[:, :2]
    P1 = np.concatenate([np.eye(3), np.zeros((3, 1))], 1).astype(Kx.dtype)
    P2 = np.concatenate([R, t[:, None]], 1).astype(Kx.dtype)
    if module is tepi:
        X = tepi.triangulate_points(*(torch.as_tensor(a) for a in (P1, P2, n1, n2))).numpy()
        d = tepi.sampson_distance(torch.as_tensor(F), torch.as_tensor(uv1), torch.as_tensor(uv2)).numpy()
    else:
        X = np.asarray(jepi.triangulate_points(*(jnp.asarray(a) for a in (P1, P2, n1, n2))))
        d = np.asarray(jepi.sampson_distance(jnp.asarray(F), uv1, uv2))
    return {"F": F, "mask": np.asarray(mask), "E": np.asarray(E), "R": R, "t": t,
            "frac": float(frac), "X": X, "d": d}


def both(name, dtype, seed=2020):
    uv1, uv2, valid, R_gt, t_gt = stereo_problem(seed, *PROBLEMS[name])
    uv1, uv2, Kx = uv1.astype(dtype), uv2.astype(dtype), K.astype(dtype)
    key = jax.random.PRNGKey(0)
    with jax.enable_x64(dtype == np.float64):
        sample_idx = jax_draws(valid, 256, 8, key)
        want = chain(jepi, uv1, uv2, valid, Kx, {"rng": key})
    got = chain(tepi, uv1, uv2, valid, Kx, {"sample_idx": sample_idx, "device": "cpu"})
    if dtype == np.float64:
        return got, want, (R_gt, t_gt)
    # the port in float64 on the same float32-rounded inputs
    ref = chain(tepi, uv1.astype(np.float64), uv2.astype(np.float64), valid, Kx.astype(np.float64),
                {"sample_idx": sample_idx, "device": "cpu"})
    return got, want, ref


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_chain_float64_equals_jax(name):
    got, want, (R_gt, t_gt) = both(name, np.float64)
    assert got["F"].dtype == np.float64
    for key in ("F", "E", "R", "t", "X", "d"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-9, atol=1e-9, err_msg=key)
    assert np.array_equal(got["mask"], want["mask"]) and got["mask"].sum() >= 60
    assert got["frac"] == pytest.approx(want["frac"], abs=1e-12) and got["frac"] > 0.7
    np.testing.assert_allclose(got["R"], R_gt, atol=2e-2)
    assert abs(np.dot(got["t"], t_gt)) > 0.99


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_chain_float32_within_tolerance(name):
    got, want, ref = both(name, np.float32)
    assert got["F"].dtype == np.float32
    Fg, Fw, Fr = (r["F"] / r["F"][2, 2] for r in (got, want, ref))
    assert np.abs(Fg - Fr).max() <= 1e-6 * np.abs(Fr).max()
    assert np.abs(Fg - Fw).max() <= 1e-3 * np.abs(Fw).max()
    for key in ("E", "R", "t"):
        np.testing.assert_allclose(got[key], ref[key], rtol=0, atol=1e-6, err_msg=key)
        jax_gap = np.abs(want[key] - ref[key]).max()
        assert np.abs(got[key] - want[key]).max() <= max(1e-4, 2 * jax_gap), (key, jax_gap)
    assert np.array_equal(got["mask"], ref["mask"])
    inl = want["mask"]
    np.testing.assert_allclose(got["X"][inl], want["X"][inl], rtol=1e-3, atol=1e-3)
    near = np.abs(want["d"] - THRESHOLD ** 2) <= 1e-3 * THRESHOLD ** 2
    assert np.array_equal(got["mask"][~near], want["mask"][~near])
    assert got["frac"] == pytest.approx(want["frac"], abs=1e-6)


def test_eight_point_and_normalization_equal_jax_per_hypothesis():
    uv1, uv2, valid, _, _ = stereo_problem(5, 128, 20, 0)
    with jax.enable_x64(True):
        idx = jax_draws(valid, 12, 8, jax.random.PRNGKey(9))
        w = np.zeros((12, 128))
        np.put_along_axis(w, idx, 1.0, axis=1)
        jF = np.stack([np.asarray(jepi._eight_point(jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(wi))) for wi in w])
        jn, jT = jepi._normalize_points(jnp.asarray(uv1), jnp.asarray(w[0]))
    tF = tepi._eight_point(torch.as_tensor(uv1), torch.as_tensor(uv2), torch.as_tensor(w)).numpy()
    tn, tT = tepi._normalize_points(torch.as_tensor(uv1), torch.as_tensor(w[0]))
    np.testing.assert_allclose(tF, jF, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=0, atol=1e-12)
    np.testing.assert_allclose(tT.numpy(), np.asarray(jT), rtol=0, atol=1e-12)


def test_recover_pose_keeps_jax_candidate_order_on_ties():
    """No valid point: all four cheirality counts are 0 and both packages
    return the first candidate, (R1 = U W Vt, t = U[:, 2])."""
    uv1, uv2, valid, _, _ = stereo_problem(3, 32, 0, 0)
    with jax.enable_x64(True):
        F, _ = jepi.estimate_fundamental_ransac(uv1, uv2, valid, jax.random.PRNGKey(0), threshold=THRESHOLD)
        E = jepi.essential_from_fundamental(F, jnp.asarray(K, jnp.float64), jnp.asarray(K, jnp.float64))
        none = np.zeros(32, bool)
        jR, jt, jfrac = (np.asarray(a) for a in jepi.recover_pose(E, uv1, uv2, jnp.asarray(K, jnp.float64), none))
    tR, tt, tfrac = tepi.recover_pose(torch.as_tensor(np.asarray(E)), uv1, uv2, K.astype(np.float64), none)
    assert float(jfrac) == float(tfrac) == 0.0
    np.testing.assert_allclose(tR.numpy(), jR, rtol=0, atol=1e-9)
    np.testing.assert_allclose(tt.numpy(), jt, rtol=0, atol=1e-9)


def test_triangulation_of_far_points_equals_jax():
    """Points 1e3 to 1e5 baselines away, where the homogeneous coordinate w
    is tiny: the same points and signs as JAX's in float64."""
    rng = np.random.default_rng(4)
    X = np.stack([rng.uniform(-50, 50, 16), rng.uniform(-5, 5, 16), np.logspace(3, 5, 16)], axis=1)
    P1 = np.concatenate([np.eye(3), np.zeros((3, 1))], 1)
    P2 = np.concatenate([np.eye(3), np.array([[-1.0], [0.0], [0.0]])], 1)
    n1 = X[:, :2] / X[:, 2:3]
    c2 = X + P2[:, 3]
    n2 = c2[:, :2] / c2[:, 2:3]
    with jax.enable_x64(True):
        jX = np.asarray(jepi.triangulate_points(*(jnp.asarray(a) for a in (P1, P2, n1, n2))))
    tX = tepi.triangulate_points(*(torch.as_tensor(a) for a in (P1, P2, n1, n2))).numpy()
    np.testing.assert_allclose(tX, jX, rtol=1e-9, atol=1e-9)
    assert (tX[:, 2] > 0).all()
    np.testing.assert_allclose(tX, X, rtol=1e-3)


def test_estimators_run_on_cuda_unless_asked(monkeypatch):
    uv1, uv2, valid, _, _ = stereo_problem(3, 32, 0, 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tepi.estimate_fundamental_ransac(uv1, uv2, valid)
