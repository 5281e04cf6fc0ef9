"""`sfa3d_tpu_torch/slam/calib_sources.py` against
`sfa3d_tpu/slam/calib_sources.py` at frames 0, 1, 10, 100, 500 and 900.

The drift-only sources (every method without PnP) are numpy on both sides
and must be equal. VISUAL_SLAM_SIM with `use_pnp` runs RANSAC PnP over the
simulated 5 x 3 x 3 landmark grid; each package's call to its
`ransac_pnp` is recorded:

- the simulated correspondences, the mask and the seed handed over are
  equal (the pixels within 2 float32 ulps);
- on them, the port's estimator in float64 with JAX's draws (drawn as
  `pnp.py` draws them) equals JAX's under `enable_x64` within 1e-9;
- the function itself hands float32 inputs over, as JAX's does. The port
  solves them in float64, so its pose (read back from its calibration)
  lies within 1e-5 of the float64 solution of the same inputs and draws.
  JAX solves them in float32, and there the unnormalized DLT over
  landmarks 18-70 m away is round-off bound: JAX's float32 translation
  lies 1.13, 6.4e-5, 7.3e-3, 1.5e-2, 0.48 and 46 from float64 at frames
  0, 1, 10, 100, 500 and 900 (at 500 and 900 only 3 and 2 of the 45 points
  are inliers). So the port's calibration lies within 1e-5 of JAX's, or
  within twice JAX's own float32 error against float64 where that is
  larger: the port's gap to JAX is JAX's own, 1e-5 is met at no frame.
- With the port's own sampler the hypotheses are others, and the answer
  moves with them as JAX's moves with its key: the simulation does not
  make all 45 points inliers at 8 px (the best of 128 six-point
  hypotheses keeps 17, 45, 9, 45, 21 and 4 points at those frames; on
  JAX's key 43, 45, 44, 45, 3 and 2; over JAX's keys 0-15 at frame 0,
  32-45). The test requires its pose within 1e-5 of the float64 solution
  on its own draws, its answer within the round-off bound above of JAX's
  at frame 1 (every set's winner keeps the 45 points there, and the
  refinement over them wins), and, at every frame, inlier counts over
  the port's seeds 0-15 that a rank-sum test cannot tell apart from
  JAX's over keys 0-15 (p > 0.01; 0.10 to 0.96 measured).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sfa3d_tpu.slam.pnp as jpnp
import sfa3d_tpu_torch.slam.pnp as tpnp
from sfa3d_tpu.slam import calib_sources as jcs
from sfa3d_tpu_torch.slam import calib_sources as tcs

FRAMES = (0, 1, 10, 100, 500, 900)


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_draws(valid, iterations, sample_size, seed):
    """pnp.py's minimal sets for PRNGKey(seed), drawn as pnp.py draws them."""
    valid = np.asarray(valid.cpu() if isinstance(valid, torch.Tensor) else valid, bool)
    n = valid.shape[0]
    probs = valid.astype(jnp.float32)
    probs = probs / jnp.maximum(probs.sum(), 1.0)
    return torch.as_tensor(np.asarray(jax.vmap(
        lambda k: jax.random.choice(k, n, shape=(sample_size,), replace=False, p=probs)
    )(jax.random.split(jax.random.PRNGKey(seed), iterations))))


def path(frame):
    return f"/fake/image_2/{frame:06d}.png"


@pytest.mark.parametrize("method", tcs.SLAM_METHODS)
def test_drift_sources_equal_jax(method):
    for frame in FRAMES:
        for use_pnp in (False, True):
            if method == "VISUAL_SLAM_SIM" and use_pnp:
                continue
            want = jcs.get_calibration_from_slam(path(frame), slam_method=method, use_pnp=use_pnp)
            got = tcs.get_calibration_from_slam(path(frame), slam_method=method, use_pnp=use_pnp, device="cpu")
            assert sorted(got) == ["P2", "R0", "V2C"]
            for key in want:
                assert got[key].dtype == np.float64
                assert np.array_equal(got[key], want[key]), (method, frame, key)


def test_kitti_file_source_equals_jax(tmp_path):
    calib = tmp_path / "000007.txt"
    rng = np.random.default_rng(0)
    rows = {"P2": rng.normal(size=12), "P3": rng.normal(size=12), "R0_rect": rng.normal(size=9),
            "Tr_velo_to_cam": rng.normal(size=12)}
    calib.write_text("".join(f"{k}: {' '.join(f'{v:.12e}' for v in vals)}\n" for k, vals in rows.items()))
    want = jcs.get_calibration_from_slam(path(7), calib_file=str(calib))
    got = tcs.get_calibration_from_slam(path(7), calib_file=str(calib), device="cpu")
    for key in want:
        assert np.array_equal(got[key], want[key])


def _recording(module, calls):
    real = module.ransac_pnp

    def ransac_pnp(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append((args, kwargs))
        return out

    return real, ransac_pnp


@pytest.fixture(scope="module")
def pnp_frames():
    """Per frame: (JAX's result, the port's on JAX's draws, the port's on
    its own sampler, JAX's recorded call, the port's recorded call)."""
    jcalls, tcalls = [], []
    jreal, jrec = _recording(jpnp, jcalls)
    treal, trec = _recording(tpnp, tcalls)
    real_draws = tpnp.draw_samples
    jpnp.ransac_pnp, tpnp.ransac_pnp = jrec, trec
    out = {}
    try:
        for frame in FRAMES:
            want = jcs.get_calibration_from_slam(path(frame), slam_method="VISUAL_SLAM_SIM", use_pnp=True)
            tpnp.draw_samples = jax_draws
            got = tcs.get_calibration_from_slam(path(frame), slam_method="VISUAL_SLAM_SIM", use_pnp=True,
                                                device="cpu")
            tpnp.draw_samples = real_draws
            own = tcs.get_calibration_from_slam(path(frame), slam_method="VISUAL_SLAM_SIM", use_pnp=True,
                                                device="cpu")
            out[frame] = (want, got, own, jcalls[-1], tcalls[-2])
    finally:
        jpnp.ransac_pnp, tpnp.ransac_pnp, tpnp.draw_samples = jreal, treal, real_draws
    return out


def _pose64(frame_calls, sample_idx=None):
    """Both estimators in float64 on the recorded float32 inputs, JAX's
    draws (or, for the port, `sample_idx`)."""
    (args, kwargs), (targs, tkwargs) = frame_calls
    pts3d, pts2d, K, valid, key = args
    seed = tkwargs["seed"]
    with jax.enable_x64(True):
        jpose, jmask, _ = jpnp.ransac_pnp(*(np.asarray(a, np.float64) for a in (pts3d, pts2d, K)), valid,
                                          jax.random.PRNGKey(seed), reprojection_error=8.0)
        jpose, jmask = np.asarray(jpose), np.asarray(jmask)
    if sample_idx is None:
        sample_idx = jax_draws(valid, 128, 6, seed)
    tpose, tmask, _ = tpnp.ransac_pnp(*(np.asarray(a, np.float64) for a in (pts3d, pts2d, K)), valid,
                                      sample_idx=sample_idx, reprojection_error=8.0, device="cpu")
    return (jpose, jmask), (tpose.numpy(), tmask.numpy())


def _pose_of(calib):
    """The PnP pose (R, t) that `get_calibration_from_slam` folded into the
    calibration."""
    return calib["R0"] @ np.linalg.inv(tcs.R0_BASE), calib["V2C"][:, 3] - tcs.V2C_BASE[:, 3]


def _gaps(pose, ref):
    """max |R - R_ref| and max |t - t_ref| of (R, t) against a (3, 4) pose."""
    return np.abs(pose[0] - ref[:, :3]).max(), np.abs(pose[1] - ref[:, 3]).max()


@pytest.mark.parametrize("frame", FRAMES)
def test_pnp_simulation_hands_over_the_same_correspondences(pnp_frames, frame):
    """The landmarks, K and the mask equal; the pixels within 2 float32
    ulps (rodrigues' float32 sin and cos of the drifting pose round apart
    by an ulp)."""
    (jargs, jkw), (targs, tkw) = pnp_frames[frame][3:]
    for i in (0, 2, 3):
        assert np.array_equal(np.asarray(jargs[i]), np.asarray(targs[i]))
    np.testing.assert_allclose(np.asarray(targs[1]), np.asarray(jargs[1]), rtol=2.4e-7, atol=0)
    assert tkw["seed"] == 2020 + frame and tkw["reprojection_error"] == jkw["reprojection_error"] == 8.0
    assert np.array_equal(np.asarray(jax.random.PRNGKey(2020 + frame)), np.asarray(jargs[4]))


@pytest.mark.parametrize("frame", FRAMES)
def test_pnp_estimator_float64_equals_jax_on_the_simulation(pnp_frames, frame):
    (jpose, jmask), (tpose, tmask) = _pose64(pnp_frames[frame][3:])
    np.testing.assert_allclose(tpose, jpose, rtol=1e-9, atol=1e-9)
    assert np.array_equal(tmask, jmask)
    if frame == 0:
        assert tmask.sum() == 43


@pytest.mark.parametrize("frame", FRAMES)
def test_pnp_calibration_on_jax_draws_within_float32_round_off(pnp_frames, frame):
    """The port's pose within 1e-5 of the float64 solution; its calibration
    within 1e-5 of JAX's, or twice JAX's float32 gap to float64."""
    want, got, _, jcall, tcall = pnp_frames[frame]
    (jpose64, _), _ = _pose64((jcall, tcall))
    assert np.array_equal(got["P2"], want["P2"]) and np.array_equal(got["V2C"][:, :3], want["V2C"][:, :3])
    port_R, port_t = _gaps(_pose_of(got), jpose64)
    assert port_R <= 1e-5 and port_t <= 1e-5, (port_R, port_t)
    jax_R, jax_t = _gaps(_pose_of(want), jpose64)
    assert np.abs(got["R0"] - want["R0"]).max() <= max(1e-5, 2 * jax_R), jax_R
    assert np.abs(got["V2C"] - want["V2C"]).max() <= max(1e-5, 2 * jax_t), jax_t


@pytest.mark.parametrize("frame", FRAMES)
def test_pnp_calibration_on_the_port_sampler(pnp_frames, frame):
    want, _, own, jcall, tcall = pnp_frames[frame]
    valid = tcall[0][3]
    (jpose64, _), (own64, _) = _pose64((jcall, tcall), tpnp.draw_samples(valid, 128, 6, 2020 + frame))
    assert np.array_equal(own["P2"], want["P2"])
    own_R, own_t = _gaps(_pose_of(own), own64)
    assert own_R <= 1e-5 and own_t <= 1e-5, (own_R, own_t)
    if frame == 1:
        jax_R, jax_t = _gaps(_pose_of(want), jpose64)
        assert np.abs(own["R0"] - want["R0"]).max() <= max(1e-5, 2 * jax_R)
        assert np.abs(own["V2C"] - want["V2C"]).max() <= max(1e-5, 2 * jax_t)


@pytest.mark.parametrize("frame", FRAMES)
def test_port_sampler_finds_inliers_as_jax_keys_do(pnp_frames, frame):
    """Inlier counts of the simulation's estimator over the port's seeds
    0-15 against JAX's over keys 0-15 (each package's float32 call): a
    two-sided rank-sum test must not reject equal distributions at 1%."""
    from scipy.stats import mannwhitneyu

    (jargs, _), (targs, _) = pnp_frames[frame][3:]
    jn = [int(jpnp.ransac_pnp(*jargs[:4], jax.random.PRNGKey(k), reprojection_error=8.0)[2]) for k in range(16)]
    tn = [int(tpnp.ransac_pnp(*targs[:4], seed=k, reprojection_error=8.0, device="cpu")[2]) for k in range(16)]
    p = mannwhitneyu(tn, jn).pvalue
    assert p > 0.01, (p, sorted(tn), sorted(jn))


def test_unknown_method_raises_and_cuda_is_the_default(monkeypatch):
    with pytest.raises(ValueError, match="unknown SLAM method"):
        tcs.get_calibration_from_slam(path(0), slam_method="bogus", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcs.get_calibration_from_slam(path(0), slam_method="VISUAL_SLAM_SIM")
