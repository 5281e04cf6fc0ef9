"""`python -m sfa3d_tpu_torch.cli stereo-calib --platform cpu --run_yolo`
against the JAX package's `cli/stereo_calib.py` main on a one-pair
mini-KITTI of the JAX writer (a true 0.54 m baseline along x), with the
`.pt` of `tests/test_torch_cli_fuse.py` and `--imgsz 64`. The JAX runner's
images are captured where it hands them to `cv2.imwrite`, the port's where
it hands them to `data/png.py::write_image_bgr`.

Checked: the summary line `calibrated 1/1 pairs successfully` of both; the
`{id}_estimated_calib.txt` base lines (every line but the appended
comments) byte for byte; the `{id}_yolo.jpg` image pixel for pixel. Run
once on the port's own sampler (the estimated R within 3 degrees of
identity and t along x, as tests/test_slam.py asks of JAX's) and once on
JAX's minimal sets (drawn as `epipolar.py` draws them from key 0): then
the per-pair line equals JAX's (1814 matches, 931 inliers, cheirality
0.99) and the appended R and t lie within 0.5 and 1 degree of JAX's.
"""

import contextlib
import io
import os

import cv2
import numpy as np
import pytest
import torch

from tests.test_torch_cli_fuse import port_images, write_weights


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_draws(valid, iterations, sample_size, seed):
    import jax
    import jax.numpy as jnp

    valid = np.asarray(valid.cpu(), bool)
    probs = valid.astype(jnp.float32)
    probs = probs / jnp.maximum(probs.sum(), 1.0)
    return torch.as_tensor(np.asarray(jax.vmap(
        lambda k: jax.random.choice(k, valid.shape[0], shape=(sample_size,), replace=False, p=probs)
    )(jax.random.split(jax.random.PRNGKey(seed), iterations))))


def read_comment(text, key):
    for line in text.splitlines():
        if line.startswith(f"# {key}:"):
            return np.array([float(v) for v in line.split(":", 1)[1].split()])
    raise AssertionError(f"no {key} in the file")


def base_lines(text):
    return [line for line in text.splitlines(keepends=True) if not line.startswith("#")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import sfa3d_tpu_torch.slam.epipolar as tepi
    from sfa3d_tpu.cli import stereo_calib as jcli
    from sfa3d_tpu.data.synthetic import write_mini_kitti
    from sfa3d_tpu_torch.cli import stereo_calib as tcli

    root = tmp_path_factory.mktemp("cli_stereo")
    kitti = write_mini_kitti(str(root / "kitti"), n_frames=1)
    _, pt = write_weights(root)
    base = ["--dataset_dir", kitti, "--run_yolo", "--yolo_weights", pt, "--imgsz", "64"]
    out = {"dir": root}
    jimages, real_imwrite = {}, cv2.imwrite
    cv2.imwrite = lambda path, img: jimages.__setitem__(os.path.basename(path), np.array(img)) or True
    text = io.StringIO()
    try:
        with contextlib.redirect_stdout(text):
            jcli.main(base + ["--output_dir", str(root / "jax")])
    finally:
        cv2.imwrite = real_imwrite
    out["jax"] = {"text": text.getvalue(), "images": jimages,
                  "calib": (root / "jax" / "000000_estimated_calib.txt").read_text()}
    for name in ("own", "jax-draws"):
        real_draws = tepi.draw_samples
        if name == "jax-draws":
            tepi.draw_samples = jax_draws
        text = io.StringIO()
        try:
            with contextlib.redirect_stdout(text), port_images(str(root / name)) as timages:
                records = tcli.main(base + ["--output_dir", str(root / name), "--platform", "cpu"])
        finally:
            tepi.draw_samples = real_draws
        out[name] = {"text": text.getvalue(), "images": timages, "records": records,
                     "calib": (root / name / "000000_estimated_calib.txt").read_text()}
    return out


@pytest.mark.parametrize("run", ["own", "jax-draws"])
def test_summary_and_base_lines_equal_jax(runs, run):
    got, want = runs[run], runs["jax"]
    assert got["text"].splitlines()[-1] == want["text"].splitlines()[-1] == "calibrated 1/1 pairs successfully"
    assert base_lines(got["calib"]) == base_lines(want["calib"])
    assert len(base_lines(got["calib"])) == 7
    assert got["text"].splitlines()[0].startswith("000000: 1814 matches, ")


@pytest.mark.parametrize("run", ["own", "jax-draws"])
def test_yolo_image_equals_jax(runs, run):
    got, want = runs[run]["images"], runs["jax"]["images"]
    assert sorted(got) == sorted(want) == ["000000_yolo.jpg"]
    assert np.array_equal(got["000000_yolo.jpg"], want["000000_yolo.jpg"])


def test_own_sampler_estimate_meets_the_ground_truth_bounds(runs):
    R = read_comment(runs["own"]["calib"], "R_stereo_estimated").reshape(3, 3)
    t = read_comment(runs["own"]["calib"], "t_stereo_estimated")
    angle = np.degrees(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1)))
    assert angle < 3.0 and abs(t[0]) / np.linalg.norm(t) > 0.98
    result = runs["own"]["records"][0]["result"]
    assert result.success and result.n_inliers >= 100
    assert {"match", "f_ransac", "recover_pose", "orb_left_level0", "orb_right_describe"} <= set(
        runs["own"]["records"][0]["timings"])


def test_jax_draws_estimate_agrees_with_jax(runs):
    got, want = runs["jax-draws"], runs["jax"]
    assert got["text"] == want["text"]
    Rg, Rw = (read_comment(r["calib"], "R_stereo_estimated").reshape(3, 3) for r in (got, want))
    tg, tw = (read_comment(r["calib"], "t_stereo_estimated") for r in (got, want))
    assert np.degrees(np.arccos(np.clip((np.trace(Rg @ Rw.T) - 1) / 2, -1, 1))) < 0.5
    assert np.degrees(np.arccos(min(1.0, abs(tg @ tw) / np.linalg.norm(tg) / np.linalg.norm(tw)))) < 1.0


def test_stereo_calib_runs_on_cuda_unless_asked(runs, tmp_path, monkeypatch):
    from sfa3d_tpu_torch.cli import stereo_calib as tcli

    kitti = str(runs["dir"] / "kitti")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.main(["--dataset_dir", kitti, "--output_dir", str(tmp_path / "out")])
    assert not os.listdir(tmp_path / "out")
