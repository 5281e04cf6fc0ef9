"""`python -m sfa3d_tpu_torch.cli slam --platform cpu` against the JAX
package's `cli/slam.py` main in each `--calib_method`, and in
VISUAL_SLAM_SIM with `--use_pnp`, on one setup: a two-frame mini-KITTI of
the JAX writer, the `.pth` and
`.pt` of `tests/test_torch_cli_fuse.py` (JAX inits, biases raised), and
`--imgsz 64 --confidence_threshold 0.0 --peak_thresh 0.0`, on the test
split's one frame, 000001 (frame 0 has no drift). The JAX
runner's images are captured where it hands them to `cv2.imwrite`, the
port's where it hands them to `data/png.py::write_image_bgr` (each file
the JPEG bytes of its array, cv2.imencode's); each runner's calibration is
recorded where it asks its `get_calibration_from_slam`.

Tolerances: the drift sources' calibrations equal, and their images equal
pixel for pixel. With `--use_pnp` the port draws JAX's minimal sets (drawn
as `pnp.py` draws them, from the same seed); the port solves the PnP in
float64, JAX in float32, so the calibrations differ by JAX's own float32
error, 6.4e-5 at frame 1 (held within 1e-4 here; every frame's bound is in
tests/test_torch_calib_sources.py); the images must lie within the 2-px
band of `tests/test_torch_viz_raster.py::band` around the strokes of both
runners, the count of differing pixels printed (measured 6 of 29,598
drawn). The printed lines and
fused counts are equal. A last run of the port alone, `--use_pnp` on its
own sampler, must give a finite calibration and the image (at frame 1 all
45 points are inliers either way, and the image differs from JAX's in 6
pixels, as on JAX's draws).
"""

import contextlib
import io
import os

import cv2
import numpy as np
import pytest
import torch

from tests.test_torch_cli_fuse import port_images, write_weights
from tests.test_torch_viz_raster import band

CONFIGS = {
    "KITTI_DATASET_CALIB": ["--calib_method", "KITTI_DATASET_CALIB", "--mode", "nms"],
    "VISUAL_SLAM_SIM": ["--calib_method", "VISUAL_SLAM_SIM", "--mode", "weighted"],
    "LIDAR_SLAM_SIM": ["--calib_method", "LIDAR_SLAM_SIM"],
    "VISUAL_INERTIAL_SLAM_SIM": ["--calib_method", "VISUAL_INERTIAL_SLAM_SIM"],
    "VISUAL_SLAM_SIM-pnp": ["--calib_method", "VISUAL_SLAM_SIM", "--use_pnp"],
}
OWN_SAMPLER = "VISUAL_SLAM_SIM-pnp-own-sampler"


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from sfa3d_tpu.data.synthetic import write_mini_kitti

    root = tmp_path_factory.mktemp("cli_slam")
    kitti = write_mini_kitti(str(root / "kitti"), n_frames=2, splits={"test": [1]})
    pth, pt = write_weights(root)
    return kitti, pth, pt, root


def jax_draws(valid, iterations, sample_size, seed):
    """pnp.py's minimal sets for PRNGKey(seed), drawn as pnp.py draws them."""
    import jax
    import jax.numpy as jnp

    valid = np.asarray(valid.cpu(), bool)
    probs = valid.astype(jnp.float32)
    probs = probs / jnp.maximum(probs.sum(), 1.0)
    return torch.as_tensor(np.asarray(jax.vmap(
        lambda k: jax.random.choice(k, valid.shape[0], shape=(sample_size,), replace=False, p=probs)
    )(jax.random.split(jax.random.PRNGKey(seed), iterations))))


def _recording(module, calls):
    real = module.get_calibration_from_slam

    def get_calibration_from_slam(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append(out)
        return out

    return real, get_calibration_from_slam


@pytest.fixture(scope="module")
def runs(setup):
    import sfa3d_tpu.slam as jslam
    import sfa3d_tpu_torch.slam.calib_sources as tcs
    import sfa3d_tpu_torch.slam.pnp as tpnp
    from sfa3d_tpu.cli import slam as jcli
    from sfa3d_tpu_torch.cli import slam as tcli

    kitti, pth, pt, root = setup
    base = ["--dataset_dir", kitti, "--pretrained_path", pth, "--yolo_weights", pt, "--imgsz", "64",
            "--confidence_threshold", "0.0", "--peak_thresh", "0.0"]
    results = {}
    for name, flags in CONFIGS.items():
        jout, tout = str(root / f"jax_{name}"), str(root / f"port_{name}")
        jcalib, tcalib, jimages = [], [], {}
        real_imwrite = cv2.imwrite
        jreal, jrec = _recording(jslam, jcalib)
        treal, trec = _recording(tcs, tcalib)
        cv2.imwrite = lambda path, img: jimages.__setitem__(os.path.basename(path), np.array(img)) or True
        jslam.get_calibration_from_slam, tcs.get_calibration_from_slam = jrec, trec
        jtext, ttext = io.StringIO(), io.StringIO()
        real_draws = tpnp.draw_samples
        tpnp.draw_samples = jax_draws
        try:
            with port_images(tout) as timages:
                with contextlib.redirect_stdout(jtext):
                    jcli.main(base + flags + ["--output_dir", jout])
                with contextlib.redirect_stdout(ttext):
                    records = tcli.main(base + flags + ["--output_dir", tout, "--platform", "cpu"])
        finally:
            cv2.imwrite = real_imwrite
            jslam.get_calibration_from_slam, tcs.get_calibration_from_slam = jreal, treal
            tpnp.draw_samples = real_draws
        results[name] = {"jax_calib": jcalib, "port_calib": tcalib, "jax_images": jimages,
                         "port_images": timages, "jax_text": jtext.getvalue(), "port_text": ttext.getvalue(),
                         "records": records}
    # the port alone, on its own sampler
    tout = str(root / f"port_{OWN_SAMPLER}")
    with contextlib.redirect_stdout(io.StringIO()), port_images(tout) as timages:
        records = tcli.main(base + CONFIGS["VISUAL_SLAM_SIM-pnp"] + ["--output_dir", tout, "--platform", "cpu"])
    results[OWN_SAMPLER] = {"port_images": timages, "records": records}
    return results


@pytest.mark.parametrize("config", list(CONFIGS))
def test_calibrations_match(runs, config):
    r = runs[config]
    assert len(r["jax_calib"]) == len(r["port_calib"]) == 1
    (want,), (got,) = r["jax_calib"], r["port_calib"]
    for key in ("P2", "R0", "V2C"):
        if config.endswith("-pnp"):
            np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-4)
        else:
            assert np.array_equal(got[key], want[key]), key
    if config != "KITTI_DATASET_CALIB":  # frame 1 has drifted from the base set
        from sfa3d_tpu_torch.slam.calib_sources import R0_BASE, V2C_BASE

        assert not (np.array_equal(got["R0"], R0_BASE) and np.array_equal(got["V2C"], V2C_BASE))


@pytest.mark.parametrize("config", list(CONFIGS))
def test_printed_lines_and_counts_equal(runs, config):
    r = runs[config]
    assert r["port_text"] == r["jax_text"]
    assert r["port_text"].count(f"[{CONFIGS[config][1]}]") == 1
    assert [rec["fused"] for rec in r["records"]] == [int(line.split(": ")[1].split()[0])
                                                      for line in r["jax_text"].splitlines()]
    assert sum(rec["fused"] for rec in r["records"]) > 0


@pytest.mark.parametrize("config", list(CONFIGS))
def test_images_equal_jax(setup, runs, config):
    r = runs[config]
    assert sorted(r["port_images"]) == sorted(r["jax_images"]) == ["000001_slam.jpg"]
    for name, a in r["jax_images"].items():
        b = r["port_images"][name]
        assert a.shape == b.shape, name
        if config.endswith("-pnp"):
            frame = cv2.imread(os.path.join(setup[0], "testing", "image_2", name.replace("_slam.jpg", ".png")))
            outside, differing, ink = band(frame, a, b)
            print(f"{config} {name}: {differing} differing pixels of {ink} drawn")
            assert outside == 0, (name, outside, differing)
        else:
            assert np.array_equal(a, b), name


def test_own_sampler_run(runs):
    """On its own sampler: a finite, near-orthonormal calibration and the
    image, its difference from JAX's printed; and the stage times."""
    r, jax_run = runs[OWN_SAMPLER], runs["VISUAL_SLAM_SIM-pnp"]
    assert sorted(r["port_images"]) == ["000001_slam.jpg"]
    for rec in r["records"]:
        calib = rec["calib"]
        assert all(np.isfinite(calib[k]).all() for k in ("P2", "R0", "V2C"))
        np.testing.assert_allclose(calib["R0"] @ calib["R0"].T, np.eye(3), atol=2e-3)
        for key in ("detect_ms", "calib_ms", "fuse_ms", "draw_ms", "write_ms"):
            assert rec[key] >= 0.0
    for name, a in jax_run["jax_images"].items():
        print(f"{OWN_SAMPLER} {name}: {int((a != r['port_images'][name]).any(2).sum())} pixels differ from JAX's")


def test_dispatcher_lists_slam_and_stereo_calib():
    from sfa3d_tpu.cli.__main__ import COMMANDS as JAX_COMMANDS
    from sfa3d_tpu_torch.cli.__main__ import COMMANDS

    assert set(JAX_COMMANDS) <= set(COMMANDS)
    assert COMMANDS["slam"][0] == "sfa3d_tpu_torch.cli.slam"
    assert COMMANDS["stereo-calib"][0] == "sfa3d_tpu_torch.cli.stereo_calib"


def test_slam_runs_on_cuda_unless_asked(setup, tmp_path, monkeypatch):
    from sfa3d_tpu_torch.cli import slam as tcli

    kitti, pth, _, _ = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.main(["--dataset_dir", kitti, "--pretrained_path", pth, "--output_dir", str(tmp_path / "out")])
    assert not os.listdir(tmp_path / "out")
