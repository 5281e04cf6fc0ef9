"""`python -m sfa3d_tpu_torch.cli test --platform cpu` against the JAX
package's `cli/test.py` main on one setup: a one-frame mini-KITTI of the JAX
writer and one `.pth` from a JAX KFPN init (centre-heatmap biases + 2.0, so
peaks pass), `--save_test_output --peak_thresh 0.0`. The JAX runner's images
are captured as arrays where it hands them to `cv2.imwrite` (its files are
lossy JPEG); the port's are read back from its PNG files.

Tolerances: the same file names (`.png` for `.jpg`) and per-frame detection
count; the raw BEV dump exact; each heatmap's JET image exact where the two
uint8 levels agree, and its levels within 1 everywhere (heads within 1e-3
can round to neighbouring levels); the composite within the 2-px band of
the drawn strokes of both runners (box corners from detections within 1e-3
can truncate to the next pixel), with the share of differing pixels
printed.
"""

import contextlib
import io
import os

import cv2
import jax
import numpy as np
import pytest
import torch

from sfa3d_tpu_torch.data.png import read_png_rgb

from tests.test_torch_viz_raster import band

HM_BUMP = 2.0


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from sfa3d_tpu.data.synthetic import write_mini_kitti
    from sfa3d_tpu.models import create_model
    from sfa3d_tpu.models.port import export_kfpn_state_dict
    from sfa3d_tpu.pipeline import init_detector

    root = tmp_path_factory.mktemp("cli_test")
    kitti = write_mini_kitti(str(root / "kitti"), n_frames=1)
    variables = jax.tree_util.tree_map(np.array, init_detector(create_model("fpn_resnet_18"), jax.random.PRNGKey(0)))
    for i in range(3):
        variables["params"][f"fpn{i}_hm_cen"]["conv2"]["bias"] += HM_BUMP
    pth = str(root / "kfpn.pth")
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in export_kfpn_state_dict(variables).items()}, pth)
    return kitti, pth, root


@pytest.fixture(scope="module")
def runs(setup):
    """Both runners on the same frame: (JAX images by relative path, JAX
    detection counts, port output dir, port records)."""
    from sfa3d_tpu.cli import test as jtest
    from sfa3d_tpu_torch.cli import test as ttest

    kitti, pth, root = setup
    jout, tout = str(root / "jax_out"), str(root / "port_out")
    captured = {}
    real_imwrite = cv2.imwrite

    def capture(path, img):
        captured[os.path.relpath(path, jout)] = np.array(img)
        return True

    argv = ["--dataset_dir", kitti, "--pretrained_path", pth, "--save_test_output", "--peak_thresh", "0.0"]
    cv2.imwrite = capture
    printed = io.StringIO()
    try:
        with contextlib.redirect_stdout(printed):
            jtest.main(argv + ["--output_dir", jout])
    finally:
        cv2.imwrite = real_imwrite
    counts = [int(line.split(": ")[1].split(" dets")[0]) for line in printed.getvalue().splitlines()
              if line.startswith("frame ") and " dets," in line]
    records = ttest.main(argv + ["--output_dir", tout, "--platform", "cpu"])
    return captured, counts, tout, records


def _port_files(out):
    files = {}
    for dirpath, _, names in os.walk(out):
        for n in names:
            path = os.path.join(dirpath, n)
            files[os.path.relpath(path, out)] = read_png_rgb(path)[:, :, ::-1]
    return files


def test_same_files_and_detection_counts(runs):
    captured, counts, tout, records = runs
    files = _port_files(tout)
    assert sorted(files) == sorted(k.replace(".jpg", ".png") for k in captured)
    assert len(files) == 8  # composite, raw BEV, 2 x 3 heatmaps
    assert [r["n_dets"] for r in records] == counts and counts[0] > 0


def test_raw_bev_dump_equals_jax(runs):
    captured, _, tout, _ = runs
    files = _port_files(tout)
    key = os.path.join("visualizations", "000000_raw_bev.jpg")
    assert np.array_equal(files[key.replace(".jpg", ".png")], captured[key])


@pytest.mark.parametrize("tag", ["raw", "sigmoid"])
@pytest.mark.parametrize("cls", [0, 1, 2])
def test_heatmaps_equal_jax_where_levels_agree(runs, tag, cls):
    from sfa3d_tpu_torch.viz.raster import JET_BGR

    captured, _, tout, _ = runs
    files = _port_files(tout)
    key = os.path.join("visualizations", f"000000_{tag}_heatmap_cls{cls}.jpg")
    a, b = captured[key], files[key.replace(".jpg", ".png")]
    lut = {tuple(c): i for i, c in enumerate(JET_BGR.tolist())}
    la = np.vectorize(lambda *c: lut[c])(a[..., 0], a[..., 1], a[..., 2])
    lb = np.vectorize(lambda *c: lut[c])(b[..., 0], b[..., 1], b[..., 2])
    assert np.abs(la - lb).max() <= 1
    same = la == lb
    assert np.array_equal(a[same], b[same])
    print(f"{tag} heatmap cls{cls}: {int((~same).sum())} of {same.size} levels one apart")


def test_composite_within_the_band(runs, setup):
    """Against the composite with nothing drawn (the camera frame over the
    raw BEV turned 180 degrees), every pixel where the two runners differ
    lies within 2 px of a pixel that each runner's drawing changed, with
    values inside the other runner's range within 2 px (`band`)."""
    from sfa3d_tpu_torch.cli.test import read_frame_bgr
    from sfa3d_tpu_torch.viz import raster
    from sfa3d_tpu_torch.viz.draw import merge_rgb_to_bev

    captured, _, tout, _ = runs
    files = _port_files(tout)
    a, b = captured["000000.jpg"], files["000000.png"]
    assert a.shape == b.shape == (183 + 608, 608, 3)
    frame = read_frame_bgr(os.path.join(setup[0], "testing", "image_2", "000000.png"))
    raw = files[os.path.join("visualizations", "000000_raw_bev.png")]
    base = merge_rgb_to_bev(frame, raster.rotate_180(raw), 608)
    outside, differ, inked = band(base, a, b)
    assert outside == 0 and inked > 0
    print(f"composite: {differ} of {inked} drawn pixels differ ({differ / inked:.3f})")


def test_unported_options_exit_with_a_message(setup, tmp_path):
    from sfa3d_tpu_torch.cli import test as ttest

    kitti, pth, _ = setup
    base = ["--dataset_dir", kitti, "--output_dir", str(tmp_path), "--platform", "cpu"]
    for flag, words in ((["--output_format", "video"], "AVI"), (["--enable_kfpn_viz"], "KFPN feature"),
                        (["--show"], "display")):
        with pytest.raises(SystemExit, match=words):
            ttest.main(base + flag)
    assert not os.listdir(tmp_path)


def test_runs_on_cuda_unless_asked(setup, tmp_path, monkeypatch):
    from sfa3d_tpu_torch.cli import fuse as tfuse
    from sfa3d_tpu_torch.cli import test as ttest

    kitti, pth, _ = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (ttest.main, tfuse.main):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["--dataset_dir", kitti, "--output_dir", str(tmp_path)])
