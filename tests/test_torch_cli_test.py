"""`python -m sfa3d_tpu_torch.cli test --platform cpu` against the JAX
package's `cli/test.py` main on one setup: a one-frame mini-KITTI of the JAX
writer and one `.pth` from a JAX KFPN init (centre-heatmap biases + 2.0, so
peaks pass), `--save_test_output --peak_thresh 0.0`, then `--output_format
video --enable_kfpn_viz`. The JAX runner's images are captured as arrays
where it hands them to `cv2.imwrite` (and `cv2.VideoWriter.write`); the
port's where it hands them to `data/png.py::write_image_bgr`, and its files
are read back.

Tolerances: the same file names and per-frame detection count; each port
file the JPEG bytes of the array handed to its writer (cv2.imencode's);
the raw BEV dump's bytes equal the JPEG of JAX's array; each heatmap's JET
image exact where the two uint8 levels agree, and its levels within 1
everywhere (heads within 1e-3 can round to neighbouring levels); the
composite within the 2-px band of the drawn strokes of both runners (box
corners from detections within 1e-3 can truncate to the next pixel), with
the share of differing pixels printed; in video mode the AVI's frames the
composites' JPEGs and the KFPN dumps' file names JAX's.
"""

import contextlib
import io
import os

import cv2
import jax
import numpy as np
import pytest
import torch

from tests.test_torch_cli_fuse import port_images
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
    detection counts, port output dir, port records, port images by
    relative path)."""
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
    with port_images(tout) as images:
        records = ttest.main(argv + ["--output_dir", tout, "--platform", "cpu"])
    return captured, counts, tout, records, images


def _port_files(out):
    files = {}
    for dirpath, _, names in os.walk(out):
        for n in names:
            path = os.path.join(dirpath, n)
            with open(path, "rb") as f:
                files[os.path.relpath(path, out)] = f.read()
    return files


def test_same_files_and_detection_counts(runs):
    captured, counts, tout, records, images = runs
    files = _port_files(tout)
    assert sorted(files) == sorted(captured) == sorted(images)
    assert len(files) == 8  # composite, raw BEV, 2 x 3 heatmaps
    assert [r["n_dets"] for r in records] == counts and counts[0] > 0


def test_files_are_the_jpegs_of_the_drawn_images(runs):
    """`port_images` checked each file against the JPEG of its array when
    the run ended; here every file was written through it."""
    _, _, tout, _, images = runs
    files = _port_files(tout)
    assert sorted(files) == sorted(images)
    assert all(data[:2] == b"\xff\xd8" for data in files.values())


def test_raw_bev_dump_equals_jax(runs):
    captured, _, tout, _, images = runs
    key = os.path.join("visualizations", "000000_raw_bev.jpg")
    np.testing.assert_array_equal(images[key], captured[key])
    assert _port_files(tout)[key] == cv2.imencode(".jpg", captured[key])[1].tobytes()


@pytest.mark.parametrize("tag", ["raw", "sigmoid"])
@pytest.mark.parametrize("cls", [0, 1, 2])
def test_heatmaps_equal_jax_where_levels_agree(runs, tag, cls):
    from sfa3d_tpu_torch.viz.raster import JET_BGR

    captured, _, _, _, images = runs
    key = os.path.join("visualizations", f"000000_{tag}_heatmap_cls{cls}.jpg")
    a, b = captured[key], images[key]
    lut = {tuple(c): i for i, c in enumerate(JET_BGR.tolist())}
    la = np.vectorize(lambda *c: lut[c])(a[..., 0], a[..., 1], a[..., 2])
    lb = np.vectorize(lambda *c: lut[c])(b[..., 0], b[..., 1], b[..., 2])
    assert np.abs(la - lb).max() <= 1
    same = la == lb
    assert np.array_equal(a[same], b[same])
    print(f"{tag} heatmap cls{cls}: {int((~same).sum())} of {same.size} levels one apart")


def _composite_base(setup, raw):
    from sfa3d_tpu_torch.cli.test import read_frame_bgr
    from sfa3d_tpu_torch.viz import raster
    from sfa3d_tpu_torch.viz.draw import merge_rgb_to_bev

    frame = read_frame_bgr(os.path.join(setup[0], "testing", "image_2", "000000.png"))
    return merge_rgb_to_bev(frame, raster.rotate_180(raw), 608)


def test_composite_within_the_band(runs, setup):
    """Against the composite with nothing drawn (the camera frame over the
    raw BEV turned 180 degrees), every pixel where the two runners differ
    lies within 2 px of a pixel that each runner's drawing changed, with
    values inside the other runner's range within 2 px (`band`)."""
    captured, _, _, _, images = runs
    a, b = captured["000000.jpg"], images["000000.jpg"]
    assert a.shape == b.shape == (183 + 608, 608, 3)
    base = _composite_base(setup, images[os.path.join("visualizations", "000000_raw_bev.jpg")])
    outside, differ, inked = band(base, a, b)
    assert outside == 0 and inked > 0
    print(f"composite: {differ} of {inked} drawn pixels differ ({differ / inked:.3f})")


def test_video_and_kfpn_dumps_match_jax(runs, setup, tmp_path, monkeypatch):
    """`--output_format video --enable_kfpn_viz`: the AVI holds one frame
    a sample, each the JPEG of the composite (the composite within the band
    of JAX's video frame), and the KFPN dumps carry JAX's file names (JAX's
    figures laid out but not rendered)."""
    import matplotlib
    from matplotlib.figure import Figure

    from sfa3d_tpu.cli import test as jtest
    from sfa3d_tpu_torch.cli import test as ttest
    from sfa3d_tpu_torch.data.avi import read_avi_frames, read_avi_info
    from tests.test_torch_cli_demo import run_jax_main

    kitti, pth, _ = setup
    matplotlib.use("Agg")
    monkeypatch.setattr(Figure, "savefig", lambda self, path, **kw: open(path, "wb").close())
    monkeypatch.setattr(Figure, "tight_layout", lambda self, **kw: None)
    argv = ["--dataset_dir", kitti, "--pretrained_path", pth, "--peak_thresh", "0.0", "--output_format", "video",
            "--enable_kfpn_viz"]
    jout, tout = tmp_path / "jax", tmp_path / "port"
    frames, _ = run_jax_main(jtest.main, argv + ["--output_dir", str(jout)])
    records = ttest.main(argv + ["--output_dir", str(tout), "--platform", "cpu"])
    assert sorted(os.listdir(tout)) == ["fpn_resnet_18.avi", "kfpn_viz_000000"]
    assert sorted(os.listdir(jout / "kfpn_viz_000000")) == sorted(os.listdir(tout / "kfpn_viz_000000"))
    assert len(os.listdir(tout / "kfpn_viz_000000")) == 25
    stored = read_avi_frames(str(tout / "fpn_resnet_18.avi"))
    assert len(stored) == len(frames) == len(records) == 1
    assert read_avi_info(str(tout / "fpn_resnet_18.avi"))["width"] == 608
    composite = records[0]["composite"]
    assert stored[0] == cv2.imencode(".jpg", composite)[1].tobytes()
    _, _, _, _, images = runs
    np.testing.assert_array_equal(composite, images["000000.jpg"])  # the image mode's composite
    base = _composite_base(setup, images[os.path.join("visualizations", "000000_raw_bev.jpg")])
    assert band(base, frames[0], composite)[0] == 0


def test_unported_options_exit_with_a_message(setup, tmp_path):
    from sfa3d_tpu_torch.cli import test as ttest

    kitti, pth, _ = setup
    base = ["--dataset_dir", kitti, "--output_dir", str(tmp_path), "--platform", "cpu"]
    with pytest.raises(SystemExit, match="display"):
        ttest.main(base + ["--show"])
    assert not os.listdir(tmp_path)


def test_runs_on_cuda_unless_asked(setup, tmp_path, monkeypatch):
    from sfa3d_tpu_torch.cli import fuse as tfuse
    from sfa3d_tpu_torch.cli import test as ttest

    kitti, pth, _ = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (ttest.main, tfuse.main):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["--dataset_dir", kitti, "--output_dir", str(tmp_path)])
