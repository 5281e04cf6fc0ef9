"""`python -m sfa3d_tpu_torch.cli demo --platform cpu` against the JAX
package's `cli/demo.py` main, front only and `--two_sides`, on a two-frame
raw drive of the JAX writer (`write_mini_drive`) and one `.pth` from a JAX
KFPN init (centre-heatmap biases + 2.0, so peaks pass). The JAX runner's
frames are captured where it hands them to `cv2.VideoWriter.write`, its
detections where `detect_bev` returns them.

Tolerances: the drive fixture's scans byte for byte, its camera frames
the port's renderer's (equal to JAX's but within 2 px of a box hull's
edge, as `tests/test_torch_png.py` holds the renderer), `DemoKittiDataset`
and `moving_scene_sequence` exactly; per window, the detection masks equal
and the detections within 1e-3; the composites equal pixel for pixel
outside the frame-rate text (its value differs run to run); the port's
AVI holds the composites' JPEG bytes (`encode_jpeg`, cv2.imencode's) with
the frame count and size.
"""

import contextlib
import filecmp
import io
import os

import cv2
import jax
import numpy as np
import pytest
import torch

from tests.test_torch_png import EDGE_BAND, _hull_edge_distance

DET_TOL = 1e-3
HM_BUMP = 2.0
N_FRAMES = 2


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def write_weights(root) -> str:
    """A .pth of a JAX KFPN init with the centre-heatmap biases raised."""
    from sfa3d_tpu.models import create_model
    from sfa3d_tpu.models.port import export_kfpn_state_dict
    from sfa3d_tpu.pipeline import init_detector

    variables = jax.tree_util.tree_map(np.array, init_detector(create_model("fpn_resnet_18"), jax.random.PRNGKey(0)))
    for i in range(3):
        variables["params"][f"fpn{i}_hm_cen"]["conv2"]["bias"] += HM_BUMP
    pth = str(root / "kfpn.pth")
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in export_kfpn_state_dict(variables).items()}, pth)
    return pth


def run_jax_main(main, argv, patches=()):
    """Run a JAX CLI main with cv2.VideoWriter captured: (the frames handed
    to write, the printed text). `patches` are (module, name, wrapper
    factory) to record calls while the main runs."""
    frames = []

    class Capture:
        def __init__(self, *args, **kwargs):
            pass

        def write(self, img):
            frames.append(np.array(img))

        def release(self):
            pass

    saved = [(cv2, "VideoWriter", cv2.VideoWriter)] + [(m, n, getattr(m, n)) for m, n, _ in patches]
    cv2.VideoWriter = Capture
    for module, name, factory in patches:
        setattr(module, name, factory(getattr(module, name)))
    printed = io.StringIO()
    try:
        with contextlib.redirect_stdout(printed):
            main(argv)
    finally:
        for module, name, real in saved:
            setattr(module, name, real)
    return frames, printed.getvalue()


def recording(calls):
    def factory(real):
        def wrapper(*args, **kwargs):
            out = real(*args, **kwargs)
            calls.append(jax.tree_util.tree_map(np.asarray, out))
            return out
        return wrapper
    return factory


def fps_mask(shape):
    """The box of write_credit's frame-rate text, grown to the widest value."""
    from sfa3d_tpu_torch.viz import raster

    y = min(210, shape[0] - 20)
    oy = min(y + 40, shape[0] - 5)
    (w, h), base = raster.get_text_size("Speed: 99999.9 FPS", raster.FONT_HERSHEY_SIMPLEX, 1.0, 2)
    mask = np.zeros(shape[:2], bool)
    mask[max(oy - h - 2, 0):oy + base + 2, 8:12 + w] = True
    return mask


def assert_avi_holds(path, composites):
    from sfa3d_tpu_torch.data.avi import read_avi_frames, read_avi_info
    from sfa3d_tpu_torch.data.jpeg import decode_jpeg, encode_jpeg

    stored = read_avi_frames(path)
    h, w = composites[0].shape[:2]
    assert read_avi_info(path) == {"width": w, "height": h, "fps": 30.0, "compression": "MJPG",
                                   "frames": len(composites)}
    for data, img in zip(stored, composites):
        assert data == encode_jpeg(img)
        assert data == cv2.imencode(".jpg", img)[1].tobytes()
    np.testing.assert_array_equal(decode_jpeg(stored[0]), cv2.imdecode(np.frombuffer(stored[0], np.uint8), 1))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from sfa3d_tpu.data.synthetic import write_mini_drive

    root = tmp_path_factory.mktemp("cli_demo")
    drive = write_mini_drive(str(root / "drive"), n_frames=N_FRAMES, seed=0)
    return drive, write_weights(root), root


@pytest.fixture(scope="module")
def runs(setup):
    """Per configuration: JAX frames, JAX detect_bev outputs, the JAX and
    port printed lines, the port's records and output dir."""
    import sfa3d_tpu.pipeline as jpipeline
    from sfa3d_tpu.cli import demo as jdemo
    from sfa3d_tpu_torch.cli import demo as tdemo

    drive, pth, root = setup
    results = {}
    for name, flags in (("front", []), ("two_sides", ["--two_sides"])):
        argv = ["--drive_dir", drive, "--pretrained_path", pth] + flags
        calls = []
        frames, printed = run_jax_main(jdemo.main, argv + ["--output_dir", str(root / f"jax_{name}")],
                                       [(jpipeline, "detect_bev", recording(calls))])
        tout = str(root / f"port_{name}")
        port_printed = io.StringIO()
        with contextlib.redirect_stdout(port_printed):
            records = tdemo.main(argv + ["--output_dir", tout, "--platform", "cpu"])
        results[name] = {"frames": frames, "calls": calls, "printed": printed, "port_printed": port_printed.getvalue(),
                         "records": records, "out": tout}
    return results


def test_drive_fixture_and_datasets_equal_jax(tmp_path):
    from sfa3d_tpu.data import kitti as jkitti
    from sfa3d_tpu.data import synthetic as jsynthetic
    from sfa3d_tpu_torch.data import kitti as tkitti
    from sfa3d_tpu_torch.data import synthetic as tsynthetic
    from sfa3d_tpu_torch.data.png import read_png_rgb

    for a, b in zip(jsynthetic.moving_scene_sequence(3, seed=4), tsynthetic.moving_scene_sequence(3, seed=4)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    ref = jsynthetic.write_mini_drive(str(tmp_path / "jax"), n_frames=3, seed=1, motion=True)
    port = tsynthetic.write_mini_drive(str(tmp_path / "port"), n_frames=3, seed=1, motion=True)
    lidar = os.path.join("velodyne_points", "data")
    names = sorted(os.listdir(os.path.join(ref, lidar)))
    assert names == sorted(os.listdir(os.path.join(port, lidar))) and len(names) == 3
    assert filecmp.cmpfiles(os.path.join(ref, lidar), os.path.join(port, lidar), names, shallow=False)[0] == names
    frames = tsynthetic.moving_scene_sequence(3, seed=1)
    P2 = np.asarray(tsynthetic.cnf.P2[:3], np.float64).reshape(3, 4)
    for i, (front, labels, _) in enumerate(frames):
        name = os.path.join("image_02", "data", f"{i:010d}.png")
        got = read_png_rgb(os.path.join(port, name))
        np.testing.assert_array_equal(got, tsynthetic.render_camera_image(front, labels, P2))
        # against the JAX writer's frame: equal but within the hull band
        differ = (got != read_png_rgb(os.path.join(ref, name))).any(-1)
        assert differ.sum() < 0.01 * differ.size
        assert _hull_edge_distance(labels, P2, got.shape[:2])[differ].max() <= EDGE_BAND
    jds, tds = jkitti.DemoKittiDataset(ref), tkitti.DemoKittiDataset(port)
    assert len(jds) == len(tds) == 3
    for i in range(3):
        (jp, jv, jpath), (tp, tv, tpath) = jds[i], tds[i]
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(tv, jv)
        assert os.path.relpath(tpath, port) == os.path.relpath(jpath, ref)
        assert 0 < tv.sum() < len(tv) and (tp[tv][:, 0] < 0).any() and (tp[tv][:, 0] > 0).any()


@pytest.mark.parametrize("name", ["front", "two_sides"])
def test_detections_equal_jax(runs, name):
    run = runs[name]
    windows = 2 if name == "two_sides" else 1
    assert len(run["calls"]) == windows * N_FRAMES
    for i, rec in enumerate(run["records"]):
        assert len(rec["mask"]) == windows
        for w in range(windows):
            dets, _, real, mask = run["calls"][i * windows + w]
            np.testing.assert_array_equal(rec["mask"][w], mask[0])
            np.testing.assert_allclose(rec["detections"][w], dets[0], rtol=0, atol=DET_TOL)
            np.testing.assert_allclose(rec["boxes_real"][w][mask[0]], real[0][mask[0]], rtol=0, atol=DET_TOL)
            assert mask[0].sum() > 0


@pytest.mark.parametrize("name", ["front", "two_sides"])
def test_composites_equal_jax_outside_the_frame_rate(runs, name):
    run = runs[name]
    assert len(run["frames"]) == len(run["records"]) == N_FRAMES
    for want, rec in zip(run["frames"], run["records"]):
        got = rec["composite"]
        assert got.shape == want.shape == ((183 + 2 * 608) if name == "two_sides" else (183 + 608), 608, 3)
        differ = (got != want).any(2)
        assert not (differ & ~fps_mask(got.shape)).any()
    lines = [line.split(":")[0] for line in run["port_printed"].splitlines() if line.endswith(" FPS")]
    assert lines == [line.split(":")[0] for line in run["printed"].splitlines() if line.endswith(" FPS")]
    assert len(lines) == N_FRAMES


@pytest.mark.parametrize("name", ["front", "two_sides"])
def test_avi_holds_the_composites(runs, name):
    run = runs[name]
    assert os.listdir(run["out"]) == ["demo_fpn_resnet_18.avi"]
    assert_avi_holds(os.path.join(run["out"], "demo_fpn_resnet_18.avi"), [r["composite"] for r in run["records"]])


def test_demo_runs_on_cuda_unless_asked(setup, tmp_path, monkeypatch):
    from sfa3d_tpu_torch.cli import demo as tdemo

    drive, pth, _ = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdemo.main(["--drive_dir", drive, "--output_dir", str(tmp_path)])
    assert not os.listdir(tmp_path)
