"""`python -m sfa3d_tpu_torch.cli track --platform cpu` against the JAX
package's `cli/track.py` main on a three-frame moving drive of the JAX
writer (`write_mini_drive(motion=True)`) and one `.pth` from a JAX KFPN
init (centre-heatmap biases + 2.0), at the defaults and with `--min_hits 1
--show_coasting` (every live track drawn with its label and arrow). The
JAX runner's frames are captured at `cv2.VideoWriter.write`, its tracker
outputs where `tracker_step` returns them.

Tolerances: per frame, track ids, `confirmed` and `alive` equal, track
boxes and velocities within 1e-3 (on the CPU they have been equal); the
printed lines, the final summary line included, equal; the composites
equal pixel for pixel (the drawing is exact; a label or box corner of a
box within 1e-3 could truncate to the next pixel, which would fail here
and be seen); the port's AVI holds the composites' JPEG bytes.
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from tests.test_torch_cli_demo import assert_avi_holds, recording, run_jax_main, write_weights

BOX_TOL = 1e-3
N_FRAMES = 3
CONFIGS = {"defaults": [], "coasting": ["--min_hits", "1", "--show_coasting"]}


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from sfa3d_tpu.data.synthetic import write_mini_drive

    root = tmp_path_factory.mktemp("cli_track")
    drive = write_mini_drive(str(root / "drive"), n_frames=N_FRAMES, seed=0, motion=True)
    return drive, write_weights(root), root


@pytest.fixture(scope="module")
def runs(setup):
    import sfa3d_tpu.tracking as jtracking
    from sfa3d_tpu.cli import track as jtrack
    from sfa3d_tpu_torch.cli import track as ttrack

    drive, pth, root = setup
    results = {}
    for name, flags in CONFIGS.items():
        argv = ["--drive_dir", drive, "--pretrained_path", pth] + flags
        calls = []
        frames, printed = run_jax_main(jtrack.main, argv + ["--output_dir", str(root / f"jax_{name}")],
                                       [(jtracking, "tracker_step", recording(calls))])
        tout = str(root / f"port_{name}")
        port_printed = io.StringIO()
        with contextlib.redirect_stdout(port_printed):
            records = ttrack.main(argv + ["--output_dir", tout, "--platform", "cpu"])
        results[name] = {"frames": frames, "outputs": [c[1] for c in calls], "printed": printed,
                         "port_printed": port_printed.getvalue(), "records": records, "out": tout}
    return results


@pytest.mark.parametrize("name", list(CONFIGS))
def test_tracks_equal_jax(runs, name):
    run = runs[name]
    assert len(run["outputs"]) == len(run["records"]) == N_FRAMES
    for want, rec in zip(run["outputs"], run["records"]):
        got = rec["outputs"]
        for key in ("ids", "confirmed", "alive"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        alive = want["alive"]
        assert alive.any()
        np.testing.assert_allclose(got["boxes"][alive], want["boxes"][alive], rtol=0, atol=BOX_TOL)
        np.testing.assert_allclose(got["velocities"][alive], want["velocities"][alive], rtol=0, atol=BOX_TOL)
    assert run["port_printed"] == run["printed"]
    assert run["printed"].splitlines()[-1].startswith("done: ")
    if name == "coasting":
        assert run["records"][-1]["outputs"]["confirmed"].sum() > 0


@pytest.mark.parametrize("name", list(CONFIGS))
def test_composites_equal_jax(runs, name):
    run = runs[name]
    assert len(run["frames"]) == N_FRAMES
    for want, rec in zip(run["frames"], run["records"]):
        assert rec["composite"].shape == want.shape == (183 + 608, 608, 3)
        np.testing.assert_array_equal(rec["composite"], want)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_avi_holds_the_composites(runs, name):
    run = runs[name]
    assert os.listdir(run["out"]) == ["track_fpn_resnet_18.avi"]
    assert_avi_holds(os.path.join(run["out"], "track_fpn_resnet_18.avi"), [r["composite"] for r in run["records"]])


def test_metric_to_bev_px_and_labels_equal_jax():
    """The box-to-pixel inverse on seeded boxes, and the drawing of one
    confirmed and one coasting track with velocities (labels at fontScale
    0.4, arrows) on a blank BEV image."""
    import cv2  # noqa: F401  (the JAX drawing module needs it)
    from sfa3d_tpu.cli import track as jtrack
    from sfa3d_tpu_torch.cli import track as ttrack

    rng = np.random.default_rng(0)
    boxes = np.concatenate([rng.integers(0, 3, (20, 1)), rng.uniform(5, 45, (20, 1)), rng.uniform(-20, 20, (20, 1)),
                            rng.uniform(-2, 0, (20, 1)), rng.uniform(1, 4, (20, 3)), rng.uniform(-3, 3, (20, 1))],
                           axis=1).astype(np.float32)
    for box in boxes:
        assert ttrack.metric_to_bev_px(box) == jtrack.metric_to_bev_px(box)
    out = {"boxes": boxes[:4], "ids": np.array([3, 17, 5, 40], np.int32),
           "confirmed": np.array([True, False, True, False]), "alive": np.array([True, True, False, True]),
           "velocities": rng.uniform(-1.2, 1.2, (4, 3)).astype(np.float32)}
    for coasting in (False, True):
        a = np.full((608, 608, 3), 30, np.uint8)
        b = a.copy()
        jtrack.draw_tracks_bev(a, out, show_coasting=coasting)
        ttrack.draw_tracks_bev(b, out, show_coasting=coasting)
        np.testing.assert_array_equal(b, a)
        assert (b != 30).any()


def test_track_runs_on_cuda_unless_asked(setup, tmp_path, monkeypatch):
    from sfa3d_tpu_torch.cli import track as ttrack

    drive, _, _ = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrack.main(["--drive_dir", drive, "--output_dir", str(tmp_path)])
    assert not os.listdir(tmp_path)
