"""The port's Argoverse entry points on the CPU: `python -m
sfa3d_tpu_torch.cli.argoverse_test` against the JAX package's raster, crop
and `detect_bev` on the same sweeps and weights (detections within 1e-3),
and `python -m sfa3d_tpu_torch.cli.train --dataset argoverse` for two
steps, whose checkpoint the runner loads.

Weights come from a JAX init bridged by `models/port.py::state_dict_from_jax`,
with the heatmap biases raised by 2.0 so random weights give peaks. The
fixture is the JAX package's `write_mini_argoverse`.
"""

import math
import os
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfa3d_tpu.data.argoverse import ArgoverseDataset as JArgoverseDataset
from sfa3d_tpu.data.argoverse import write_mini_argoverse
from sfa3d_tpu.geometry.transforms import center_to_corner_box3d as jcenter_to_corner_box3d
from sfa3d_tpu.models import create_model as jcreate_model
from sfa3d_tpu.ops.bev import argoverse_points_to_bev as jargoverse_points_to_bev
from sfa3d_tpu.pipeline import detect_bev as jdetect_bev
from sfa3d_tpu.pipeline import init_detector as jinit_detector
from sfa3d_tpu_torch.cli import argoverse_test
from sfa3d_tpu_torch.data.png import read_png_rgb
from sfa3d_tpu_torch.models import create_model
from sfa3d_tpu_torch.models.port import state_dict_from_jax

DET_TOL = 1e-3  # the repo's detection parity tolerance
GEOM_TOL = 1e-12
N_FRAMES = 2


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def mini_argo(tmp_path_factory):
    return write_mini_argoverse(str(tmp_path_factory.mktemp("argo")), n_frames=N_FRAMES, seed=1)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """JAX-initialised KFPN-18 weights (heatmap biases + 2.0), as JAX
    variables and as the port's .pth checkpoint."""
    jmodel = jcreate_model("fpn_resnet_18")
    variables = jax.tree_util.tree_map(np.array, jinit_detector(jmodel, jax.random.PRNGKey(0)))
    for i in range(3):
        variables["params"][f"fpn{i}_hm_cen"]["conv2"]["bias"] += 2.0
    model = create_model("fpn_resnet_18")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    path = str(tmp_path_factory.mktemp("ckpt") / "kfpn.pth")
    torch.save(model.state_dict(), path)
    return jmodel, variables, path


def _sorted(rows):
    return rows[np.lexsort((rows[:, 2], rows[:, 1], rows[:, 0]))]


def test_argoverse_test_cli_matches_jax(mini_argo, weights, tmp_path):
    jmodel, variables, ckpt = weights
    out_dir = str(tmp_path / "out")
    results = []
    failed = argoverse_test.main(["--dataset_dir", mini_argo, "--pretrained_path", ckpt, "--platform", "cpu",
                                  "--output_dir", out_dir], results=results)
    assert failed == 0 and len(results) == N_FRAMES

    jds = JArgoverseDataset(mini_argo, mode="test")
    n_dets = 0
    for got, idx in zip(results, range(len(jds))):
        sample = jds[idx]
        assert got["timestamp"] == sample.timestamp
        bev = jargoverse_points_to_bev(jnp.asarray(sample.points), jnp.asarray(sample.valid))
        crop = bev[196:804, 196:804, :] / 255.0
        dets, _, real, mask = (np.asarray(a) for a in jdetect_bev(jmodel, variables, crop[None], K=50,
                                                                   peak_thresh=0.2))
        np.testing.assert_array_equal(got["mask"], mask[0])
        np.testing.assert_allclose(got["detections"], dets[0], rtol=0, atol=DET_TOL)
        ours, ref = got["boxes_real"][got["mask"]], real[0][mask[0]]
        np.testing.assert_allclose(_sorted(ours), _sorted(ref), rtol=0, atol=DET_TOL)
        n_dets += len(ref)

        labels = sample.labels[: int(sample.n_labels)]
        corners = np.asarray(jcenter_to_corner_box3d(labels[:, 1:8]))
        assert len(got["gt_corners_uv"]) == len(corners) > 0
        for uv, box in zip(got["gt_corners_uv"], corners):
            juv, jvalid = sample.calib.project_ego_to_image(box)
            if jvalid.all():
                np.testing.assert_allclose(uv, juv, rtol=0, atol=GEOM_TOL)
            else:
                assert uv is None

        png = read_png_rgb(os.path.join(out_dir, f"{sample.timestamp}_bev.png"))
        want = np.asarray(bev).astype(np.uint8)[:, :, ::-1]  # the channels as B, G, R
        assert png.shape == (1000, 1000, 3)
        np.testing.assert_array_equal(png[..., :2], want[..., :2])
        assert np.abs(png[..., 2].astype(int) - want[..., 2]).max() <= 1  # density: uint8 of a 1e-4 difference
    assert n_dets > 0, "the weights gave no detection; the test would be vacuous"


def test_argoverse_test_cli_counts_failed_frames(mini_argo, tmp_path):
    """A sweep that cannot be read fails alone: the run goes on and main
    returns the number of frames that failed."""
    root = str(tmp_path / "argo")
    shutil.copytree(mini_argo, root)
    lidar = os.path.join(root, "samplefile", "lidar")
    cam = os.path.join(root, "samplefile", "ring_front_center")
    (tmp_path / "argo" / "samplefile" / "lidar" / "999999999999999999.bin").write_bytes(b"\0" * 5)
    shutil.copy(os.path.join(cam, sorted(os.listdir(cam))[0]), os.path.join(cam, "999999999999999999.jpg"))
    assert len(os.listdir(lidar)) == N_FRAMES + 1
    results = []
    failed = argoverse_test.main(["--dataset_dir", root, "--platform", "cpu", "--output_dir",
                                  str(tmp_path / "out")], results=results)
    assert failed == 1 and len(results) == N_FRAMES


def test_argoverse_test_cli_raises_without_gpu(mini_argo, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        argoverse_test.main(["--dataset_dir", mini_argo, "--output_dir", str(tmp_path)])


def test_train_cli_dataset_argoverse(mini_argo, weights, tmp_path):
    """Two accumulated steps of the training CLI on the Argoverse path (608
    crop, batch 1): finite losses, the validation loss, --val_ap warned and
    skipped, and a checkpoint that argoverse_test loads."""
    from sfa3d_tpu_torch.cli.train import main

    main(["--dataset", "argoverse", "--dataset_dir", mini_argo, "--root-dir", str(tmp_path / "run"),
          "--batch_size", "1", "--effective_batch", "1", "--num_epochs", "1", "--checkpoint_freq", "1",
          "--platform", "cpu", "--compute_dtype", "float32", "--print_freq", "1", "--saved_fn", "argo",
          "--val_ap"])
    ckpt = tmp_path / "run" / "checkpoints" / "argo" / "Model_argo_epoch_1.pth"
    payload = torch.load(str(ckpt), weights_only=True)
    assert payload["step"] == N_FRAMES and payload["epoch"] == 1
    log = (tmp_path / "run" / "logs" / "argo" / "logger_argo.txt").read_text()
    losses = [float(v) for v in re.findall(r"Loss (\S+) \(", log)]
    assert len(losses) >= N_FRAMES and all(math.isfinite(v) for v in losses)
    val = float(re.search(r"val_loss: (\S+)", log).group(1))
    assert math.isfinite(val)
    assert "--val_ap supports the KITTI layout only; skipping" in log
    results = []
    assert argoverse_test.main(["--dataset_dir", mini_argo, "--pretrained_path", str(ckpt), "--platform", "cpu",
                                "--output_dir", str(tmp_path / "out"), "--num_samples", "1"], results=results) == 0
    assert len(results) == 1 and results[0]["detections"].shape == (50, 10)
