"""`python -m sfa3d_tpu_torch.cli fuse --artifact` on a fused export of the
port (`runtime/export.py::export_fused`, on the CPU at a 64-px letterbox,
batch 1, the fixture's 375 x 1242 frames) against the live port runner with
the same weights and the settings the export bakes (bayesian with Gaussian
soft-NMS, confidence 0, peak threshold 0, the live path's 0.3 gate on the
3D scores). The weights are tests/test_torch_cli_fuse.py's.

Tolerances: the `_fused` image byte-equal to the live runner's with the FPS
header's box masked; the summary's frame count and mean detection count
after fusion equal (its first line names the artifact, as the JAX runner's
does); `--artifact` with `--side_by_side`, and an artifact of another
platform, exit with a message.
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from tests.test_torch_cli_fuse import header_mask, port_images, write_weights

LIVE = ["--mode", "bayesian", "--gaussian_nms", "--imgsz", "64", "--confidence_threshold", "0.0",
        "--peak_thresh", "0.0"]
BAKED = dict(K=50, max_yolo=64, mode="bayesian", use_gaussian_nms=True, peak_thresh=0.0, sfa_conf_gate=0.3,
             yolo_conf=0.0, confidence_threshold=0.0)


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from sfa3d_tpu.data.synthetic import write_mini_kitti
    from sfa3d_tpu_torch.cli.eval import load_model
    from sfa3d_tpu_torch.config import kitti as cnf
    from sfa3d_tpu_torch.models.yolov8 import load_yolo_checkpoint
    from sfa3d_tpu_torch.runtime.export import export_fused, save_exported

    root = tmp_path_factory.mktemp("cli_fuse_artifact")
    kitti = write_mini_kitti(str(root / "kitti"), n_frames=1)
    pth, pt = write_weights(root)
    kfpn = load_model("fpn_resnet_18", pth, False, torch.device("cpu"))
    yolo = load_yolo_checkpoint(pt).eval()
    exported, manifest = export_fused(kfpn, yolo, batch=1, max_points=cnf.MAX_POINTS_FILTERED,
                                      img_hw=(375, 1242), letterbox=64, **BAKED)
    path = str(root / "fused.sfa3dt")
    save_exported(path, exported, manifest)
    return kitti, pth, pt, path, root


def _summary_tail(path):
    lines = open(path).read().splitlines()
    return [line for line in lines if line.startswith(("frames:", "mean detections after"))]


def test_artifact_run_equals_the_live_run(setup):
    from sfa3d_tpu_torch.cli import fuse as tfuse

    kitti, pth, pt, artifact, root = setup
    live, art = str(root / "live"), str(root / "artifact")
    with contextlib.redirect_stdout(io.StringIO()):
        with port_images(live) as a:
            tfuse.main(["--dataset_dir", kitti, "--pretrained_path", pth, "--yolo_weights", pt, "--platform", "cpu",
                        "--output_dir", live] + LIVE)
        with port_images(art) as b:
            tfuse.main(["--dataset_dir", kitti, "--artifact", artifact, "--platform", "cpu", "--output_dir", art])
    assert sorted(a) == sorted(b) == ["000000_fused.jpg"]
    keep = ~header_mask(a["000000_fused.jpg"].shape)
    assert np.array_equal(a["000000_fused.jpg"][keep], b["000000_fused.jpg"][keep])
    assert _summary_tail(os.path.join(live, "summary.txt")) == _summary_tail(os.path.join(art, "summary.txt"))
    assert open(os.path.join(art, "summary.txt")).read().startswith(f"mode: artifact ({artifact})\n")
    assert float(_summary_tail(os.path.join(art, "summary.txt"))[1].split(": ")[1]) > 0


def test_artifact_refusals(setup, tmp_path):
    from sfa3d_tpu_torch.cli import fuse as tfuse

    kitti, _, _, artifact, _ = setup
    base = ["--dataset_dir", kitti, "--artifact", artifact, "--output_dir", str(tmp_path)]
    with pytest.raises(SystemExit, match="--side_by_side needs the separate YOLO/SFA3D branches"):
        tfuse.main(base + ["--platform", "cpu", "--side_by_side"])
    with pytest.raises(SystemExit, match=r"exported for \['cpu'\]; it cannot run on cuda"):
        tfuse.main(base)
