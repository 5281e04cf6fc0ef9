"""scripts/torch_fusion_check.py against its JAX twin,
scripts/fusion_check.py, on the CPU: `build_camera_oracle` draws exactly
JAX's camera sets from the same numpy stream, and given the same
detections (each package's `detect_frames` replaced by one seeded set of
detections built from the ground truth) the two scripts' rows, every rule's
AP table and delta, equal each other."""

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
K = 50


def _load(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def kitti(tmp_path_factory):
    from sfa3d_tpu_torch.data.kitti import KittiDataset
    from sfa3d_tpu_torch.data.synthetic import write_mini_kitti

    root = write_mini_kitti(str(tmp_path_factory.mktemp("fusion") / "kitti"), n_frames=4, cameras=False)
    ds = KittiDataset(root, mode="val", hflip_prob=0.0)
    samples = [ds[i] for i in range(len(ds))]
    assert sum(int(s.n_labels) for s in samples) >= 8
    return root, samples


def test_camera_oracle_draws_equal_jax(kitti):
    _, samples = kitti
    port, jax_script = _load("torch_fusion_check"), _load("fusion_check")
    for kwargs in ({}, {"miss_prob": 0.0, "n_fp": 0, "jitter": 0.0}, {"miss_prob": 0.5, "n_fp": 5, "k_slots": 8}):
        rng_p, rng_j = np.random.default_rng(3), np.random.default_rng(3)
        for s in samples:  # one stream across the frames, as the scripts draw it
            lab = s.labels[: int(s.n_labels)]
            got = port.build_camera_oracle(lab, s.calib.P2, rng_p, **kwargs)
            want = jax_script.build_camera_oracle(lab, s.calib.P2, rng_j, **kwargs)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
        assert rng_p.bit_generator.state == rng_j.bit_generator.state


def _canned(samples):
    """A seeded detection set a frame from its ground truth: each box moved
    and resized a little, a score, and three false positives; the rows of
    `detect_frames`' output (boxes_real, detections[..., 0], mask)."""
    rng = np.random.default_rng(7)
    out = []
    for s in samples:
        lab = s.labels[: int(s.n_labels)]
        n = len(lab) + 3
        real = np.zeros((1, K, 8), np.float32)
        real[0, : len(lab)] = lab
        real[0, : len(lab), 1:3] += rng.normal(0, 0.25, (len(lab), 2)).astype(np.float32)
        real[0, : len(lab), 4:7] *= rng.uniform(0.9, 1.1, (len(lab), 3)).astype(np.float32)
        fp = lab[rng.integers(0, len(lab), 3)].copy()
        fp[:, 1:3] += rng.uniform(-6, 6, (3, 2)).astype(np.float32)
        real[0, len(lab): n] = fp
        dets = np.zeros((1, K, 10), np.float32)
        dets[0, :n, 0] = rng.uniform(0.25, 0.95, n)
        mask = np.zeros((1, K), bool)
        mask[0, :n] = True
        out.append({"boxes_real": real, "detections": dets, "mask": mask})
    return out


def test_rows_equal_jax_given_the_same_detections(kitti, tmp_path, monkeypatch):
    import sfa3d_tpu.models
    import sfa3d_tpu.pipeline
    import sfa3d_tpu_torch.cli.eval
    import sfa3d_tpu_torch.pipeline

    root, samples = kitti
    canned = _canned(samples)
    calls = {"jax": 0, "port": 0}

    def jax_detect(model, variables, points, valid, **kw):
        calls["jax"] += 1
        return canned[calls["jax"] - 1]

    def port_detect(model, points, valid, **kw):
        calls["port"] += 1
        return {k: torch.from_numpy(v) for k, v in canned[calls["port"] - 1].items()}

    monkeypatch.setattr(sfa3d_tpu.models, "load_variables", lambda *a, **kw: None)
    monkeypatch.setattr(sfa3d_tpu.pipeline, "detect_frames", jax_detect)
    monkeypatch.setattr(sfa3d_tpu_torch.cli.eval, "load_model", lambda *a, **kw: None)
    monkeypatch.setattr(sfa3d_tpu_torch.pipeline, "detect_frames", port_detect)
    flags = ["--dataset_dir", root, "--pretrained_path", "unused", "--oracle_seeds", "3", "--smoke"]
    monkeypatch.setattr(sys, "argv", ["fusion_check.py"] + flags + ["--cpu", "--out", str(tmp_path / "jax.json")])
    _load("fusion_check").main()
    rc = _load("torch_fusion_check").main(flags + ["--platform", "cpu", "--out", str(tmp_path / "port.json")])
    want, got = json.loads((tmp_path / "jax.json").read_text()), json.loads((tmp_path / "port.json").read_text())
    assert rc == 0 and calls == {"jax": len(samples), "port": len(samples)}
    assert got["frames"] == want["frames"] == len(samples)
    assert got["camera_confirmed_detections"] == want["camera_confirmed_detections"] > 0
    for key in ("lidar_only", "reference_max_rule_errorfree_control", "reference_max_rule",
                "monotone_demote_rule"):
        assert got[key] == want[key], key
    assert got["lidar_only"]["mAP"] > 0  # the canned detections score: not vacuous
    assert {k: v for k, v in got["camera_oracle"].items() if k != "why_oracle"} == \
        {k: v for k, v in want["camera_oracle"].items() if k != "why_oracle"}
    assert got["fusion_iou"] == want["fusion_iou"]
    assert got["device"] == {"platform": "cpu"}
