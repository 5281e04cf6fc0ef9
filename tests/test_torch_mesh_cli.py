"""The port's data-parallel entry points on the CPU: `python -m
sfa3d_tpu_torch.cli.train --mesh_shape 2 --platform cpu` (two spawned gloo
ranks) for one epoch over a 4-frame mini-KITTI at the full raster, and the
two-process SFA3D_DIST smoke (scripts/torch_multihost_smoke.py), whose
processes must print identical losses, as tests/test_multihost.py holds
JAX's. Every launch runs in its own session with a timeout; on a timeout
the whole session (the spawned ranks too) is killed and the test fails.
"""

import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sfa3d_tpu_torch.config.train import mesh_size, parse_train_configs
from sfa3d_tpu_torch.parallel.mesh import free_port

ROOT = Path(__file__).resolve().parent.parent
LAUNCH_TIMEOUT = 300  # s


def _run(cmds, envs):
    """Start every command in its own session, wait for all within
    LAUNCH_TIMEOUT; kill every session left on a timeout."""
    procs = [subprocess.Popen(c, cwd=ROOT, env=e, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              start_new_session=True) for c, e in zip(cmds, envs)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=LAUNCH_TIMEOUT))
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    return [(p.returncode, out, err) for p, (out, err) in zip(procs, outs)]


def _env(**kw):
    """The launch's environment: no SFA3D_DIST variables but those given,
    and two torch threads a launch (spawned CPU ranks share them) beside
    the other workers of a parallel test run."""
    env = dict(os.environ, OMP_NUM_THREADS="2")
    for k in ("SFA3D_DIST", "SFA3D_COORDINATOR", "SFA3D_NUM_PROCESSES", "SFA3D_PROCESS_ID"):
        env.pop(k, None)
    env.update(kw)
    return env


def test_mesh_shape_resolution_and_refusals(monkeypatch):
    monkeypatch.delenv("SFA3D_DIST", raising=False)
    assert mesh_size(parse_train_configs(["--mesh_shape", "2", "--platform", "cpu"])) == 2
    assert mesh_size(parse_train_configs(["--platform", "cpu"])) == 1  # None: every device, one on the CPU
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert mesh_size(parse_train_configs([])) == 2  # None: every visible GPU
    assert parse_train_configs(["--mesh_shape", "2"]).runtime.mesh_shape == 2
    with pytest.raises(NotImplementedError, match="larger than the 2 visible GPUs"):
        parse_train_configs(["--mesh_shape", "3"])
    monkeypatch.setenv("SFA3D_DIST", "1")  # the launch defines the world
    assert parse_train_configs(["--mesh_shape", "3"]).runtime.mesh_shape == 3
    with pytest.raises(ValueError, match="at least one device"):
        parse_train_configs(["--mesh_shape", "0"])


def test_train_cli_mesh_shape_2_on_the_cpu(tmp_path):
    """Two gloo ranks, a global batch of 2 (one frame a rank): two steps,
    the validation loss, a checkpoint written once by rank 0 that Detector
    loads, and the log of rank 0 alone."""
    from sfa3d_tpu_torch.data.synthetic import synthetic_scene, write_mini_kitti
    from sfa3d_tpu_torch.detector import Detector

    root = write_mini_kitti(str(tmp_path / "kitti"), n_frames=4)
    cmd = [sys.executable, "-m", "sfa3d_tpu_torch.cli.train", "--dataset_dir", root, "--root-dir",
           str(tmp_path / "run"), "--batch_size", "2", "--effective_batch", "2", "--num_epochs", "1",
           "--checkpoint_freq", "1", "--platform", "cpu", "--compute_dtype", "float32", "--num_workers", "2",
           "--print_freq", "1", "--saved_fn", "dp", "--mesh_shape", "2"]
    [(rc, out, err)] = _run([cmd], [_env()])
    assert rc == 0, err[-3000:]
    ckdir = tmp_path / "run" / "checkpoints" / "dp"
    assert sorted(p.name for p in ckdir.iterdir()) == ["Model_dp_epoch_1.pth"]
    payload = torch.load(ckdir / "Model_dp_epoch_1.pth", weights_only=True)
    assert payload["step"] == 2 and payload["epoch"] == 1
    log = (tmp_path / "run" / "logs" / "dp" / "logger_dp.txt").read_text()
    assert "data parallel: 2 ranks over gloo, global batch 2, 1 frames a rank" in log
    assert log.count(">>> Epoch: [1/1]") == 1 and "val_loss" in log and "save a checkpoint" in log
    assert "number of batches in training set: 2" in log
    det = Detector(checkpoint=str(ckdir / "Model_dp_epoch_1.pth"), device="cpu")
    assert isinstance(det.detect(synthetic_scene(0)[0]), list)


def test_sfa3d_dist_two_processes_print_identical_losses():
    port = free_port()
    cmd = [sys.executable, "scripts/torch_multihost_smoke.py", "--steps", "2", "--platform", "cpu"]
    envs = [_env(SFA3D_DIST="1", SFA3D_COORDINATOR=f"127.0.0.1:{port}", SFA3D_NUM_PROCESSES="2",
                 SFA3D_PROCESS_ID=str(pid)) for pid in range(2)]
    results = _run([cmd, cmd], envs)
    outs = []
    for rc, out, err in results:
        assert rc == 0, err[-3000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))
    by_pid = {o["process"]: o for o in outs}
    assert set(by_pid) == {0, 1}
    for o in outs:
        assert o["process_count"] == 2 and o["backend"] == "gloo" and o["device"] == "cpu"
        assert all(np.isfinite(o["losses"])) and not o["jax_imported"]
    assert by_pid[0]["losses"] == by_pid[1]["losses"]
    assert by_pid[0]["losses"][0] != by_pid[0]["losses"][1]  # the step moved the weights


def test_multihost_smoke_defaults_to_the_card():
    """Without --platform the smoke asks for cuda, as every entry point of
    the port does, and raises where there is no GPU."""
    env = _env(SFA3D_DIST="1", SFA3D_COORDINATOR=f"127.0.0.1:{free_port()}", SFA3D_NUM_PROCESSES="1",
               SFA3D_PROCESS_ID="0", CUDA_VISIBLE_DEVICES="")
    [(rc, out, err)] = _run([[sys.executable, "scripts/torch_multihost_smoke.py", "--steps", "1"]], [env])
    assert rc != 0 and "cuda" in err.lower() and not out.strip()
