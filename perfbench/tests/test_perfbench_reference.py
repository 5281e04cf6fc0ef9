"""The plain reference against the port, at a small scale on the CPU: the
same seeded weights load into both networks, the raster is equal, and the
port's detections pass the comparison by far."""

import numpy as np
import torch

from perfbench.harness import inputs, registry
from perfbench.reference import kfpn as ref_kfpn
from perfbench.reference import lidar, raster

CFG = registry.load_json("configs", "kfpn18-bev608-fp32")


def test_seeded_weights_load_into_both_networks():
    from sfa3d_tpu_torch.models import create_model

    state = registry.load_module("systems", "lidar_detector").kfpn_state(CFG, 7, "cpu")
    create_model("fpn_resnet_18").load_state_dict(state, strict=True)
    ref_kfpn.KFPN(18, 64).load_state_dict(state, strict=True)
    again = registry.load_module("systems", "lidar_detector").kfpn_state(CFG, 7, "cpu")
    assert all(torch.equal(state[k], again[k]) for k in state)


def test_raster_equals_the_ports():
    from sfa3d_tpu_torch.ops.bev import filter_and_pad_points, points_to_bev_nchw

    scans = inputs.scan_pool(3, 2)
    port = [filter_and_pad_points(s, 32768) for s in scans]
    mine = [raster.filter_and_pad(s, CFG["boundary"], 32768) for s in scans]
    for (p, v), (q, w) in zip(port, mine):
        assert np.array_equal(p, q) and np.array_equal(v, w)
    pts = torch.from_numpy(np.stack([p for p, _ in mine]))
    valid = torch.from_numpy(np.stack([v for _, v in mine]))
    want = points_to_bev_nchw(pts, valid)
    got = raster.raster(pts, valid, CFG["boundary"], 608, 608)
    assert torch.equal(got[:, :2], want[:, :2])
    assert (got[:, 2] - want[:, 2]).abs().max() <= 1.2e-7


def test_port_detections_pass_the_comparison():
    from sfa3d_tpu_torch.detector import Detector

    system = registry.load_module("systems", "lidar_detector")
    det = Detector(device="cpu")
    det.model.load_state_dict(system.kfpn_state(CFG, 11, "cpu"))
    scans = inputs.scan_pool(11, 2)
    replies = [(i, system.System.compact(det.detect(s))) for i, s in enumerate(scans)]
    assert all(len(r) > 0 for _, r in replies)
    got = lidar.check(CFG, 11, scans, replies, "cpu")
    assert got["score_err"] < 1e-5 and got["box_err"] < 1e-4 and got["select_gap"] < 1e-5
    # an altered answer does not
    i, rows = replies[0]
    bad = rows.copy()
    bad[0, 2] += 0.01
    assert lidar.check(CFG, 11, scans, [(i, bad)], "cpu")["box_err"] > 5e-3
