"""A whole run of a cell, on the CPU, with the look for a card skipped and
the timed path broken underneath: `correct` has to come out false for each
fault a served cell can have, and true with none."""

import time

import pytest
import torch

from perfbench.harness import registry
from perfbench.harness.bench import run_cell


def alter_answers(monkeypatch):
    """A box moved where it is produced (the decode's metric rows)."""
    import sfa3d_tpu_torch.pipeline as pipeline

    real = pipeline._decode_heads

    def moved(outputs, K, peak_thresh):
        dets, boxes_bev, boxes_real, mask = real(outputs, K, peak_thresh)
        boxes_real = boxes_real.clone()
        boxes_real[..., 1] += 0.3
        return dets, boxes_bev, boxes_real, mask

    monkeypatch.setattr(pipeline, "_decode_heads", moved)


def drop_half_the_batch(monkeypatch):
    """The second half of every device batch answered with no detections."""
    from sfa3d_tpu_torch.detector import Detector

    real = Detector.detect_batch

    def half(self, pts, valid):
        out = real(self, pts, valid)
        out["mask"] = out["mask"].copy()
        out["mask"][len(pts) // 2:] = False
        return out

    monkeypatch.setattr(Detector, "detect_batch", half)


@pytest.mark.parametrize("fault", [None, alter_answers, drop_half_the_batch],
                         ids=["sound", "answer_altered", "half_batch_dropped"])
def test_fault_makes_the_run_incorrect(fault, monkeypatch):
    torch.set_num_threads(4)
    # a CPU window answers a few dozen requests: keep every reply for the check
    monkeypatch.setattr(registry.load_module("drivers", "closed_loop"), "KEEP_SHARE", 1.0)
    if fault is not None:
        fault(monkeypatch)
    res = run_cell("lidar-closed-b8", 2 ** 31 + 12345, 2.0, False, time.perf_counter(), device="cpu")
    assert res["attempted"] > 0 and res["notes"]["sampled"] > 0
    assert res["correct"] is (fault is None), res["checks"]
