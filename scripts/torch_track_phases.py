"""Where the time of the tracker's association kernel goes, then the
tracking and serve-CLI phases of `chip_smoke.py`, on one NVIDIA GPU.

    python3 scripts/torch_track_phases.py

First the card and the kernel build. Then, per kernel of
`sfa3d_tpu_torch/csrc/track_associate.cu` built with the served flags, what
`nvcc -Xptxas -v` reports: registers per thread, spill stores and loads,
static shared memory. Then it builds the source with
-DTRACK_ASSOCIATE_PHASE_STAMPS (through `sfa3d_tpu_torch._build`, as a
library of its own), runs both designs (matrix and row) on the seeded
inputs of chip_smoke's track_kernels phase, holds every output bit for bit
against the plain PyTorch version, and prints one JSON line per (design,
input): the SM cycles of each phase (the median over frames: staging,
screen and keys with the block barrier; the candidate list; the chain; the
write-back), their sum, the chain's steps (candidate rows for the matrix
design, K for the row design), cycles per chain step, and the kernel's time
from CUDA events (the median of 50 launches). Then the host microseconds
of each piece of the wrapper's launch path at the served shape
(`host_path_us`), and the card's name, power limit and SM clocks as nvidia-smi reads them after the runs. Last, the
track_kernels, track and serve_cli phases of chip_smoke.py, each printing
its JSON line, and the association kernel's record. Exits non-zero when a
phase fails.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from sfa3d_tpu_torch import _build  # noqa: E402
from sfa3d_tpu_torch.ops import track_associate as ta  # noqa: E402
from torch_loop_phases import event_ms, ptxas_registers  # noqa: E402

STAMPS = 5  # kStamps of track_associate.cu: clock64() at the start and after each of four phases
SIGNATURES = {**ta._SIGNATURES,
              "track_associate_phase_stamps": (ctypes.c_int, (ctypes.c_void_p, ctypes.c_int32))}


def measure(lib, design: str, name: str, iou: torch.Tensor, order: torch.Tensor) -> dict:
    dev = iou.device
    b, k, t = iou.shape
    iou_min = chip_smoke.TRACK_IOU_MIN

    def call():
        return ta._launch(lib, dev, design, iou, order, iou_min)

    err, det_match, trk_used = call()
    torch.cuda.synchronize()
    want = ta.track_associate_plain(iou, order, iou_min)
    if err != 0 or not (torch.equal(det_match, want[0]) and torch.equal(trk_used, want[1])):
        raise AssertionError(f"track_associate {design} design on {name}: error {err} or not bit-exact")
    stamps = np.zeros(b * STAMPS, np.int64)
    if lib.track_associate_phase_stamps(stamps.ctypes.data, stamps.size) != 0:
        raise RuntimeError("reading the phase stamps failed")
    stamps = stamps.reshape(b, STAMPS)
    if (stamps[:, -1] <= stamps[:, 0]).any():
        raise AssertionError(f"{design} on {name}: a frame's block left no stamps")
    phases = np.diff(stamps, axis=1)
    cand = ta.track_associate_candidate_rows(iou, iou_min).sum(1).cpu().numpy()
    steps = cand if design == "matrix" else np.full(b, k)
    return {"design": design, "input": name, "shape": [b, k, t], "chain_steps": steps.tolist(),
            "cycles_stage_screen_keys": float(np.median(phases[:, 0])),
            "cycles_candidate_list": float(np.median(phases[:, 1])),
            "cycles_chain": float(np.median(phases[:, 2])), "cycles_write_back": float(np.median(phases[:, 3])),
            "cycles_total": float(np.median(stamps[:, -1] - stamps[:, 0])),
            "cycles_per_chain_step": float(np.median(phases[:, 2] / np.maximum(steps, 1))),
            "event_ms": event_ms(lambda: call())}


def host_path_us(iou: torch.Tensor, order: torch.Tensor, calls: int = 2000) -> dict:
    """Host microseconds per call of each piece of the wrapper's launch path
    (the served shape, no synchronisation inside a timed loop): the input
    checks, the library lookup, the card's limit and the design; the stream
    query; the two output allocations; the ctypes call into the C launcher
    with outputs already allocated; the whole wrapper call."""
    dev = iou.device
    b, k, t = iou.shape
    iou_min = chip_smoke.TRACK_IOU_MIN
    lib = ta.load_library("track_associate", ta._SIGNATURES)
    det_match, trk_used = order.new_empty((b, k)), iou.new_empty((b, t), dtype=torch.bool)
    stream = torch.cuda.current_stream(dev).cuda_stream
    pieces = {
        "checks_library_design": lambda: (ta._check(iou, order), ta._cuda_setup(iou, order),
                                          ta.track_associate_design(k, t, ta._device_smem_limit(lib, dev))),
        "current_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "two_allocations": lambda: (order.new_empty((b, k)), iou.new_empty((b, t), dtype=torch.bool)),
        "ctypes_launch": lambda: lib.track_associate_cuda(iou.data_ptr(), order.data_ptr(), det_match.data_ptr(),
                                                          trk_used.data_ptr(), b, k, t, iou_min, dev.index, stream),
        "wrapper": lambda: ta.track_associate(iou, order, iou_min),
    }
    out = {}
    for name, fn in pieces.items():
        out[name] = chip_smoke.enqueue_ms(fn, calls) * 1e3
    return out


def main() -> int:
    card = chip_smoke.phase_device()  # exits when there is no GPU
    chip_smoke.phase_build(card)
    for rec in ptxas_registers("track_associate"):
        print(json.dumps({"ptxas": rec}), flush=True)
    lib = _build.load_library("track_associate", SIGNATURES, flags=("-DTRACK_ASSOCIATE_PHASE_STAMPS",))
    for name, arrays in chip_smoke.track_seeded_inputs().items():
        iou, order = (torch.from_numpy(a).to(chip_smoke.DEVICE) for a in arrays)
        for design in ("matrix", "row"):
            print(json.dumps(measure(lib, design, name, iou, order)), flush=True)
    served = chip_smoke.track_seeded_inputs()["served_1x50x64"]
    print(json.dumps({"host_path_us": host_path_us(*(torch.from_numpy(a).to(chip_smoke.DEVICE) for a in served))}),
          flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    rec = chip_smoke.phase_track_kernels(card)
    chip_smoke.phase_track(card)
    with tempfile.TemporaryDirectory() as tmp:
        _, rec["launches"] = chip_smoke.phase_serve_cli(card, tmp)
    chip_smoke.emit({"kernels": [rec]})
    return 0


if __name__ == "__main__":
    sys.exit(main())
