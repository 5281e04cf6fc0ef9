"""Where the time of the two NMS kernels of the PyTorch port goes, phase by
phase, on one NVIDIA GPU.

    python3 scripts/torch_loop_phases.py

Builds `sfa3d_tpu_torch/csrc/fusion_loops.cu` with -DFUSION_LOOPS_PHASE_STAMPS
(through `sfa3d_tpu_torch._build`, as a library of its own), runs
`hard_nms_keep` and `soft_nms_gaussian` on the inputs of `chip_smoke.py`'s
fusion_kernels phase, holds every output bit for bit against the plain
PyTorch version, and prints one JSON line per (kernel, input): the SM
cycles of each phase (the median over frames: loading the frame and the
first cluster barrier; phase 1; the second barrier and phase 2), their sum,
and the kernel's time from CUDA events (the median of 50 launches). Then
the card's name and power limit, and its SM clock as nvidia-smi reads it
after the runs.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from sfa3d_tpu_torch import _build  # noqa: E402
from sfa3d_tpu_torch.ops import fusion_loops  # noqa: E402

CASES = {"hard_nms_keep": ["class_offset_256", "chain_70", "class_offset_1024"],
         "soft_nms_gaussian": ["random", "zero_and_signed_scores", "matrix_limit_{slots}"]}
CLUSTER = 4  # blocks per frame: kCluster of fusion_loops.cu
SIGNATURES = {**fusion_loops._SIGNATURES,
              "fusion_phase_stamps": (ctypes.c_int, (ctypes.c_void_p, ctypes.c_int32))}


def event_ms(fn, reps: int = 50) -> float:
    for _ in range(5):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def measure(lib, entry: str, name: str, arrays) -> dict:
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream
    boxes, scores, valid = (torch.from_numpy(a).to(dev) for a in arrays)
    b, k = valid.shape
    if entry == "hard_nms_keep":
        sboxes, svalid = chip_smoke.sorted_candidates(boxes, scores, valid)
        out = svalid.new_empty((b, k))
        want = fusion_loops.hard_nms_keep_plain(sboxes, svalid, 0.45)

        def call():
            return lib.hard_nms_keep_cuda(sboxes.data_ptr(), svalid.data_ptr(), out.data_ptr(),
                                          b, k, 0.45, dev.index or 0, stream)
    else:
        if k > fusion_loops.soft_nms_matrix_slots(chip_smoke.shared_memory_limit(dev)):
            raise ValueError(f"K = {k} takes the block design, which has no phases")
        out, surv = scores.new_empty((b, k)), valid.new_empty((b, k))
        want = fusion_loops.soft_nms_gaussian_plain(boxes, scores, valid)[0]

        def call():
            return lib.soft_nms_gaussian_cuda(boxes.data_ptr(), scores.data_ptr(), valid.data_ptr(),
                                              out.data_ptr(), surv.data_ptr(), b, k,
                                              fusion_loops.inv_sigma(0.5), 0.001, dev.index or 0, stream)
    err = call()
    torch.cuda.synchronize()
    if err != 0 or not torch.equal(out, want):
        raise AssertionError(f"{entry} on {name}: error {err} or not bit-exact")
    stamps = np.zeros(b * CLUSTER * 4, np.int64)
    if lib.fusion_phase_stamps(stamps.ctypes.data, stamps.size) != 0:
        raise RuntimeError("reading the phase stamps failed")
    lead = stamps.reshape(b * CLUSTER, 4)[::CLUSTER]  # the first block of each frame's cluster
    if (lead[:, 3] <= lead[:, 0]).any():
        raise AssertionError(f"{entry} on {name}: a frame's first block left no stamps")
    phases = np.diff(lead, axis=1)
    return {"kernel": entry, "input": name, "shape": [b, k],
            "cycles_load": float(np.median(phases[:, 0])), "cycles_phase1": float(np.median(phases[:, 1])),
            "cycles_phase2": float(np.median(phases[:, 2])),
            "cycles_total": float(np.median(lead[:, 3] - lead[:, 0])),
            "event_ms": event_ms(lambda: call())}


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_loop_phases: no GPU", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    slots = fusion_loops.soft_nms_matrix_slots(chip_smoke.shared_memory_limit(dev))
    nms_cases, _ = chip_smoke.loop_inputs(np.random.default_rng(chip_smoke.SEED + 5), slots)
    lib = _build.load_library("fusion_loops", SIGNATURES, flags=("-DFUSION_LOOPS_PHASE_STAMPS",))
    for entry, names in CASES.items():
        for name in (n.format(slots=slots) for n in names):
            print(json.dumps(measure(lib, entry, name, nms_cases[name])), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
