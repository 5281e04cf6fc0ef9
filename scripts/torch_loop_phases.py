"""Where the time of the loop kernels of the PyTorch port goes, phase by
phase, on one NVIDIA GPU.

    python3 scripts/torch_loop_phases.py

First prints, per kernel of `sfa3d_tpu_torch/csrc/fusion_loops.cu` built
with the served flags, what `nvcc -Xptxas -v` reports: registers per
thread, spill stores and loads, static shared memory. Then builds it with
-DFUSION_LOOPS_PHASE_STAMPS (through `sfa3d_tpu_torch._build`, as a
library of its own), runs
`hard_nms_keep`, `soft_nms_gaussian` (decay matrix) and `greedy_match` (key
matrix) on the inputs of `chip_smoke.py`'s fusion_kernels phase, holds every
output bit for bit against the plain PyTorch version, and prints one JSON
line per (kernel, input): the SM cycles of each phase (the median over
frames: loading the frame and the first cluster barrier; phase 1 (the
match: with its second barrier and candidate list); the rest and phase 2),
their sum, and the kernel's time from CUDA events (the median of 50
launches); for the match also the candidate rows (the chain's steps) and
phase 2's cycles per step. Then the card's name and power limit, and its SM
clock as nvidia-smi reads it after the runs.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from sfa3d_tpu_torch import _build  # noqa: E402
from sfa3d_tpu_torch.ops import fusion_loops  # noqa: E402

CASES = {"hard_nms_keep": ["class_offset_256", "chain_70", "class_offset_1024"],
         "soft_nms_gaussian": ["random", "zero_and_signed_scores", "matrix_limit_{slots}"],
         "greedy_match": ["served_64x50", "every_row_candidate_64x50", "matrix_limit_{rows}x256"]}
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


def ptxas_registers(source: str = "fusion_loops") -> list:
    """Per kernel of csrc/<source>.cu built with the served flags: {kernel,
    registers, spill_stores, spill_loads, smem_bytes}, from nvcc -Xptxas -v."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", f"{tmp}/lib.so",
                               str(_build.CSRC_DIR / f"{source}.cu")], capture_output=True, text=True, check=True)
    out, name = [], None
    for line in (proc.stdout + proc.stderr).splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            k = re.search(r"\d([a-z_]+_kernel)(?:ILi(\d+)E)?", m.group(1))  # past the mangled prefix
            name = k.group(1) + (f"<{k.group(2)}>" if k.group(2) else "") if k else m.group(1)
            out.append({"kernel": name})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out[-1].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", line)
            out[-1].update(registers=int(m.group(1)), smem_bytes=int(smem.group(1)) if smem else 0)
    return out


def match_call(lib, arrays):
    """(call, outputs, plain outputs, candidate rows per frame) of the match's
    matrix kernel on one input, past the wrapper."""
    dev = torch.device("cuda")
    y, yv, sf, sv = (torch.from_numpy(a).to(dev) for a in arrays[:4])
    thr = arrays[4]
    (b, ky), ks = yv.shape, sv.shape[1]
    if ky > fusion_loops.greedy_match_matrix_rows(ks, chip_smoke.shared_memory_limit(dev)):
        raise ValueError(f"{ky} x {ks} takes the block design, which has no phases")
    idx, matched = yv.new_empty((b, ky), dtype=torch.int32), sv.new_empty((b, ks))
    stream = torch.cuda.current_stream(dev).cuda_stream

    def call():
        return lib.greedy_match_cuda(y.data_ptr(), yv.data_ptr(), sf.data_ptr(), sv.data_ptr(), idx.data_ptr(),
                                     matched.data_ptr(), b, ky, ks, thr, dev.index or 0, stream)
    return (call, (idx, matched), fusion_loops.greedy_match_plain(y, yv, sf, sv, thr),
            fusion_loops.greedy_match_candidate_rows(y, yv, sf, sv, thr).cpu().numpy())


def measure(lib, entry: str, name: str, arrays) -> dict:
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream
    extra = {}
    if entry == "greedy_match":
        call, out, want, cand = match_call(lib, arrays)
        b, k = len(cand), [arrays[0].shape[1], arrays[2].shape[1]]
    elif entry == "hard_nms_keep":
        boxes, scores, valid = (torch.from_numpy(a).to(dev) for a in arrays)
        b, k = valid.shape
        sboxes, svalid = chip_smoke.sorted_candidates(boxes, scores, valid)
        out = svalid.new_empty((b, k))
        want = fusion_loops.hard_nms_keep_plain(sboxes, svalid, 0.45)

        def call():
            return lib.hard_nms_keep_cuda(sboxes.data_ptr(), svalid.data_ptr(), out.data_ptr(),
                                          b, k, 0.45, dev.index or 0, stream)
    else:
        boxes, scores, valid = (torch.from_numpy(a).to(dev) for a in arrays)
        b, k = valid.shape
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
    exact = all(map(torch.equal, out, want)) if isinstance(out, tuple) else torch.equal(out, want)
    if err != 0 or not exact:
        raise AssertionError(f"{entry} on {name}: error {err} or not bit-exact")
    stamps = np.zeros(b * CLUSTER * 4, np.int64)
    if lib.fusion_phase_stamps(stamps.ctypes.data, stamps.size) != 0:
        raise RuntimeError("reading the phase stamps failed")
    lead = stamps.reshape(b * CLUSTER, 4)[::CLUSTER]  # the first block of each frame's cluster
    if (lead[:, 3] <= lead[:, 0]).any():
        raise AssertionError(f"{entry} on {name}: a frame's first block left no stamps")
    phases = np.diff(lead, axis=1)
    if entry == "greedy_match":
        steps = np.maximum(cand, 1)
        extra = {"candidate_rows": cand.tolist(),
                 "cycles_per_chain_step": float(np.median(phases[:, 2] / steps))}
    return {"kernel": entry, "input": name, "shape": [b, k],
            "cycles_load": float(np.median(phases[:, 0])), "cycles_phase1": float(np.median(phases[:, 1])),
            "cycles_phase2": float(np.median(phases[:, 2])),
            "cycles_total": float(np.median(lead[:, 3] - lead[:, 0])),
            "event_ms": event_ms(lambda: call()), **extra}


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_loop_phases: no GPU", file=sys.stderr)
        return 1
    for rec in ptxas_registers():
        print(json.dumps({"ptxas": rec}), flush=True)
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    slots = fusion_loops.soft_nms_matrix_slots(chip_smoke.shared_memory_limit(dev))
    rows = chip_smoke.match_rows_limit(dev)
    nms_cases, match_cases = chip_smoke.loop_inputs(np.random.default_rng(chip_smoke.SEED + 5), slots, rows)
    lib = _build.load_library("fusion_loops", SIGNATURES, flags=("-DFUSION_LOOPS_PHASE_STAMPS",))
    for entry, names in CASES.items():
        cases = match_cases if entry == "greedy_match" else nms_cases
        for name in (n.format(slots=slots, rows=rows) for n in names):
            print(json.dumps(measure(lib, entry, name, cases[name])), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
