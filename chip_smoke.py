"""Drive the PyTorch port's LiDAR and camera + LiDAR fusion serving paths
and its training path on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  device  the card (name and power limit from nvidia-smi); TF32 off
  build   nvcc builds every kernel in sfa3d_tpu_torch/csrc/, one nvcc per
          source, all started together (timed)
  kernel  both entries of the BEV tile kernel (csrc/bev_counts.cu),
          bev_raster_reduce and bev_cell_counts, vs their plain PyTorch
          versions on (8, 32768) inputs: the served shape with and without
          one cell hit 10,000 times, an all-invalid frame, every point on the
          rows where two bands meet, every point in one band. Event time per
          wrapper call, device-only time (torch.profiler), plain and library
          times at the served shape; device time on the other inputs, with no
          points and with every point dropped (where the time goes)
  raster  GPU points_to_bev (through bev_raster_reduce) vs the CPU plain
          path: channels 0 and 1, cell indices, keys and counts bit-exact,
          density within 1.2e-7
  model   KFPN-18 heads at 608x608 on the GPU vs the CPU, within 1e-3
  serve   BatchingDetectorServer(Detector(device="cuda"), max_batch=8)
          answers 16 requests from 4 threads; every reply matches the CPU
          Detector within 1e-3; bev_raster_reduce's launches equal the
          served batches plus the warmup batches; per-batch latency at
          buckets 1 and 8, frames/s and a per-stage split (the raster split
          into its elementwise prelude and the reduce kernel)
  counts  the count map of the 16 served scans through the public op
          (cell_indices_and_keys -> bev_cell_counts, two launches of 8):
          each frame's counts sum to its in-range points, and the density
          they give equals the served raster's channel 2
  fusion_kernels  the three loop kernels of csrc/fusion_loops.cu
          (hard_nms_keep, soft_nms_gaussian, greedy_match) vs their plain
          PyTorch versions on the card, bit for bit (masks, indices and
          soft-NMS scores): random boxes, all-invalid frames, equal scores
          (ties), duplicates, class-offset candidates, K = 1, 33 and 1024
          (the hard-NMS words at their edges), the served shapes (8 x 256
          YOLO candidates; 8 x 114 fused slots; 8 x 64 YOLO x 50 SFA), and
          soft-NMS on either side of soft_nms_matrix_slots (the decay-matrix
          kernel at the limit, the block kernel one above it and at 1024),
          zero and signed scores (-0 ties +0; negative scores order), a
          chain of boxes that each overlap the next (every other one kept);
          the match also on a grid where every YOLO row has a candidate, a
          frame with none, threshold 0 with touching boxes (IoU exactly 0),
          and on either side of greedy_match_matrix_rows at Ks = 256, each
          input through the wrapper and through the block design. Event,
          device, per-step and plain ms at the served shape, device ms of
          both designs of soft-NMS and of the match at the switch and at
          the served shape, candidate rows per frame
  yolo    YOLOv8n heads at 1 x 224 x 640 on the GPU vs the CPU, per level
  fused_serve  BatchingFusedServer(FusedDetector(imgsz=(224, 640))),
          max_batch 8, answers 16 requests (scan + seeded 375 x 1242 uint8
          image + default calibration) from 4 threads; the raster kernel and
          each loop kernel launched once per batch (warmups included);
          every reply equals the CPU path's as a set of detections (integer
          boxes, classes, source exact, scores within 1e-4) when the CPU
          path is given the served networks' outputs for that frame, and the
          CPU networks' own outputs lie within 1e-3 of those; the replies
          hold YOLO, SFA and at least 16 fused rows; the match's candidate
          rows per frame. Per-batch ms at buckets 1 and 8 and a stage split
  train   first one strict-fp32 accumulated step (S = 2 x B = 2 frames,
          128 x 128 raster, deterministic cuDNN) of the same model and batch
          on the card and the CPU, SGD then Adam: loss, every parameter and
          every BatchNorm statistic within the tolerances printed on the
          train_tolerance line. Then the full width through the entry points
          a user calls: the CLI's parser and defaults (fpn_resnet_18 on the
          608 x 608 raster, batch 16, effective batch 64, so S = 4),
          create_train_loader over a synthetic mini-KITTI of 64 frames with
          augmentation and hflip, create_optimizer, create_train_state,
          make_train_step: 5 steps in float32 and 3 in the bfloat16 default
          (CUDA-event ms per step, frames/s end to end with the loader's
          wait and on the device alone, peak memory), every loss finite,
          bev_raster_reduce launched once per collated batch; 8 Adam steps
          on one fixed batch lower its loss; one collated batch of 64
          frames (hflip as drawn) through the raster kernel against its
          plain version on the card, and through prepare_train_batch
          against the CPU route (raster channels 0 and 1 and the integer
          targets bit-exact); one epoch of the training CLI, whose
          checkpoint Detector loads, and its validation batches (16, 16 and
          a tail of 8 frames) on the card against the CPU route
Then one {"kernels": [...]} line and, last, the {"ok": true, ...} line.

Exits non-zero, with no result line, when CUDA is unavailable or any
phase fails. Weights are random, drawn from a fixed torch.Generator.
"""

from __future__ import annotations

import copy
import json
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from sfa3d_tpu_torch import _build
from sfa3d_tpu_torch.config import kitti as cnf
from sfa3d_tpu_torch.detector import Detector, FusedDetector
from sfa3d_tpu_torch.fusion.batch import _fuse_one, _unletterbox_xywh
from sfa3d_tpu_torch.fusion.boxes2d import project_boxes_to_image
from sfa3d_tpu_torch.fusion.nms import _stable_desc_order
from sfa3d_tpu_torch.geometry.calibration import KittiCalibration
from sfa3d_tpu_torch.models import create_model
from sfa3d_tpu_torch.models.yolov8 import (
    YOLOv8,
    decode_predictions,
    forward_levels,
    letterbox,
    select_detections,
)
from sfa3d_tpu_torch.ops import bev as bev_ops
from sfa3d_tpu_torch.ops import fusion_loops
from sfa3d_tpu_torch.ops.bev_counts import (
    COUNT_BYTES_PER_CELL,
    RASTER_BYTES_PER_CELL,
    bev_cell_counts,
    bev_cell_counts_plain,
    bev_raster_reduce,
    bev_raster_reduce_plain,
    shared_memory_limit,
    tile_plan,
)
from sfa3d_tpu_torch.pipeline import _decode_heads, _heads_nhwc, forward_heads
from sfa3d_tpu_torch.runtime.serving import BatchingDetectorServer, BatchingFusedServer

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
SEED = 0
HM_BIAS_BUMP = 2.0  # random weights then give peaks above the threshold
B, N = 8, cnf.MAX_POINTS_FILTERED
H, W = cnf.BEV_HEIGHT, cnf.BEV_WIDTH
DENSITY_TOL = 1.2e-7  # one float32 ulp of log between two libms, scaled
KERNEL_NAME = r"bev_tile_kernel"
CANVAS = (224, 640)  # the ultralytics predict canvas of a 375 x 1242 KITTI frame
IMG_HW = (375, 1242)
SCORE_TOL = 1e-4  # fused scores GPU vs CPU: conv sums in another order
NET_TOL = 1e-3  # KFPN heads and YOLO levels GPU vs CPU (the model phase's tolerance)
IOU_FLOPS = 22  # float operations of one IoU and its comparison
DEVICE = torch.device("cuda")  # the fusion phases' device


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median device time of one fn() call, from CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def self_device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def device_ms(fn, reps: int = 20, warmup: int = 3, kernel: str = KERNEL_NAME):
    """Mean device time per fn() call of the kernels whose name matches
    `kernel`, from torch.profiler (CUPTI); None if the profiler saw none."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(self_device_us(e) for e in prof.key_averages() if re.search(kernel, e.key))
    return us / reps / 1e3 if us > 0 else None


def host_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median wall time of one fn() call that ends on the host."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def make_scan(rng: np.random.Generator) -> np.ndarray:
    """A KITTI-like raw scan: ground, clutter and car-sized boxes of points,
    about 25k of them inside the front range."""
    n_ground, n_clutter = 22000, 5000
    ground = np.stack([
        rng.uniform(0, 55, n_ground), rng.uniform(-28, 28, n_ground),
        rng.normal(-1.73, 0.05, n_ground), rng.uniform(0, 0.4, n_ground),
    ], 1)
    clutter = np.stack([
        rng.uniform(-5, 55, n_clutter), rng.uniform(-28, 28, n_clutter),
        rng.uniform(-1.7, 1.2, n_clutter), rng.uniform(0, 1, n_clutter),
    ], 1)
    objects = []
    for _ in range(10):
        cx, cy = rng.uniform(5, 45), rng.uniform(-20, 20)
        n = 700
        objects.append(np.stack([
            cx + rng.uniform(-1.9, 1.9, n), cy + rng.uniform(-0.8, 0.8, n),
            rng.uniform(-1.7, -0.2, n), rng.uniform(0.2, 0.9, n),
        ], 1))
    return np.concatenate([ground, clutter, *objects]).astype(np.float32)


def make_edge_scan(rng: np.random.Generator, n: int) -> np.ndarray:
    """Points exactly on cell edges and one float32 ulp either side."""
    d = np.float32(cnf.DISCRETIZATION)

    def near_edges(k):
        v = (k * d).astype(np.float32)
        u = rng.random(len(k))
        v = np.where(u < 1 / 3, np.nextafter(v, np.float32(1e3)), v)
        return np.where(u > 2 / 3, np.nextafter(v, np.float32(-1e3)), v)

    x = near_edges(rng.integers(0, H + 1, n))
    y = near_edges(rng.integers(-W // 2, W // 2 + 1, n))
    z = rng.uniform(cnf.boundary["minZ"], cnf.boundary["maxZ"], n).astype(np.float32)
    z[: n // 50] = np.float32(cnf.boundary["minZ"])
    z[n // 50: n // 25] = np.float32(cnf.boundary["maxZ"])
    r = rng.uniform(0, 1, n).astype(np.float32)
    return np.stack([x, y, z, r], 1)


def bump_heatmap_bias(model: torch.nn.Module) -> None:
    with torch.no_grad():
        for i in range(3):
            getattr(model, f"fpn{i}_hm_cen")[2].bias += HM_BIAS_BUMP


def sorted_rows(dets):
    rows = np.asarray([[d["class_id"], d["x"], d["y"], d["z"], d["h"], d["w"],
                        d["l"], d["yaw"], d["score"]] for d in dets], np.float64)
    if len(rows) == 0:
        return rows.reshape(0, 9)
    return rows[np.lexsort((rows[:, 2], rows[:, 1], rows[:, 0]))]


def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; no GPU to run on",
              file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = {"name": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    emit({"phase": "device", **card, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return card


def phase_build(card):
    t0 = time.perf_counter()
    per_lib = _build.build_libraries()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": per_lib, "card": card["nvidia_smi"]})


def kernel_inputs(rng: np.random.Generator, raster_rows: int, count_rows: int):
    """The kernel phase's (B, N) int32 inputs, {name: (row, col, key)}; -1
    marks a dropped point in all three."""
    def drop(row, col, key, invalid):
        row, col, key = row.copy(), col.copy(), key.copy()
        row[invalid] = col[invalid] = key[invalid] = -1
        return row, col, key

    def keys():
        return rng.integers(0, 1 << 25, (B, N)).astype(np.int32)

    row = rng.integers(0, H, (B, N)).astype(np.int32)
    col = rng.integers(0, W, (B, N)).astype(np.int32)
    no_hot = drop(row, col, keys(), rng.random((B, N)) < 0.3)
    served = tuple(a.copy() for a in no_hot)
    served[0][3, :10000] = 123  # one cell hit 10,000 times
    served[1][3, :10000] = 456
    served[2][3, :10000] = rng.integers(0, 1 << 25, 10000)
    all_invalid = np.zeros((B, N), bool)
    all_invalid[5] = True
    edges = sorted({e for t in (raster_rows, count_rows) for m in range(t, H, t) for e in (m - 1, m)})
    one_band = 6 * raster_rows
    return {
        "served_hot_cell": served,
        "served_no_hot_cell": no_hot,
        "all_invalid_frame": drop(*served, all_invalid),
        "band_edges": (rng.choice(edges, (B, N)).astype(np.int32),
                       rng.integers(0, W, (B, N)).astype(np.int32), keys()),
        "one_band": (rng.integers(one_band, one_band + raster_rows, (B, N)).astype(np.int32),
                     rng.integers(0, W, (B, N)).astype(np.int32), keys()),
    }


def raster_errors(got, want):
    """Max |diff| per channel of two (B, 3, H, W) rasters; raises unless
    channels 0 and 1 are bit-exact and density is within DENSITY_TOL."""
    errs = [(got[:, c] - want[:, c]).abs().max().item() for c in range(3)]
    for c in (0, 1):
        if not torch.equal(got[:, c], want[:, c]):
            raise AssertionError(f"raster channel {c} is not bit-exact: max |diff| {errs[c]}")
    if errs[2] > DENSITY_TOL:
        raise AssertionError(f"raster density off by {errs[2]}")
    return errs


def phase_kernel(card):
    dev = torch.device("cuda")
    smem = shared_memory_limit(dev)
    raster_plan = tile_plan(B, H, W, RASTER_BYTES_PER_CELL, smem)
    count_plan = tile_plan(B, H, W, COUNT_BYTES_PER_CELL, smem)
    cases = kernel_inputs(np.random.default_rng(SEED), raster_plan[0], count_plan[0])
    # where the device time goes: no points at all (empty the band, write
    # it), every point dropped (adds the scan of `row`), the served input
    cases["no_points"] = tuple(np.zeros((B, 0), np.int32) for _ in range(3))
    cases["all_invalid"] = tuple(np.full((B, N), -1, np.int32) for _ in range(3))
    checks = {}
    for name, arrays in cases.items():
        row, col, key = (torch.from_numpy(a).to(dev) for a in arrays)
        counts, counts_plain = bev_cell_counts(row, col), bev_cell_counts_plain(row, col)
        raster, raster_plain = bev_raster_reduce(row, col, key), bev_raster_reduce_plain(row, col, key)
        torch.cuda.synchronize()
        if not torch.equal(counts, counts_plain):
            err = (counts - counts_plain).abs().max().item()
            raise AssertionError(f"bev_cell_counts disagrees with its plain version on {name}: {err}")
        checks[name] = {"raster_max_abs_err": raster_errors(raster, raster_plain),
                        "raster_bit_exact": torch.equal(raster, raster_plain)}
        if name == "served_hot_cell":
            cpu = [torch.from_numpy(a) for a in arrays]
            if not torch.equal(counts.cpu(), bev_cell_counts_plain(*cpu[:2])):
                raise AssertionError("bev_cell_counts on the card differs from the CPU plain version")
            raster_errors(raster.cpu(), bev_raster_reduce_plain(*cpu))
            if counts[3, 123, 456].item() < 10000:
                raise AssertionError("the hot cell lost counts")
        if name == "all_invalid_frame" and (counts[5].any() or raster[5].any()):
            raise AssertionError("an all-invalid frame left a mark")
    emit({"phase": "kernel", "shape": [B, N], "shared_memory_per_block": smem,
          "raster_plan": raster_plan, "count_plan": count_plan, "checks": checks,
          "card": card["nvidia_smi"]})

    recs = []
    for entry in ("bev_cell_counts", "bev_raster_reduce"):
        fn = bev_cell_counts if entry == "bev_cell_counts" else bev_raster_reduce
        timed = {}
        for name in ("served_hot_cell", "served_no_hot_cell", "one_band", "no_points", "all_invalid"):
            row, col, key = (torch.from_numpy(a).to(dev) for a in cases[name])
            args = (row, col) if entry == "bev_cell_counts" else (row, col, key)
            timed[name] = {"ms": cuda_ms(lambda: fn(*args)), "device_ms": device_ms(lambda: fn(*args))}
        row, col, key = (torch.from_numpy(a).to(dev) for a in cases["served_hot_cell"])
        ok = row >= 0
        n_valid = int(ok.sum().item())
        batch = torch.arange(B, device=dev)[:, None]
        flat = torch.where(ok, (batch * H + row) * W + col, B * H * W).reshape(-1)
        if entry == "bev_cell_counts":
            bytes_moved = 2 * row.numel() * 4 + B * H * W * 4
            ops = n_valid  # one count per point
            plain_ms = cuda_ms(lambda: bev_cell_counts_plain(row, col))
            library_ms = cuda_ms(lambda: torch.bincount(flat, minlength=B * H * W + 1))
        else:
            bytes_moved = 3 * row.numel() * 4 + B * 3 * H * W * 4
            ops = 2 * n_valid + 6 * B * H * W  # max + count per point, epilogue per cell
            cid = torch.where(ok, row.long() * W + col.long(), H * W)
            plain_ms = cuda_ms(lambda: bev_raster_reduce_plain(row, col, key))

            def library():  # the pair the reduce replaced, as a yardstick only
                torch.full((B, H * W + 1), -1, dtype=torch.int32, device=dev).scatter_reduce_(
                    1, cid, key, reduce="amax", include_self=True)
                torch.bincount(flat, minlength=B * H * W + 1)

            library_ms = cuda_ms(library)
        bound_bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
        bound_ops_ms = ops / FP32_OPS_PER_S * 1e3
        bound_ms = max(bound_bytes_ms, bound_ops_ms)
        dms = timed["served_hot_cell"]["device_ms"]
        recs.append({
            "name": entry,
            "route": "cuda",
            "source": "sfa3d_tpu_torch/csrc/bev_counts.cu",
            "replaces": "sfa3d_tpu/ops/bev_pallas.py:76",
            "launches": None,  # filled in from the path's run
            "max_abs_err": (max(max(c["raster_max_abs_err"]) for c in checks.values())
                            if entry == "bev_raster_reduce" else 0.0),  # counts: exact or raised
            "ms": timed["served_hot_cell"]["ms"],
            "device_ms": dms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
            "bound_share_device": bound_ms / dms if dms else None,
            "library_ms": library_ms,
            "ms_one_band": timed["one_band"]["ms"],
            "device_ms_one_band": timed["one_band"]["device_ms"],
            "device_ms_no_hot_cell": timed["served_no_hot_cell"]["device_ms"],
            "device_ms_no_points": timed["no_points"]["device_ms"],
            "device_ms_all_invalid": timed["all_invalid"]["device_ms"],
            "bytes": bytes_moved,
            "valid_points": n_valid,
        })
        emit({"phase": "kernel_time", **{k: v for k, v in recs[-1].items()
                                         if k not in ("route", "source", "replaces", "launches")},
              "card": card["nvidia_smi"]})
    return recs


def phase_raster(card):
    rng = np.random.default_rng(SEED + 1)
    padded = [bev_ops.filter_and_pad_points(make_scan(rng), N),
              bev_ops._pad_raw(make_edge_scan(rng, N), N)]
    pts = np.stack([p for p, _ in padded])
    valid = np.stack([v for _, v in padded])
    pts_c, valid_c = torch.from_numpy(pts), torch.from_numpy(valid)
    pts_g, valid_g = pts_c.cuda(), valid_c.cuda()

    idx_gpu = bev_ops.cell_indices_and_keys(pts_g, valid_g)
    idx_cpu = bev_ops.cell_indices_and_keys(pts_c, valid_c)
    in_range = int((idx_cpu[0][0] >= 0).sum().item())
    if in_range < 20000:
        raise AssertionError(f"raster scan has only {in_range} in-range points")
    gpu = bev_ops.points_to_bev(pts_g, valid_g).cpu()
    cpu = bev_ops.points_to_bev(pts_c, valid_c)
    for name, a, b in zip(("row", "col", "key"), idx_gpu, idx_cpu):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"raster {name} differs between GPU and CPU")
    counts_gpu = bev_cell_counts(idx_gpu[0], idx_gpu[1]).cpu()
    counts_cpu = bev_cell_counts_plain(idx_cpu[0], idx_cpu[1])
    if not torch.equal(counts_gpu, counts_cpu):
        raise AssertionError("raster counts differ between the kernel and the plain version")
    for c in (0, 1):
        if not torch.equal(gpu[..., c], cpu[..., c]):
            raise AssertionError(f"raster channel {c} is not bit-exact")
    density_err = (gpu[..., 2] - cpu[..., 2]).abs().max().item()
    if density_err > 1.2e-7:
        raise AssertionError(f"density channel off by {density_err}")
    emit({"phase": "raster", "in_range_points": in_range,
          "occupied_cells": int((cpu[..., 2] > 0).sum().item()),
          "max_count": float(counts_cpu.max().item()),
          "density_max_abs_err": density_err, "card": card["nvidia_smi"]})
    return pts, valid


def phase_model(card, pts, valid):
    cpu_model = create_model("fpn_resnet_18").init_weights(torch.Generator().manual_seed(SEED))
    bump_heatmap_bias(cpu_model)
    cpu_model.eval()
    gpu_model = copy.deepcopy(cpu_model).cuda()
    bev = bev_ops.points_to_bev(torch.from_numpy(pts[:1]), torch.from_numpy(valid[:1]))
    heads_cpu = forward_heads(cpu_model, bev)
    heads_gpu = forward_heads(gpu_model, bev.cuda())
    errs = {k: (heads_gpu[k].cpu() - heads_cpu[k]).abs().max().item() for k in heads_cpu}
    worst = max(errs.values())
    if not worst <= 1e-3:
        raise AssertionError(f"KFPN heads GPU vs CPU differ by {errs}")
    emit({"phase": "model", "bev": [1, H, W, 3], "max_abs_err": errs,
          "card": card["nvidia_smi"]})


def phase_serve(card):
    gpu_det = Detector(device="cuda", seed=SEED)
    cpu_det = Detector(device="cpu", seed=SEED)
    bump_heatmap_bias(gpu_det.model)
    bump_heatmap_bias(cpu_det.model)
    rng = np.random.default_rng(SEED + 2)
    scans = [make_scan(rng) for _ in range(16)]

    bev_raster_reduce.launches = 0  # count the main path's launches only
    bev_cell_counts.launches = 0
    server = BatchingDetectorServer(gpu_det, max_batch=8, max_delay_ms=20.0)
    replies = [None] * len(scans)
    t0 = time.perf_counter()
    try:
        server.warmup()
        t_traffic = time.perf_counter()

        def client(k):
            futs = [(i, server.submit(scans[i])) for i in range(k, len(scans), 4)]
            for i, fut in futs:
                replies[i] = fut.result(timeout=300)

        threads = [threading.Thread(target=client, args=(k,)) for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        if any(t.is_alive() for t in threads):
            raise AssertionError("a client thread did not finish")
        traffic_s = time.perf_counter() - t_traffic
    finally:
        server.stop()
    launches = bev_raster_reduce.launches
    count_launches = bev_cell_counts.launches
    stats = dict(server.stats)
    warm = len(server.buckets())
    if stats["served"] != len(scans) or any(r is None for r in replies):
        raise AssertionError(f"server answered {stats['served']} of {len(scans)} requests")
    if launches != stats["batches"] + warm or launches == 0:
        raise AssertionError(
            f"raster kernel launched {launches} times for {stats['batches']} batches + {warm} warmups"
        )

    n_dets, worst = [], 0.0
    for scan, got in zip(scans, replies):
        want = cpu_det.detect(scan)
        a, b = sorted_rows(got), sorted_rows(want)
        if len(a) != len(b):
            raise AssertionError(f"GPU reply has {len(a)} detections, CPU {len(b)}")
        if len(a):
            worst = max(worst, float(np.abs(a - b).max()))
        n_dets.append(len(a))
    if worst > 1e-3 or sum(n_dets) == 0:
        raise AssertionError(f"served detections vs CPU: max |diff| {worst}, counts {n_dets}")

    lat = {}
    for bucket in (1, 8):
        p = np.zeros((bucket, N, 4), np.float32)
        v = np.zeros((bucket, N), bool)
        for i in range(bucket):
            p[i], v[i] = bev_ops.filter_and_pad_points(scans[i])
        lat[bucket] = host_ms(lambda: gpu_det.detect_batch(p, v))

    # per-stage device time of one bucket-8 batch; the raster split into
    # its elementwise prelude and the reduce kernel
    pts_d, valid_d = torch.from_numpy(p).cuda(), torch.from_numpy(v).cuda()
    with torch.inference_mode():
        bev = bev_ops.points_to_bev_nchw(pts_d, valid_d)
        idx = bev_ops.cell_indices_and_keys(pts_d, valid_d)
        heads = {k: t.permute(0, 2, 3, 1) for k, t in gpu_det.model(bev).items()}
        stages = {
            "raster_ms": cuda_ms(lambda: bev_ops.points_to_bev_nchw(pts_d, valid_d)),
            "prelude_ms": cuda_ms(lambda: bev_ops.cell_indices_and_keys(pts_d, valid_d)),
            "reduce_ms": cuda_ms(lambda: bev_raster_reduce(*idx)),
            "reduce_device_ms": device_ms(lambda: bev_raster_reduce(*idx)),
            "model_ms": cuda_ms(lambda: gpu_det.model(bev)),
            "decode_ms": cuda_ms(lambda: _decode_heads(heads, 50, 0.2)),
        }
    emit({"phase": "serve", "requests": len(scans), "threads": 4, "stats": stats,
          "warmup_batches": warm, "raster_kernel_launches": launches,
          "count_kernel_launches": count_launches,
          "detections_per_reply": n_dets, "max_abs_err_vs_cpu": worst,
          "traffic_seconds": traffic_s, "serve_seconds_with_warmup": time.perf_counter() - t0,
          "batch_ms_bucket1": lat[1], "batch_ms_bucket8": lat[8],
          "frames_per_s_bucket8": 8 / (lat[8] / 1e3), "stages_bucket8": stages,
          "card": card["nvidia_smi"]})
    return scans, launches, count_launches


def phase_counts(card, scans):
    """The count map of the served scans through the public op, two batches
    of 8: cell_indices_and_keys -> bev_cell_counts. Held against the
    in-range points of each frame and the served raster's density."""
    dev = torch.device("cuda")
    inv_log64 = float(np.float32(1.0 / np.log(64.0)))
    batches = []
    for k in range(0, len(scans), B):
        padded = [bev_ops.filter_and_pad_points(s, N) for s in scans[k:k + B]]
        batches.append((torch.from_numpy(np.stack([q for q, _ in padded])).to(dev),
                        torch.from_numpy(np.stack([m for _, m in padded])).to(dev)))
    with torch.inference_mode():
        idx = [bev_ops.cell_indices_and_keys(q, m) for q, m in batches]
        rasters = [bev_ops.points_to_bev_nchw(q, m) for q, m in batches]
        bev_cell_counts.launches = 0  # count this path's launches only
        counts = [bev_cell_counts(row, col) for row, col, _ in idx]
        launches = bev_cell_counts.launches
    worst = 0.0
    for (row, _, _), c, r in zip(idx, counts, rasters):
        if not torch.equal(c.sum((1, 2)), (row >= 0).sum(1).float()):
            raise AssertionError("a frame's counts do not sum to its in-range points")
        density = torch.clamp_max(torch.log(torch.clamp_max(c, 63.0) + 1.0) * inv_log64, 1.0)
        worst = max(worst, (density - r[:, 2]).abs().max().item())
    if worst > DENSITY_TOL:
        raise AssertionError(f"count map vs served density: max |diff| {worst}")
    if launches != len(batches):
        raise AssertionError(f"count kernel launched {launches} times for {len(batches)} batches")
    emit({"phase": "counts", "frames": len(scans), "count_kernel_launches": launches,
          "density_max_abs_err_vs_raster": worst, "card": card["nvidia_smi"]})
    return launches


# ---------------------------------------------------------------------------
# the fusion path
# ---------------------------------------------------------------------------

LOOP_B = 8  # frames per batch in the fusion_kernels phase: the served bucket
LOOP_ENTRIES = {  # entry -> (design at the served shape, its kernel symbol, TPU-side function)
    "hard_nms_keep": ("suppression bitmask, one-warp scan", "hard_nms_keep_kernel",
                      "sfa3d_tpu/fusion/nms.py:33"),
    "soft_nms_gaussian": ("decay matrix, one-warp argmax chain", "soft_nms_matrix_kernel",
                          "sfa3d_tpu/fusion/nms.py:54"),
    "greedy_match": ("candidate keys, one-warp chain over candidate rows", "greedy_match_kernel",
                     "sfa3d_tpu/fusion/fuse.py:64"),
}
SOFT_BLOCK_KERNEL = "soft_nms_block_kernel"  # soft-NMS above soft_nms_matrix_slots
MATCH_BLOCK_KERNEL = "greedy_match_block_kernel"  # the match above greedy_match_matrix_rows
MATCH_KS_CAP = 256  # Ks of the inputs on either side of the match's design switch
NO_LIBRARY = ("none: no single PyTorch call computes it (torchvision is absent, and its "
              "NMS keeps other rules)")


def loop_boxes(rng, b, k, grid=False):
    """(b, k, 4) xywh boxes; `grid` puts them on a coarse grid (many
    overlaps and exactly tied IoUs)."""
    if grid:
        xy = rng.integers(0, 10, (b, k, 2)).astype(np.float32) * 12
    else:
        xy = rng.uniform(0, 600, (b, k, 2)).astype(np.float32)
    return np.concatenate([xy, rng.uniform(4, 120, (b, k, 2)).astype(np.float32)], -1)


def loop_inputs(rng, matrix_slots, match_rows):
    """The fusion_kernels phase's inputs: {name: (boxes, scores, valid)} for
    the two NMS entries and {name: (yolo, yolo_valid, sfa, sfa_valid,
    threshold)} for the match. The served shapes: 256 YOLO candidates (hard
    NMS), 114 fused slots (soft-NMS), 64 YOLO x 50 SFA boxes (the match).
    K = 1, 33 and 1024 test the hard-NMS words at their edges; K =
    matrix_slots and matrix_slots + 1 run the two soft-NMS designs on either
    side of the choice (K = 1024 runs the block design too); Ky = match_rows
    and match_rows + 1 at Ks = MATCH_KS_CAP do the same for the match."""
    def scored(k, grid=False):
        return (loop_boxes(rng, LOOP_B, k, grid), rng.uniform(0, 1, (LOOP_B, k)).astype(np.float32),
                rng.random((LOOP_B, k)) < 0.8)

    def class_offset(k):  # the YOLO NMS: class-offset boxes, scores sorted
        bx, sc, v = scored(k, grid=True)
        bx[..., :2] += rng.integers(0, 80, (LOOP_B, k, 1)).astype(np.float32) * 4096.0
        return bx, np.sort(sc, 1)[:, ::-1].copy(), v

    nms_cases = {"random": scored(114)}
    bx, sc, v = scored(114)
    v[[2, 5]] = False
    nms_cases["all_invalid_frames"] = (bx, sc, v)
    bx, sc, v = scored(114, grid=True)
    sc[:] = 0.5
    nms_cases["equal_scores"] = (bx, sc, v)
    bx, sc, v = scored(114, grid=True)
    bx[:, 1::2] = bx[:, ::2]  # duplicates: IoU exactly 1
    nms_cases["duplicates"] = (bx, sc, v)
    nms_cases["class_offset_256"] = class_offset(256)

    def matched(ky, ks, grid=False):
        yolo = loop_boxes(rng, LOOP_B, ky, grid)
        sfa = yolo[:, :ks] + rng.normal(0, 4, (LOOP_B, ks, 4)).astype(np.float32)
        return yolo, rng.random((LOOP_B, ky)) < 0.8, sfa, rng.random((LOOP_B, ks)) < 0.8, 0.5

    match_cases = {"served_64x50": matched(64, 50)}
    y, yv, sf, sv, thr = matched(64, 50)
    yv[3] = False
    sv[[3, 6]] = False
    match_cases["all_invalid_frames"] = (y, yv, sf, sv, thr)
    y, yv, sf, sv, thr = matched(64, 50, grid=True)
    sf[:, 1::2] = sf[:, ::2]  # tied IoUs: the lowest index wins
    match_cases["ties"] = (y, yv, sf, sv, thr)
    match_cases["wide_256x256"] = matched(256, 256, grid=True)
    # drawn last, so that the inputs above stay as they were before these
    nms_cases["k1"] = scored(1)
    nms_cases["k33_grid"] = scored(33, grid=True)
    nms_cases["class_offset_1024"] = class_offset(1024)
    nms_cases[f"matrix_limit_{matrix_slots}"] = scored(matrix_slots, grid=True)
    nms_cases[f"block_{matrix_slots + 1}"] = scored(matrix_slots + 1, grid=True)
    # soft-NMS's score keys: -0 ties +0, negative scores order below them
    bx, sc, v = scored(114, grid=True)
    sc[:4] = rng.choice(np.float32([0.0, 0.25, 0.5]), (4, 114))
    sc[4:] = rng.choice(np.float32([-0.5, -0.0, 0.0, 0.25, 0.5]), (LOOP_B - 4, 114))
    nms_cases["zero_and_signed_scores"] = (bx, sc, v)
    # each box overlaps the next (IoU 7/13) but not the one after: every
    # other box survives hard NMS, two slots of a word decided in one step
    x = np.arange(70, dtype=np.float32) * 3
    chain = np.stack([x, np.zeros(70), np.full(70, 10), np.full(70, 10)], -1).astype(np.float32)
    nms_cases["chain_70"] = (np.repeat(chain[None], LOOP_B, 0), np.repeat(
        np.linspace(1, 0.5, 70, dtype=np.float32)[None], LOOP_B, 0), np.ones((LOOP_B, 70), bool))
    # the match's chain walks only the rows with a candidate: every row has
    # one (grid boxes, each YOLO box half a pixel off an SFA box, 64 rows
    # for 50 boxes), a frame has none, or threshold 0 meets touching boxes
    sf = loop_boxes(rng, LOOP_B, 50, grid=True)
    y = np.ascontiguousarray(sf[:, np.arange(64) % 50]) + np.float32(0.5)
    match_cases["every_row_candidate_64x50"] = (y, np.ones((LOOP_B, 64), bool), sf,
                                                np.ones((LOOP_B, 50), bool), 0.5)
    y, yv, sf, sv, thr = matched(64, 50)
    sf[3, :, 0] += np.float32(5000.0)
    match_cases["no_candidate_frame"] = (y, yv, sf, sv, thr)
    y, yv, sf, sv, _ = matched(64, 50)
    sf[:, :25, 0] = y[:, :25, 0] + y[:, :25, 2]  # left edge on the YOLO box's right edge
    sf[:, :25, 1] = y[:, :25, 1]
    match_cases["touching_thr0"] = (y, yv, sf, sv, 0.0)
    for name, ky in ((f"matrix_limit_{match_rows}x{MATCH_KS_CAP}", match_rows),
                     (f"block_{match_rows + 1}x{MATCH_KS_CAP}", match_rows + 1)):
        sf = loop_boxes(rng, LOOP_B, MATCH_KS_CAP, grid=True)
        y = np.ascontiguousarray(sf[:, rng.integers(0, MATCH_KS_CAP, ky)])
        y += rng.normal(0, 4, (LOOP_B, ky, 4)).astype(np.float32)
        match_cases[name] = (y, rng.random((LOOP_B, ky)) < 0.8, sf, rng.random((LOOP_B, MATCH_KS_CAP)) < 0.8, 0.5)
    return nms_cases, match_cases


def loop_bound(bytes_moved, n_iou):
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = n_iou * IOU_FLOPS / FP32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def max_abs_err(got, want) -> float:
    """Largest |difference| over the outputs of a loop entry and its plain
    version (masks and indices compare as integers)."""
    pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
    return max(float((g.double() - w.double()).abs().max().item()) for g, w in pairs)


def sorted_candidates(boxes, scores, valid):
    """Boxes and valid flags in stable descending score order, as hard NMS
    takes them."""
    order = _stable_desc_order(scores, valid)
    sboxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4)).contiguous()
    return sboxes, torch.gather(valid, 1, order).contiguous()


def dependent_steps(valid) -> int:
    return int(valid.sum(1).max().item())


def match_rows_limit(dev) -> int:
    """greedy_match_matrix_rows at Ks = MATCH_KS_CAP on the card."""
    return fusion_loops.greedy_match_matrix_rows(MATCH_KS_CAP, shared_memory_limit(dev))


def phase_fusion_kernels(card):
    """Each loop entry vs its plain version on the card, bit for bit; times
    at the served shapes, and of both designs of soft-NMS and of the match
    where the wrapper switches. Returns the three kernel records (launches
    filled in later)."""
    dev = DEVICE
    smem = shared_memory_limit(dev)
    matrix_slots = fusion_loops.soft_nms_matrix_slots(smem)
    nms_cases, match_cases = loop_inputs(np.random.default_rng(SEED + 5), matrix_slots, match_rows_limit(dev))
    checks = {}
    for name, arrays in nms_cases.items():
        boxes, scores, valid = (torch.from_numpy(a).to(dev) for a in arrays)
        sboxes, svalid = sorted_candidates(boxes, scores, valid)
        keep = fusion_loops.hard_nms_keep(sboxes, svalid, 0.45)
        keep_plain = fusion_loops.hard_nms_keep_plain(sboxes, svalid, 0.45)
        out, surv = fusion_loops.soft_nms_gaussian(boxes, scores, valid)
        out_plain, surv_plain = fusion_loops.soft_nms_gaussian_plain(boxes, scores, valid)
        torch.cuda.synchronize()
        if not torch.equal(keep, keep_plain):
            raise AssertionError(f"hard_nms_keep disagrees with its plain version on {name}")
        if not torch.equal(surv, surv_plain):
            raise AssertionError(f"soft_nms_gaussian's mask disagrees with its plain version on {name}")
        if not torch.equal(out, out_plain):
            err = max_abs_err(out, out_plain)
            raise AssertionError(f"soft_nms_gaussian's scores differ from its plain version by {err} on {name}")
        if name == "all_invalid_frames" and (keep[[2, 5]].any() or surv[[2, 5]].any()):
            raise AssertionError("an all-invalid frame kept a box")
        k = boxes.shape[1]
        checks[name] = {"shape": list(boxes.shape[:2]), "kept": int(keep.sum().item()),
                        "suppressed": int((svalid & ~keep).sum().item()),
                        "soft_survivors": int(surv.sum().item()),
                        "soft_design": "decay matrix" if k <= matrix_slots else "block"}
    for name, (*arrays, thr) in match_cases.items():
        y, yv, sf, sv = (torch.from_numpy(a).to(dev) for a in arrays)
        idx_plain, m_plain = fusion_loops.greedy_match_plain(y, yv, sf, sv, thr)
        # the wrapper's design for the shape, then the block design on the same input
        for got in (fusion_loops.greedy_match(y, yv, sf, sv, thr), match_block_direct(y, yv, sf, sv, thr)):
            torch.cuda.synchronize()
            if not (torch.equal(got[0], idx_plain) and torch.equal(got[1], m_plain)):
                raise AssertionError(f"greedy_match disagrees with its plain version on {name}")
        ky, ks = yv.shape[1], sv.shape[1]
        checks[f"match_{name}"] = {
            "shape": [list(y.shape[:2]), list(sf.shape[:2])], "threshold": thr,
            "matches": int((idx_plain >= 0).sum().item()),
            "candidate_rows_per_frame": fusion_loops.greedy_match_candidate_rows(y, yv, sf, sv, thr).tolist(),
            "valid_rows_per_frame": yv.sum(1).tolist(),
            "design": "key matrix" if ky <= fusion_loops.greedy_match_matrix_rows(ks, smem) else "block"}
    if checks["match_served_64x50"]["matches"] == 0 or checks["class_offset_256"]["suppressed"] == 0:
        raise AssertionError("the served-shape inputs exercised nothing")
    if min(checks["match_every_row_candidate_64x50"]["candidate_rows_per_frame"]) != 64:
        raise AssertionError("the every-row-candidate input has a row with no candidate")
    if checks["match_no_candidate_frame"]["candidate_rows_per_frame"][3] != 0:
        raise AssertionError("the no-candidate frame has a candidate")
    if [c["design"] for n, c in checks.items() if n.startswith(("match_matrix_limit", "match_block_"))] != [
            "key matrix", "block"]:
        raise AssertionError("the match inputs beside the switch do not take both designs")
    if checks["class_offset_1024"]["suppressed"] == 0:
        raise AssertionError("the K = 1024 input suppressed nothing")
    if checks["chain_70"]["kept"] != LOOP_B * 35:
        raise AssertionError(f"the chain kept {checks['chain_70']['kept']} boxes, not every other one")
    emit({"phase": "fusion_kernels", "soft_nms_matrix_slots": matrix_slots, "checks": checks,
          "card": card["nvidia_smi"]})

    # times at the served shapes
    boxes, scores, valid = (torch.from_numpy(a).to(dev) for a in nms_cases["class_offset_256"])
    sboxes, svalid = sorted_candidates(boxes, scores, valid)
    wboxes, wvalid = sorted_candidates(*(torch.from_numpy(a).to(dev)
                                         for a in nms_cases["class_offset_1024"]))
    fboxes, fscores, fvalid = (torch.from_numpy(a).to(dev) for a in nms_cases["random"])
    y, yv, sf, sv = (torch.from_numpy(a).to(dev) for a in match_cases["served_64x50"][:4])
    keep = fusion_loops.hard_nms_keep_plain(sboxes, svalid, 0.45)
    kept_before = torch.cumsum(keep.int(), 1) - keep.int()
    calls = {
        # (call, plain call, bytes in + out, IoUs the data needs, steps)
        "hard_nms_keep": (
            lambda: fusion_loops.hard_nms_keep(sboxes, svalid, 0.45),
            lambda: fusion_loops.hard_nms_keep_plain(sboxes, svalid, 0.45),
            sboxes.numel() * 4 + 2 * svalid.numel(),
            int((kept_before * svalid).sum().item()), dependent_steps(svalid)),
        "soft_nms_gaussian": (
            lambda: fusion_loops.soft_nms_gaussian(fboxes, fscores, fvalid),
            lambda: fusion_loops.soft_nms_gaussian_plain(fboxes, fscores, fvalid),
            fboxes.numel() * 4 + fscores.numel() * 4 * 2 + 2 * fvalid.numel(),
            int((fvalid.sum(1) * (fvalid.sum(1) - 1) // 2).sum().item()), dependent_steps(fvalid)),
        "greedy_match": (  # the chain: the candidate rows of a frame
            lambda: fusion_loops.greedy_match(y, yv, sf, sv, 0.5),
            lambda: fusion_loops.greedy_match_plain(y, yv, sf, sv, 0.5),
            (y.numel() + sf.numel()) * 4 + yv.numel() * 5 + sv.numel() * 2,
            int((yv.sum(1) * sv.sum(1)).sum().item()),
            int(fusion_loops.greedy_match_candidate_rows(y, yv, sf, sv, 0.5).max().item())),
    }
    recs = []
    for entry, (call, plain, bytes_moved, n_iou, steps) in calls.items():
        design, symbol, replaces = LOOP_ENTRIES[entry]
        bound_ms, bound_by = loop_bound(bytes_moved, n_iou)
        dms = device_ms(call, kernel=symbol)
        if dms is None:
            raise AssertionError(f"the profiler saw no {symbol} launch for {entry}")
        rec = {
            "name": entry, "route": "cuda", "source": "sfa3d_tpu_torch/csrc/fusion_loops.cu",
            "replaces": replaces, "launches": None,
            "max_abs_err": max_abs_err(call(), plain()),
            "ms": cuda_ms(call), "device_ms": dms, "plain_ms": cuda_ms(plain, reps=5, warmup=1),
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "library": NO_LIBRARY, "bound_share_device": bound_ms / dms,
            "design": design, "per_step_us": dms * 1e3 / steps,
            "shape": list(sboxes.shape[:2]) if entry == "hard_nms_keep" else
            list(fboxes.shape[:2]) if entry == "soft_nms_gaussian" else [[LOOP_B, 64], [LOOP_B, 50]],
            "dependent_steps": steps, "ious_needed": n_iou, "bytes": bytes_moved,
        }
        if entry == "hard_nms_keep":
            rec["device_ms_k1024"] = device_ms(
                lambda: fusion_loops.hard_nms_keep(wboxes, wvalid, 0.45), kernel=symbol)
        if entry == "soft_nms_gaussian":
            # the block design at the served shape, where the decay matrix replaced it
            block = lambda: soft_nms_block_direct(fboxes, fscores, fvalid)  # noqa: E731
            if max_abs_err(block(), plain()) != 0:
                raise AssertionError("soft_nms_block_kernel at the served shape differs from the plain version")
            rec["replaced_design_device_ms"] = device_ms(block, kernel=SOFT_BLOCK_KERNEL)
            if rec["replaced_design_device_ms"] is None:
                raise AssertionError(f"the profiler saw no {SOFT_BLOCK_KERNEL} launch")
            rec["designs_at_the_switch"] = soft_nms_switch_times(nms_cases, matrix_slots)
        if entry == "greedy_match":
            # the block design at the served shape, where the key matrix replaced it
            block = lambda: match_block_direct(y, yv, sf, sv, 0.5)  # noqa: E731
            if max_abs_err(block(), plain()) != 0:
                raise AssertionError("greedy_match_block_kernel at the served shape differs from the plain version")
            rec["replaced_design_device_ms"] = device_ms(block, kernel=MATCH_BLOCK_KERNEL)
            if rec["replaced_design_device_ms"] is None:
                raise AssertionError(f"the profiler saw no {MATCH_BLOCK_KERNEL} launch")
            rec["valid_rows"] = dependent_steps(yv)
            rec["designs_at_the_switch"] = match_switch_times(match_cases)
        recs.append(rec)
        emit({"phase": "fusion_kernel_time", **{k: v for k, v in rec.items()
                                                 if k not in ("route", "source", "launches")},
              "card": card["nvidia_smi"]})
    return recs


def soft_nms_block_direct(boxes, scores, valid, sigma=0.5, score_thresh=0.001):
    """soft_nms_block_kernel at any K, past the wrapper's choice by K, to
    time it where the wrapper takes the matrix design. Counts no launch.
    Returns (scores, surviving mask)."""
    b, k = valid.shape
    lib, dev = fusion_loops._cuda_launch_setup("soft_nms_gaussian", k, (boxes, scores, valid))
    out, surv = scores.new_empty((b, k)), valid.new_empty((b, k))
    err = lib.soft_nms_gaussian_block_cuda(
        boxes.data_ptr(), scores.data_ptr(), valid.data_ptr(), out.data_ptr(), surv.data_ptr(),
        b, k, fusion_loops.inv_sigma(sigma), score_thresh, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"soft_nms_block_kernel launch failed: cudaError {err}")
    return out, surv


def match_block_direct(yolo, yolo_valid, sfa, sfa_valid, thr):
    """greedy_match_block_kernel at any shape, past the wrapper's choice, to
    check and time it where the wrapper takes the key matrix. Counts no
    launch. Returns (match_idx, sfa_matched)."""
    b, ky = yolo_valid.shape
    ks = sfa_valid.shape[1]
    lib, dev = fusion_loops._cuda_launch_setup("greedy_match", max(ky, ks), (yolo, yolo_valid, sfa, sfa_valid))
    idx, matched = yolo_valid.new_empty((b, ky), dtype=torch.int32), sfa_valid.new_empty((b, ks))
    err = lib.greedy_match_block_cuda(
        yolo.data_ptr(), yolo_valid.data_ptr(), sfa.data_ptr(), sfa_valid.data_ptr(), idx.data_ptr(),
        matched.data_ptr(), b, ky, ks, thr, dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"greedy_match_block_kernel launch failed: cudaError {err}")
    return idx, matched


def match_switch_times(match_cases):
    """Device time of the match's two designs on either side of the Ky where
    the wrapper switches (Ks = MATCH_KS_CAP), and of the key matrix where
    every row is a candidate; fails unless each ran its own design."""
    out = {}
    for name, arrays in match_cases.items():
        if not name.startswith(("matrix_limit", "block_", "every_row")):
            continue
        symbol = MATCH_BLOCK_KERNEL if name.startswith("block_") else LOOP_ENTRIES["greedy_match"][1]
        y, yv, sf, sv = (torch.from_numpy(a).to(DEVICE) for a in arrays[:4])
        dms = device_ms(lambda: fusion_loops.greedy_match(y, yv, sf, sv, arrays[4]), kernel=symbol)
        if dms is None:
            raise AssertionError(f"greedy_match at {tuple(yv.shape)} x {sv.shape[1]} launched no {symbol}")
        steps = int(fusion_loops.greedy_match_candidate_rows(y, yv, sf, sv, arrays[4]).max().item())
        out[name] = {"kernel": symbol, "shape": [list(yv.shape), list(sv.shape)], "device_ms": dms,
                     "candidate_rows": steps, "valid_rows": dependent_steps(yv)}
    return out


def soft_nms_switch_times(nms_cases, matrix_slots):
    """Device time of the two soft-NMS designs on either side of the K where
    the wrapper switches; fails unless each K ran its own design's kernel."""
    out = {}
    for name, symbol in ((f"matrix_limit_{matrix_slots}", LOOP_ENTRIES["soft_nms_gaussian"][1]),
                         (f"block_{matrix_slots + 1}", SOFT_BLOCK_KERNEL)):
        boxes, scores, valid = (torch.from_numpy(a).to(DEVICE) for a in nms_cases[name])
        dms = device_ms(lambda: fusion_loops.soft_nms_gaussian(boxes, scores, valid), kernel=symbol)
        if dms is None:
            raise AssertionError(f"soft_nms_gaussian at K = {boxes.shape[1]} launched no {symbol}")
        out[name] = {"kernel": symbol, "shape": list(boxes.shape[:2]), "device_ms": dms,
                     "per_step_us": dms * 1e3 / dependent_steps(valid)}
    return out


def phase_yolo(card):
    cpu_model = YOLOv8("n").init_weights(torch.Generator().manual_seed(SEED + 1)).eval()
    gpu_model = copy.deepcopy(cpu_model).to(DEVICE)
    image = np.random.default_rng(SEED + 3).integers(0, 256, (*IMG_HW, 3)).astype(np.uint8)
    img = torch.from_numpy(letterbox(image, CANVAS)[0][None])
    with torch.inference_mode():
        cpu = forward_levels(cpu_model, img)
        gpu = forward_levels(gpu_model, img.to(DEVICE))
    errs = [[(g.cpu() - c).abs().max().item() for g, c in zip(gl, cl)] for gl, cl in zip(gpu, cpu)]
    worst = max(max(e) for e in errs)
    if not worst <= NET_TOL:
        raise AssertionError(f"YOLOv8n heads GPU vs CPU differ by {errs}")
    emit({"phase": "yolo", "canvas": [1, *CANVAS, 3], "levels": [list(l[0].shape) for l in gpu],
          "max_abs_err_box_cls_per_level": errs,
          "max_abs_out_box_cls_per_level": [[t.abs().max().item() for t in lv] for lv in cpu],
          "card": card["nvidia_smi"]})


YOLO_GATE_TOP = 150  # YOLO anchors of the reference frame above the 0.25 gate
SFA_HEIGHT_BUMP = 38.5  # m added to the KFPN's height bias: 3D boxes about 40 m high
SFA_Z_BUMP = -17.3  # m added to its z bias: their bottoms about 20 m below the sensor
YOLO_REACH = {1: 8, 3: 15}  # DFL side (1 top, 3 bottom) -> the bin, in strides, that takes its mass
YOLO_REACH_BUMP = 8.0  # added to that bin's logit
MIN_FUSED_PER_FRAME = 1  # fused (source 2) rows the 16 replies must hold, per frame


def yolo_gate_bias(yolo: torch.nn.Module, image: np.ndarray) -> float:
    """The class-conv bias that puts the YOLO_GATE_TOP-th best anchor of
    `image` just above the 0.25 gate, once the class logits are spread by
    x1000 (see bump_fused_biases)."""
    probe = copy.deepcopy(yolo).cpu()
    with torch.no_grad():
        for i in range(3):
            probe.model[22].cv3[i][2].weight *= 1000.0
            probe.model[22].cv3[i][2].bias.zero_()
        levels = forward_levels(probe, torch.from_numpy(letterbox(image, CANVAS)[0][None]))
    best = torch.cat([c.reshape(-1, c.shape[-1]) for _, c in levels]).amax(-1).double()
    top = torch.topk(best, YOLO_GATE_TOP + 1).values
    return float(np.log(0.25 / 0.75) - (top[-2] + top[-1]).item() / 2)


def bump_fused_biases(fd, gate_bias: float) -> None:
    """Random weights that give the fusion stages work: heatmap peaks above
    the threshold, and YOLO boxes of about four strides across (DFL mass on
    bin 2). The YOLO class logits are spread (x1000 on the last class conv,
    bias `gate_bias`) so that some tens of boxes a frame pass the 0.25 gate
    with confidences well apart: random features alone give thousands of
    nearly equal confidences, whose order float32 noise decides.

    Random networks place the two sides' boxes independently, so a pair
    rarely overlaps by the 0.7 IoU the match needs. So the 3D boxes, about
    1.5 m wide and long, are made 40 m high with their bottoms 20 m below
    the sensor: each projects across the whole image height at every range
    of the raster. The YOLO boxes (stride 8, where the gated ones lie) reach
    8 strides up and 15 down: many cover most of the image height, and none
    spans all of it, since two boxes clipped to the same edges give fused
    means of equal integers, which a one-ulp difference in a confidence
    truncates a pixel apart. Such pairs overlap mostly by their x-intervals,
    and a fair share pass 0.7."""
    bump_heatmap_bias(fd.kfpn)
    with torch.no_grad():
        for i in range(3):
            getattr(fd.kfpn, f"fpn{i}_dim")[2].bias += 1.5
            getattr(fd.kfpn, f"fpn{i}_dim")[2].bias[0] += SFA_HEIGHT_BUMP
            getattr(fd.kfpn, f"fpn{i}_z_coor")[2].bias += SFA_Z_BUMP
            dfl = fd.yolo.model[22].cv2[i][2].bias.view(4, 16)
            dfl[:, 2] += 4.0
            for side, reach in YOLO_REACH.items():
                dfl[side, reach] += YOLO_REACH_BUMP
            fd.yolo.model[22].cv3[i][2].weight *= 1000.0
            fd.yolo.model[22].cv3[i][2].bias.fill_(gate_bias)


def fused_requests(n):
    rng = np.random.default_rng(SEED + 4)
    calib = KittiCalibration(None)
    return [(make_scan(rng), rng.integers(0, 256, (*IMG_HW, 3)).astype(np.uint8), calib)
            for _ in range(n)]


def reply_rows(reply) -> np.ndarray:
    """A fused reply as rows [x, y, w, h, class, source, score], sorted: the
    order of the slots follows confidences that the two devices may rank
    differently where they are nearly tied, so replies compare as sets."""
    rows = np.concatenate([reply["boxes"].astype(np.float64),
                           reply["classes"][:, None].astype(np.float64),
                           reply["source"][:, None].astype(np.float64),
                           reply["scores"][:, None].astype(np.float64)], axis=1)
    return rows[np.lexsort(rows.T[::-1])]


def replies_equal(a, b) -> bool:
    ra, rb = reply_rows(a), reply_rows(b)
    if ra.shape != rb.shape or not np.array_equal(ra[:, :6], rb[:, :6]):
        return False
    return bool(np.abs(ra[:, 6] - rb[:, 6]).max(initial=0.0) <= SCORE_TOL)


def reply_difference(a, b):
    """What differs between two fused replies (for the failure message)."""
    ra, rb = reply_rows(a), reply_rows(b)
    out = {"rows": [len(ra), len(rb)], "boxes_3d": [len(a["boxes_3d"]), len(b["boxes_3d"])]}
    if ra.shape == rb.shape:
        off = np.flatnonzero((ra[:, :6] != rb[:, :6]).any(1) | (np.abs(ra[:, 6] - rb[:, 6]) > SCORE_TOL))
        out["differing"] = off[:5].tolist()
        out["gpu"] = ra[off[:5]].tolist()
        out["cpu"] = rb[off[:5]].tolist()
    return out


def _on_host(out):
    """A network's output (KFPN: dict of heads; YOLO: list of (box, cls)
    levels), copied to the host."""
    if isinstance(out, dict):
        return {k: v.cpu() for k, v in out.items()}
    return [tuple(t.cpu() for t in level) for level in out]


def _row(out, r: int):
    if isinstance(out, dict):
        return {k: v[r:r + 1] for k, v in out.items()}
    return [tuple(t[r:r + 1] for t in level) for level in out]


def _leaves(out):
    return list(out.values()) if isinstance(out, dict) else [t for level in out for t in level]


def record_networks(fd, calls):
    """Forward hooks that append (input, output) of every call of fd's two
    networks to calls["kfpn"] / calls["yolo"], on the host."""
    def hook(name):
        def fn(module, args, out):
            calls[name].append((args[0].cpu(), _on_host(out)))
        return fn
    return [fd.kfpn.register_forward_hook(hook("kfpn")), fd.yolo.register_forward_hook(hook("yolo"))]


def served_networks(calls, image: np.ndarray):
    """The two networks' outputs for one served frame, found by its
    letterboxed image among the recorded batches (the KFPN and YOLO calls
    of one batch pair up in order)."""
    want = torch.from_numpy(image).permute(2, 0, 1)
    for (yin, yout), (_, kout) in zip(calls["yolo"], calls["kfpn"]):
        for r in range(yin.shape[0]):
            if torch.equal(yin[r], want):
                return {"kfpn": _row(kout, r), "yolo": _row(yout, r)}
    raise AssertionError("a served frame is missing from the recorded batches")


def replay_networks(fd, given, errs):
    """Forward hooks that make fd's networks return the `given` outputs in
    place of their own, and append max |own - given| to errs."""
    def hook(name):
        def fn(module, args, own):
            errs.append(max((a - b).abs().max().item()
                            for a, b in zip(_leaves(own), _leaves(given[name]))))
            return given[name]
        return fn
    return [fd.kfpn.register_forward_hook(hook("kfpn")), fd.yolo.register_forward_hook(hook("yolo"))]


def phase_fused_serve(card):
    gpu_fd = FusedDetector(imgsz=CANVAS, device=DEVICE, seed=SEED)
    cpu_fd = FusedDetector(imgsz=CANVAS, device="cpu", seed=SEED)
    reqs = fused_requests(16)
    gate_bias = yolo_gate_bias(cpu_fd.yolo, reqs[0][1])
    bump_fused_biases(gpu_fd, gate_bias)
    bump_fused_biases(cpu_fd, gate_bias)

    counted = [bev_raster_reduce, bev_cell_counts, fusion_loops.hard_nms_keep,
               fusion_loops.soft_nms_gaussian, fusion_loops.greedy_match]
    for fn in counted:  # count this path's launches only
        fn.launches = 0
    server = BatchingFusedServer(gpu_fd, max_batch=8, max_delay_ms=20.0)
    replies = [None] * len(reqs)
    calls = {"kfpn": [], "yolo": []}
    hooks = []
    t0 = time.perf_counter()
    try:
        server.warmup()
        hooks = record_networks(gpu_fd, calls)
        t_traffic = time.perf_counter()

        def client(k):
            futs = [(i, server.submit_fused(*reqs[i])) for i in range(k, len(reqs), 4)]
            for i, fut in futs:
                replies[i] = fut.result(timeout=300)

        threads = [threading.Thread(target=client, args=(k,)) for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        if any(t.is_alive() for t in threads):
            raise AssertionError("a client thread did not finish")
        traffic_s = time.perf_counter() - t_traffic
    finally:
        server.stop()
        for h in hooks:
            h.remove()
    launches = {fn.__name__: fn.launches for fn in counted}
    stats = dict(server.stats)
    warm = len(server.buckets())
    if stats["served"] != len(reqs) or any(r is None for r in replies):
        raise AssertionError(f"server answered {stats['served']} of {len(reqs)} requests")
    for name in ("bev_raster_reduce", "hard_nms_keep", "soft_nms_gaussian", "greedy_match"):
        if launches[name] != stats["batches"] + warm:
            raise AssertionError(
                f"{name} launched {launches[name]} times for {stats['batches']} batches + {warm} warmups")

    # Every served reply equals the CPU path's on the same request, given the
    # served networks' outputs for that frame; the CPU networks' own outputs
    # must lie within NET_TOL of those. Fused boxes are truncated means of two
    # integer boxes weighted by their confidences: where the pair shares a
    # coordinate, a difference of one float32 ulp in a confidence moves the
    # mean to either side of that integer, so the path after the networks is
    # held exact on equal inputs. `all_cpu` counts the replies that the CPU
    # path also gives from its own networks.
    # The replay records each frame's match: its candidate rows (the chain's
    # length on the card) and valid YOLO rows, from the same inputs.
    per_reply, net_errs, all_cpu, match_rows = [], [], 0, []
    plain_match = fusion_loops.greedy_match_plain

    def recorded_match(yolo, yolo_valid, sfa, sfa_valid, thr):
        match_rows.append([fusion_loops.greedy_match_candidate_rows(yolo, yolo_valid, sfa, sfa_valid, thr).tolist(),
                           yolo_valid.sum(1).tolist()])
        return plain_match(yolo, yolo_valid, sfa, sfa_valid, thr)

    for i, (req, got) in enumerate(zip(reqs, replies)):
        hooks = replay_networks(cpu_fd, served_networks(calls, letterbox(req[1], CANVAS)[0]), net_errs)
        fusion_loops.greedy_match_plain = recorded_match
        try:
            want = cpu_fd.detect(*req)
        finally:
            fusion_loops.greedy_match_plain = plain_match
            for h in hooks:
                h.remove()
        if not replies_equal(got, want):
            raise AssertionError(f"fused reply {i} differs between the GPU server and the CPU path: "
                                 + json.dumps(reply_difference(got, want)))
        all_cpu += replies_equal(got, cpu_fd.detect(*req))
        per_reply.append(np.bincount(got["source"], minlength=3).tolist())
    if not max(net_errs) <= NET_TOL:
        raise AssertionError(f"the served networks' outputs differ from the CPU's by {max(net_errs)}")
    sources = np.sum(per_reply, axis=0)
    if not (sources[0] and sources[1] and sources[2] >= MIN_FUSED_PER_FRAME * len(reqs)):
        raise AssertionError(f"vacuous fused replies: rows by source {sources.tolist()}")

    # per-batch wall time at buckets 1 and 8, and the stage split at 8
    prepared = []
    for points, image, calib in reqs[:8]:
        pts, valid = bev_ops.filter_and_pad_points(points, N)
        img, r, pad = letterbox(image, CANVAS)
        prepared.append((pts, valid, img, calib.V2C.astype(np.float32), calib.R0.astype(np.float32),
                         calib.P2.astype(np.float32), np.float32(IMG_HW), np.float32(r), np.float32(pad)))
    batch8 = [np.stack(a) for a in zip(*prepared)]
    lat = {b: host_ms(lambda: gpu_fd.run_batch(*[a[:b] for a in batch8])) for b in (1, 8)}
    dev = DEVICE
    pts, valid, images, V2C, R0, P2, hw, scale, pad = (torch.from_numpy(a).to(dev) for a in batch8)
    kfpn, yolo = gpu_fd.kfpn, gpu_fd.yolo
    with torch.inference_mode():
        bev = bev_ops.points_to_bev_nchw(pts, valid)
        heads = _heads_nhwc(kfpn, bev)
        _, boxes_bev, boxes_real, mask = _decode_heads(heads, 50, 0.2)
        sfa_scores = boxes_bev[..., 1]
        levels = forward_levels(yolo, images)
        yb_all, ys_all = decode_predictions(levels)
        yb, ys, yc, yv = select_detections(yb_all, ys_all, 0.25, 0.45, 64)
        ybox = _unletterbox_xywh(yb, scale, pad, hw)

        def project():
            return project_boxes_to_image(boxes_real, sfa_scores, mask, V2C, R0, P2,
                                          img_h=hw[:, 0], img_w=hw[:, 1], conf_gate=0.2)

        sfa2d, sfa_valid = project()
        sfa_cls = boxes_real[..., 0].to(torch.int32)
        fuse_kw = dict(mode="bayesian", confidence_threshold=0.25, fusion_iou_threshold=0.7,
                       nms_threshold=0.5, use_gaussian_nms=True, gaussian_sigma=0.5)
        stages = {
            "raster_ms": cuda_ms(lambda: bev_ops.points_to_bev_nchw(pts, valid)),
            "kfpn_ms": cuda_ms(lambda: kfpn(bev)),
            "decode_post_ms": cuda_ms(lambda: _decode_heads(heads, 50, 0.2)),
            "projection_ms": cuda_ms(project),
            "yolo_ms": cuda_ms(lambda: yolo(images.permute(0, 3, 1, 2))),
            "yolo_decode_ms": cuda_ms(lambda: decode_predictions(levels)),
            "select_detections_ms": cuda_ms(lambda: select_detections(yb_all, ys_all, 0.25, 0.45, 64)),
            "unletterbox_ms": cuda_ms(lambda: _unletterbox_xywh(yb, scale, pad, hw)),
            "fusion_soft_nms_ms": cuda_ms(lambda: _fuse_one(ybox, ys, yc, yv, sfa2d, sfa_scores,
                                                            sfa_cls, sfa_valid, **fuse_kw)),
        }
    emit({"phase": "fused_serve", "requests": len(reqs), "threads": 4, "canvas": list(CANVAS),
          "image": list(IMG_HW), "stats": stats, "warmup_batches": warm, "launches": launches,
          "yolo_gate_bias": gate_bias, "rows_by_source": sources.tolist(),
          "replies_equal_to_cpu_given_served_networks": len(reqs),
          "replies_equal_to_all_cpu_path": all_cpu, "network_max_abs_err": max(net_errs),
          "rows_by_source_per_reply": per_reply,
          "match_candidate_rows_per_frame": [c for rec in match_rows for c in rec[0]],
          "match_valid_yolo_rows_per_frame": [v for rec in match_rows for v in rec[1]],
          "traffic_seconds": traffic_s, "serve_seconds_with_warmup": time.perf_counter() - t0,
          "batch_ms_bucket1": lat[1], "batch_ms_bucket8": lat[8],
          "frames_per_s_bucket8": 8 / (lat[8] / 1e3), "stages_bucket8": stages,
          "card": card["nvidia_smi"]})
    return launches


# ---------------------------------------------------------------------------
# the training path
# ---------------------------------------------------------------------------

TRAIN_PARITY_BEV = (128, 128)  # GPU vs CPU step: raster, and heatmap 32 x 32
TRAIN_FRAMES = 64  # the synthetic mini-KITTI: one batch of S x B = 4 x 16 an epoch
TRAIN_VAL_FRAMES = 40  # its val split: batches of 16, 16 and a tail of 8
TRAIN_DEFAULTS = (16, 4, "bfloat16")  # the CLI's batch_size, effective_batch // batch_size, compute_dtype
TRAIN_LOSS_RTOL = 1e-5  # loss terms GPU vs CPU, one strict-fp32 step
TRAIN_STAT_RTOL = 1e-4  # BatchNorm statistics, of each tensor's largest
TRAIN_PARAM_SHARE = 1e-2  # parameters, of the step's largest parameter change
TRAIN_GRAD_FLOOR = 1e-3  # Adam: elements whose |grad| is under this share of their tensor's largest are excused
TARGET_RTOL = 1e-6  # float training targets GPU vs CPU, of each tensor's largest (exp, sin, cos: libm ulps)


def _check_targets(got, want):
    """Training targets of the card against the CPU route's: indices and
    masks bit-exact, floats within TARGET_RTOL of each tensor's largest;
    returns the largest float error by key."""
    errs = {}
    for k, v in want.items():
        g = got[k].cpu()
        if k in ("indices_center", "obj_mask"):
            if not torch.equal(g, v):
                raise AssertionError(f"training target {k} differs between the card and the CPU")
            continue
        errs[k] = (g - v).abs().max().item()
        if errs[k] > TARGET_RTOL * max(v.abs().max().item(), 1e-30):
            raise AssertionError(f"training target {k} differs between the card and the CPU by {errs[k]}")
    return errs


def _train_batch_from_scenes(seeds, dev, bev_size, hm_size, s):
    """S x B synthetic scenes through prepare_train_batch on `dev`."""
    from sfa3d_tpu_torch.data.loader import prepare_train_batch
    from sfa3d_tpu_torch.data.synthetic import synthetic_scene

    pts = np.zeros((len(seeds), N, 4), np.float32)
    valid = np.zeros((len(seeds), N), bool)
    labels = np.zeros((len(seeds), 50, 8), np.float32)
    n_lab = np.zeros(len(seeds), np.int32)
    for i, sd in enumerate(seeds):
        scan, lab = synthetic_scene(sd)
        pts[i], valid[i] = bev_ops.filter_and_pad_points(scan, N)
        labels[i, :len(lab)], n_lab[i] = lab, len(lab)
    hflip = np.arange(len(seeds)) % 2 == 1
    bev, tg = prepare_train_batch(*(torch.from_numpy(a).to(dev) for a in (pts, valid, labels, n_lab, hflip)),
                                  bev_size=bev_size, hm_size=hm_size)
    b = len(seeds) // s
    return {"bev": bev.reshape(s, b, *bev.shape[1:]), "targets": {k: v.reshape(s, b, *v.shape[1:]) for k, v in tg.items()}}


def _train_model(init_sd):
    """KFPN-18 with the weights `init_sd` (one init_weights draw, which takes
    seconds on the host, shared by the train phase's models)."""
    model = create_model("fpn_resnet_18")
    model.load_state_dict(init_sd)
    return model


def _train_step_parity(optimizer_type, init_sd):
    """One accumulated step (S = 2, B = 2, 128 x 128 raster) of the same
    model and batch on the card and on the CPU, strict fp32; returns the
    measured differences or raises."""
    from sfa3d_tpu_torch.config.train import OptimConfig
    from sfa3d_tpu_torch.parallel import create_train_state, make_train_step
    from sfa3d_tpu_torch.runtime.schedules import create_optimizer

    lr = 1e-2 if optimizer_type == "sgd" else 1e-3
    spec = create_optimizer(OptimConfig(optimizer_type=optimizer_type, lr=lr), num_epochs=10, steps_per_epoch=1)
    hm = (TRAIN_PARITY_BEV[0] // 4, TRAIN_PARITY_BEV[1] // 4)
    cpu_batch = _train_batch_from_scenes(range(40, 44), torch.device("cpu"), TRAIN_PARITY_BEV, hm, 2)
    gpu_batch = _train_batch_from_scenes(range(40, 44), DEVICE, TRAIN_PARITY_BEV, hm, 2)
    _check_targets(gpu_batch["targets"], cpu_batch["targets"])
    raster_errors(gpu_batch["bev"].flatten(0, 1).cpu(), cpu_batch["bev"].flatten(0, 1))
    cpu_model = _train_model(init_sd)
    gpu_model = _train_model(init_sd).to(DEVICE)
    start = {k: v.detach().clone() for k, v in cpu_model.state_dict().items()}
    out = {}
    for name, model, batch, dev in (("cpu", cpu_model, cpu_batch, "cpu"), ("gpu", gpu_model, gpu_batch, DEVICE)):
        state = create_train_state(model, spec)
        _, stats = make_train_step(model, spec, device=dev)(state, batch)
        out[name] = ({k: float(v) for k, v in stats.items()},
                     {k: v.detach().cpu() for k, v in model.state_dict().items()},
                     {k: p.grad.detach().cpu() for k, p in model.named_parameters()})
    (cs, csd, cgrad), (gs, gsd, _) = out["cpu"], out["gpu"]
    loss_err = max(abs(gs[k] - cs[k]) / abs(cs[k]) for k in cs)
    if not loss_err <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"{optimizer_type} step: loss GPU vs CPU differs by {loss_err} relative")
    names = set(cgrad)
    largest_change = max((csd[k] - start[k]).abs().max().item() for k in names)
    param_err, stat_err, excused = 0.0, 0.0, 0
    for k, want in csd.items():
        if k.endswith("num_batches_tracked"):
            if not torch.equal(gsd[k], want):
                raise AssertionError(f"{k} differs")
            continue
        diff = (gsd[k] - want).abs()
        if k in names:
            bad = diff > TRAIN_PARAM_SHARE * largest_change
            if optimizer_type == "adam":
                noise = cgrad[k].abs() <= TRAIN_GRAD_FLOOR * cgrad[k].abs().max()
                excused += int((bad & noise).sum())
                bad &= ~noise
            if bad.any():
                raise AssertionError(f"{optimizer_type} step: parameter {k} GPU vs CPU differs by "
                                     f"{diff.max().item()} (largest change {largest_change})")
            param_err = max(param_err, diff.max().item() / largest_change)
        else:
            rel = diff.max().item() / max(want.abs().max().item(), 1e-30)
            if rel > TRAIN_STAT_RTOL:
                raise AssertionError(f"{optimizer_type} step: BatchNorm statistic {k} differs by {rel} relative")
            stat_err = max(stat_err, rel)
    return {"loss_max_rel_err": loss_err, "param_max_err_share_of_largest_change": param_err,
            "largest_change": largest_change, "bn_stat_max_rel_err": stat_err,
            "adam_elements_excused_near_zero_grad": excused if optimizer_type == "adam" else None,
            "total_loss": cs["total_loss"]}


def _epoch_batches(loader, epochs, first_epoch=1):
    """Every batch of `epochs` whole epochs (the threaded loader collates
    each epoch's batches ahead; whole epochs keep the launch count exact)."""
    for epoch in range(first_epoch, first_epoch + epochs):
        loader.set_epoch(epoch)
        yield from loader


def _timed_steps(step, state, batches):
    """Run the steps; CUDA-event ms of each, losses, the host ms spent
    waiting on the loader, and the wall ms of each step from the end of the
    one before (loader wait included)."""
    ms, losses, wait, wall = [], [], [], []
    t = time.perf_counter()
    for batch in batches:
        wait.append((time.perf_counter() - t) * 1e3)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t_step = time.perf_counter()
        start.record()
        state, stats = step(state, batch)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
        losses.append(float(stats["total_loss"]))
        t = time.perf_counter()
        wall.append(wait[-1] + (t - t_step) * 1e3)
    return state, ms, losses, wait, wall


def _prepare_checks(loader):
    """The device preparation of one collated batch (S x B = 64 frames, the
    training path's shape, flipped where the dataset drew hflip), held
    against its plain versions and then timed with CUDA events. The raster
    kernel must equal bev_raster_reduce_plain on the card, and the card's
    prepare_train_batch (raster, flip, targets) the CPU route on the same
    frames. Its launches come after the path's count was read."""
    from sfa3d_tpu_torch.data.loader import prepare_train_batch
    from sfa3d_tpu_torch.ops.targets import build_targets

    samples = [loader.dataset[i] for i in range(loader.batch_size * loader.subdivisions)]
    host = [np.stack([x.points for x in samples]), np.stack([x.valid for x in samples]),
            np.stack([x.labels for x in samples]), np.int32([x.n_labels for x in samples]),
            np.asarray([bool(getattr(x, "hflipped", False)) for x in samples])]
    if not 0 < host[4].sum() < len(samples):
        raise AssertionError(f"{host[4].sum()} of {len(samples)} frames flipped: the flip goes unchecked")
    pts, valid, labels, n_lab, hflip = (torch.from_numpy(a).to(DEVICE) for a in host)
    kernel_err = raster_errors(bev_ops.points_to_bev_nchw(pts, valid).cpu(),
                               bev_raster_reduce_plain(*bev_ops.cell_indices_and_keys(pts, valid)).cpu())
    bev, targets = prepare_train_batch(pts, valid, labels, n_lab, hflip)
    want_bev, want_targets = prepare_train_batch(*(torch.from_numpy(a) for a in host))
    route_err = raster_errors(bev.cpu(), want_bev)
    target_err = _check_targets(targets, want_targets)
    return {"frames": len(samples), "hflipped": int(host[4].sum()),
            "raster_vs_plain_on_card_max_abs_err": kernel_err, "prepare_vs_cpu_raster_max_abs_err": route_err,
            "prepare_vs_cpu_target_max_abs_err": target_err,
            "prepare_train_batch_ms": cuda_ms(lambda: prepare_train_batch(pts, valid, labels, n_lab, hflip), reps=10),
            "raster_ms": cuda_ms(lambda: bev_ops.points_to_bev_nchw(pts, valid), reps=10),
            "build_targets_ms": cuda_ms(lambda: build_targets(labels, n_lab, hflip), reps=10)}


def phase_train(card, tmp_root):
    """The training path. First one strict-fp32 step GPU vs CPU (SGD, then
    Adam, deterministic cuDNN); then the full width through the entry points
    a user calls: the CLI's parser and defaults (fpn_resnet_18, 608 x 608,
    batch 16, effective batch 64 -> S = 4), create_train_loader over a
    synthetic mini-KITTI with augmentation and hflip, create_optimizer,
    create_train_state, make_train_step: 5 steps in float32 and 3 in the
    bfloat16 default, timed; 8 Adam steps on one fixed batch must lower its
    loss; one epoch of the training CLI. bev_raster_reduce must launch once
    per collated batch."""
    import os

    from sfa3d_tpu_torch.cli import train as train_cli
    from sfa3d_tpu_torch.config.train import OptimConfig, parse_train_configs
    from sfa3d_tpu_torch.data.loader import create_train_loader, create_val_loader
    from sfa3d_tpu_torch.data.synthetic import write_mini_kitti
    from sfa3d_tpu_torch.parallel import create_train_state, make_train_step
    from sfa3d_tpu_torch.runtime.schedules import create_optimizer

    emit({"phase": "train_tolerance", "loss_rtol": TRAIN_LOSS_RTOL, "bn_stat_rtol_of_tensor_max": TRAIN_STAT_RTOL,
          "param_tol_share_of_largest_change": TRAIN_PARAM_SHARE,
          "adam_excuses_elements_with_grad_below_share_of_tensor_max": TRAIN_GRAD_FLOOR,
          "float_target_rtol_of_tensor_max": TARGET_RTOL})
    init_sd = create_model("fpn_resnet_18").init_weights(torch.Generator().manual_seed(SEED)).state_dict()
    torch.backends.cudnn.deterministic = True
    try:
        parity = {opt: _train_step_parity(opt, init_sd) for opt in ("sgd", "adam")}
    finally:
        torch.backends.cudnn.deterministic = False
    emit({"phase": "train_parity", "bev": list(TRAIN_PARITY_BEV), "S": 2, "B": 2, **parity,
          "card": card["nvidia_smi"]})

    t0 = time.perf_counter()
    root = write_mini_kitti(os.path.join(tmp_root, "kitti"), n_frames=TRAIN_FRAMES, seed=SEED,
                            splits={"train": range(TRAIN_FRAMES), "val": range(TRAIN_VAL_FRAMES)})
    write_s = time.perf_counter() - t0
    configs = parse_train_configs(["--dataset_dir", root, "--root-dir", os.path.join(tmp_root, "run"),
                                   "--seed", str(SEED)])
    rt = configs.runtime
    s = configs.optim.effective_batch // rt.batch_size
    if (rt.batch_size, s, configs.model.compute_dtype) != TRAIN_DEFAULTS:
        raise AssertionError(f"the CLI defaults are not batch, S, dtype = {TRAIN_DEFAULTS}")
    loader = create_train_loader(configs, device=DEVICE)
    model = _train_model(init_sd).to(DEVICE)
    spec = create_optimizer(configs.optim, rt.num_epochs, len(loader))
    state = create_train_state(model, spec)

    bev_raster_reduce.launches = 0  # count the main path's launches only
    runs = {}
    for dtype, epochs in (("float32", 5), ("bfloat16", 3)):
        step = make_train_step(model, spec, compute_dtype=dtype, device=DEVICE)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        first = 1 if dtype == "float32" else 6
        state, ms, losses, wait, wall = _timed_steps(step, state, _epoch_batches(loader, epochs, first))
        if len(ms) != epochs:
            raise AssertionError(f"{len(ms)} batches for {epochs} epochs of {TRAIN_FRAMES} frames")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"non-finite {dtype} training loss: {losses}")
        steady = statistics.median(ms[1:])
        frames = s * rt.batch_size
        # end to end: the frames of the steps after the first over their wall
        # time, loader wait included (each step here is an epoch of its own,
        # so the threaded loader cannot load the next batch during a step)
        runs[dtype] = {"steps": len(ms), "step_ms": ms, "step_ms_median_after_first": steady,
                       "step_wall_ms": wall, "loader_wait_ms": wait,
                       "frames_per_s_end_to_end": (len(ms) - 1) * frames / (sum(wall[1:]) / 1e3),
                       "frames_per_s_device": frames / (steady / 1e3), "losses": losses,
                       "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
    launches = bev_raster_reduce.launches
    n_batches = sum(r["steps"] for r in runs.values())
    if launches != n_batches:
        raise AssertionError(f"bev_raster_reduce launched {launches} times for {n_batches} collated batches")

    # 8 Adam steps on one fixed batch lower its loss (a fresh model)
    fixed = next(iter(_epoch_batches(loader, 1, 20)))
    ov_model = _train_model(init_sd).to(DEVICE)
    ov_spec = create_optimizer(OptimConfig(optimizer_type="adam", lr=1e-3, lr_type="cosin"), 10, 5)
    ov_state = create_train_state(ov_model, ov_spec)
    ov_step = make_train_step(ov_model, ov_spec, compute_dtype="float32", device=DEVICE)
    overfit = []
    for i in range(8):
        if i == 1:  # where a float32 step's device time goes (the shapes are warm)
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                ov_state, stats = ov_step(ov_state, fixed)
                torch.cuda.synchronize()
        else:
            ov_state, stats = ov_step(ov_state, fixed)
        overfit.append(float(stats["total_loss"]))
    if not (np.isfinite(overfit).all() and overfit[-1] < overfit[0]):
        raise AssertionError(f"8 Adam steps on one batch did not lower its loss: {overfit}")
    kernels = sorted(((self_device_us(e), e.key) for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA and self_device_us(e) > 0), reverse=True)
    device_ms = sum(us for us, _ in kernels) / 1e3
    profile = {"kernel_device_ms": device_ms, "top_kernels": [[k[:90], us / 1e3] for us, k in kernels[:10]],
               "conv_gemm_share": sum(us for us, k in kernels if re.search(r"conv|cudnn|xmma|gemm|sm90|engine", k, re.I))
               / 1e3 / device_ms if device_ms else None}
    prep = _prepare_checks(loader)

    # one epoch of the training CLI (train step, validation, checkpoint)
    bev_raster_reduce.launches = 0
    t0 = time.perf_counter()
    train_cli.main(["--dataset_dir", root, "--root-dir", os.path.join(tmp_root, "cli"), "--num_epochs", "1",
                    "--checkpoint_freq", "1", "--seed", str(SEED), "--print_freq", "1"])
    cli_s = time.perf_counter() - t0
    val_batches = len(create_val_loader(configs, device=DEVICE))
    cli_launches = bev_raster_reduce.launches
    if cli_launches != 1 + val_batches:
        raise AssertionError(f"the CLI epoch launched the raster {cli_launches} times for 1 + {val_batches} batches")
    # the CLI's validation batches, the tail included, on the card and on the CPU
    val_frames, val_err = [], [0.0, 0.0, 0.0]
    for got, want in zip(create_val_loader(configs, device=DEVICE), create_val_loader(configs, device="cpu")):
        errs = raster_errors(got["bev"].flatten(0, 1).cpu(), want["bev"].flatten(0, 1))
        _check_targets({k: v.flatten(0, 1) for k, v in got["targets"].items()},
                       {k: v.flatten(0, 1) for k, v in want["targets"].items()})
        val_err = [max(a, b) for a, b in zip(val_err, errs)]
        val_frames.append(got["bev"].shape[1])
    if len(val_frames) != val_batches or sum(val_frames) != TRAIN_VAL_FRAMES:
        raise AssertionError(f"validation batches {val_frames} for {TRAIN_VAL_FRAMES} frames")
    ckpt = os.path.join(tmp_root, "cli", "checkpoints", rt.saved_fn, f"Model_{rt.saved_fn}_epoch_1.pth")
    Detector(checkpoint=ckpt, device=DEVICE)  # the served path loads what training wrote
    emit({"phase": "train", "arch": configs.model.arch, "bev": [H, W], "batch_size": rt.batch_size, "S": s,
          "frames_per_step": s * rt.batch_size, "mini_kitti_frames": TRAIN_FRAMES, "write_seconds": write_s,
          "augmentation": {"aug_prob": configs.data.aug_prob, "hflip_prob": configs.data.hflip_prob},
          **runs, "raster_launches": launches, "collated_batches": n_batches, "overfit_adam_losses": overfit,
          "float32_step_profile": profile, "prepare_batch_ms": prep,
          "cli_epoch_seconds": cli_s, "cli_raster_launches": cli_launches, "cli_val_batches": val_batches,
          "cli_val_batch_frames": val_frames, "cli_val_vs_cpu_raster_max_abs_err": val_err,
          "card": card["nvidia_smi"]})
    train_err = max(max(prep["raster_vs_plain_on_card_max_abs_err"]), max(prep["prepare_vs_cpu_raster_max_abs_err"]),
                    max(val_err))
    return launches, n_batches, train_err


def main() -> int:
    card = phase_device()
    phase_build(card)
    counts_rec, raster_rec = phase_kernel(card)
    loop_recs = phase_fusion_kernels(card)
    pts, valid = phase_raster(card)
    phase_model(card, pts, valid)
    phase_yolo(card)
    scans, lidar_raster_launches, served_count_launches = phase_serve(card)
    counts_rec["launches"] = phase_counts(card, scans)
    counts_rec["path"] = "count map of the 16 served scans: cell_indices_and_keys -> bev_cell_counts"
    fused = phase_fused_serve(card)
    with tempfile.TemporaryDirectory() as tmp_root:
        train_launches, train_batches, train_err = phase_train(card, tmp_root)
    fused_path = "BatchingFusedServer: 16 requests, warmups included"
    raster_rec["launches"] = fused["bev_raster_reduce"]
    raster_rec["path"] = fused_path
    for rec in loop_recs:
        rec["launches"] = fused[rec["name"]]
        rec["path"] = fused_path
    counts_rec["launches_by_path"] = {"lidar_serve": served_count_launches,
                                      "fused_serve": fused["bev_cell_counts"]}
    raster_rec["launches_by_path"] = {"lidar_serve": lidar_raster_launches,
                                      "fused_serve": fused["bev_raster_reduce"], "train": train_launches}
    raster_rec["launches_per_train_step"] = train_launches / train_batches
    raster_rec["max_abs_err"] = max(raster_rec["max_abs_err"], train_err)  # the training path's batches too
    print(card["nvidia_smi"], flush=True)
    emit({"kernels": [counts_rec, raster_rec, *loop_recs]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
