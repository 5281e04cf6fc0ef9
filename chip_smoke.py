"""Drive the PyTorch port's LiDAR serving path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  device  the card (name and power limit from nvidia-smi); TF32 off
  build   nvcc builds every kernel in sfa3d_tpu_torch/csrc/ (timed)
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
import threading
import time

import numpy as np
import torch

from sfa3d_tpu_torch import _build
from sfa3d_tpu_torch.config import kitti as cnf
from sfa3d_tpu_torch.detector import Detector
from sfa3d_tpu_torch.models import create_model
from sfa3d_tpu_torch.ops import bev as bev_ops
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
from sfa3d_tpu_torch.pipeline import _decode_heads, forward_heads
from sfa3d_tpu_torch.runtime.serving import BatchingDetectorServer

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
SEED = 0
HM_BIAS_BUMP = 2.0  # random weights then give peaks above the threshold
B, N = 8, cnf.MAX_POINTS_FILTERED
H, W = cnf.BEV_HEIGHT, cnf.BEV_WIDTH
DENSITY_TOL = 1.2e-7  # one float32 ulp of log between two libms, scaled
KERNEL_NAME = r"bev_tile_kernel"


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


def device_ms(fn, reps: int = 20, warmup: int = 3):
    """Mean device time per fn() call of the kernels named KERNEL_NAME,
    from torch.profiler (CUPTI); None if the profiler saw none."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(self_device_us(e) for e in prof.key_averages() if re.search(KERNEL_NAME, e.key))
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


def main() -> int:
    card = phase_device()
    phase_build(card)
    counts_rec, raster_rec = phase_kernel(card)
    pts, valid = phase_raster(card)
    phase_model(card, pts, valid)
    scans, raster_rec["launches"], served_count_launches = phase_serve(card)
    raster_rec["path"] = "BatchingDetectorServer: 16 requests, warmups included"
    counts_rec["launches"] = phase_counts(card, scans)
    counts_rec["path"] = "count map of the 16 served scans: cell_indices_and_keys -> bev_cell_counts"
    counts_rec["served_path_launches"] = served_count_launches
    print(card["nvidia_smi"], flush=True)
    emit({"kernels": [counts_rec, raster_rec]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
