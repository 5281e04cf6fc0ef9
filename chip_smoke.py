"""Drive the PyTorch port's LiDAR serving path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  device  the card (name and power limit from nvidia-smi); TF32 off
  build   nvcc builds every kernel in sfa3d_tpu_torch/csrc/ (timed)
  kernel  the BEV count kernel vs its plain PyTorch version, exact, at the
          served shape (8, 32768); kernel, plain and torch.bincount times
  raster  GPU points_to_bev vs the CPU plain path: channels 0 and 1, cell
          indices and counts bit-exact, density within 1.2e-7
  model   KFPN-18 heads at 608x608 on the GPU vs the CPU, within 1e-3
  serve   BatchingDetectorServer(Detector(device="cuda"), max_batch=8)
          answers 16 requests from 4 threads; every reply matches the CPU
          Detector within 1e-3; the count kernel's launches equal the
          served batches plus the warmup batches; per-batch latency at
          buckets 1 and 8, frames/s and a per-stage split
Then one {"kernels": [...]} line and, last, the {"ok": true, ...} line.

Exits non-zero, with no result line, when CUDA is unavailable or any
phase fails. Weights are random, drawn from a fixed torch.Generator.
"""

from __future__ import annotations

import copy
import json
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
from sfa3d_tpu_torch.ops.bev_counts import bev_cell_counts, bev_cell_counts_plain
from sfa3d_tpu_torch.pipeline import _decode_heads, forward_heads
from sfa3d_tpu_torch.runtime.serving import BatchingDetectorServer

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
SEED = 0
HM_BIAS_BUMP = 2.0  # random weights then give peaks above the threshold
B, N = 8, cnf.MAX_POINTS_FILTERED
H, W = cnf.BEV_HEIGHT, cnf.BEV_WIDTH


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


def phase_kernel(card):
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    row = rng.integers(0, H, (B, N)).astype(np.int32)
    col = rng.integers(0, W, (B, N)).astype(np.int32)
    invalid = rng.random((B, N)) < 0.3
    row[invalid] = -1
    col[invalid] = -1
    row[3, :10000] = 123  # one cell hit 10,000 times
    col[3, :10000] = 456
    row_d, col_d = torch.from_numpy(row).to(dev), torch.from_numpy(col).to(dev)

    got = bev_cell_counts(row_d, col_d)
    plain = bev_cell_counts_plain(row_d, col_d)
    plain_cpu = bev_cell_counts_plain(torch.from_numpy(row), torch.from_numpy(col))
    torch.cuda.synchronize()
    err = (got - plain).abs().max().item()
    if not (torch.equal(got, plain) and torch.equal(got.cpu(), plain_cpu)):
        raise AssertionError(f"bev_cell_counts disagrees with its plain version: max |diff| {err}")
    if got[3, 123, 456].item() < 10000:
        raise AssertionError("the hot cell lost counts")

    ok = (row_d >= 0) & (col_d >= 0)
    batch = torch.arange(B, device=dev)[:, None]
    flat = torch.where(ok, (batch * H + row_d) * W + col_d, B * H * W).reshape(-1)
    bytes_moved = row.nbytes + col.nbytes + B * H * W * 4
    n_valid = int(ok.sum().item())
    bound_bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = n_valid / FP32_OPS_PER_S * 1e3
    rec = {
        "name": "bev_cell_counts",
        "route": "cuda",
        "source": "sfa3d_tpu_torch/csrc/bev_counts.cu",
        "replaces": "sfa3d_tpu/ops/bev_pallas.py:76",
        "launches": None,  # filled in from the serve phase's run
        "max_abs_err": err,
        "ms": cuda_ms(lambda: bev_cell_counts(row_d, col_d)),
        "plain_ms": cuda_ms(lambda: bev_cell_counts_plain(row_d, col_d)),
        "bound_ms": max(bound_bytes_ms, bound_ops_ms),
        "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
        "library_ms": cuda_ms(lambda: torch.bincount(flat, minlength=B * H * W + 1)),
    }
    emit({"phase": "kernel", "shape": [B, N], "valid_points": n_valid,
          "bytes": bytes_moved, **{k: rec[k] for k in
                                    ("max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms")},
          "card": card["nvidia_smi"]})
    return rec


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

    bev_cell_counts.launches = 0  # count the main path's launches only
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
    launches = bev_cell_counts.launches
    stats = dict(server.stats)
    warm = len(server.buckets())
    if stats["served"] != len(scans) or any(r is None for r in replies):
        raise AssertionError(f"server answered {stats['served']} of {len(scans)} requests")
    if launches != stats["batches"] + warm or launches == 0:
        raise AssertionError(
            f"count kernel launched {launches} times for {stats['batches']} batches + {warm} warmups"
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

    # per-stage device time of one bucket-8 batch
    pts_d, valid_d = torch.from_numpy(p).cuda(), torch.from_numpy(v).cuda()
    with torch.inference_mode():
        bev = bev_ops.points_to_bev_nchw(pts_d, valid_d)
        heads = {k: t.permute(0, 2, 3, 1) for k, t in gpu_det.model(bev).items()}
        stages = {
            "raster_ms": cuda_ms(lambda: bev_ops.points_to_bev_nchw(pts_d, valid_d)),
            "model_ms": cuda_ms(lambda: gpu_det.model(bev)),
            "decode_ms": cuda_ms(lambda: _decode_heads(heads, 50, 0.2)),
        }
    emit({"phase": "serve", "requests": len(scans), "threads": 4, "stats": stats,
          "warmup_batches": warm, "count_kernel_launches": launches,
          "detections_per_reply": n_dets, "max_abs_err_vs_cpu": worst,
          "traffic_seconds": traffic_s, "serve_seconds_with_warmup": time.perf_counter() - t0,
          "batch_ms_bucket1": lat[1], "batch_ms_bucket8": lat[8],
          "frames_per_s_bucket8": 8 / (lat[8] / 1e3), "stages_bucket8": stages,
          "card": card["nvidia_smi"]})
    return launches


def main() -> int:
    card = phase_device()
    phase_build(card)
    kernel = phase_kernel(card)
    pts, valid = phase_raster(card)
    phase_model(card, pts, valid)
    kernel["launches"] = phase_serve(card)
    print(card["nvidia_smi"], flush=True)
    emit({"kernels": [kernel]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
