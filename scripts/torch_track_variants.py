"""Variants of the association kernel's matrix design, measured against
each other on one NVIDIA GPU: the choices behind `csrc/track_associate.cu`.

    python3 scripts/torch_track_variants.py

Builds VARIANTS_SOURCE (below) once per variant into `build/kernels/`, with
  TRIAL_CLUSTER = 1, 2 or 4  blocks per frame for staging, screen and keys
                             (1: one block, no cluster: the committed design;
                             2, 4: a thread block cluster whose blocks write
                             the keys into the first block's shared memory)
  TRIAL_BALLOT = 0 or 1      the chain's argmax: two warp reductions (0, the
                             committed design) or one reduction and a ballot
                             of the lanes holding the top key, with lane l
                             holding columns l * kSlots + q (1)
holds every variant bit for bit against the plain PyTorch version on every
seeded and crafted input of chip_smoke's track_kernels phase (T <= 256) at
each of its thresholds, then prints each variant's device time (torch.profiler,
in turns: every variant, then every variant in reverse) at the three timed
shapes and on a tracker-like input (17 candidate rows of 50), and the card's
name and power limit.
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
from sfa3d_tpu_torch.ops import track_associate as ta  # noqa: E402

VARIANTS = [(1, 0), (2, 0), (4, 0), (1, 1), (2, 1)]  # (TRIAL_CLUSTER, TRIAL_BALLOT)
VARIANTS_SOURCE = r"""#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace cg = cooperative_groups;

#ifndef TRIAL_CLUSTER
#define TRIAL_CLUSTER 1
#endif
#ifndef TRIAL_BALLOT
#define TRIAL_BALLOT 0
#endif

namespace {
constexpr int kWarp = 32;
constexpr int kMaxThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kKeyNaN = 0xffffffffu;
constexpr uint32_t kKeyUsed = 0x407fffffu;
constexpr int kCluster = TRIAL_CLUSTER;

__device__ __forceinline__ uint32_t order_key(float v) {
  const uint32_t b = __float_as_uint(__fadd_rn(v, 0.0f));
  const uint32_t key = b ^ (static_cast<uint32_t>(static_cast<int32_t>(b) >> 31) | 0x80000000u);
  return isnan(v) ? kKeyNaN : key;
}

template <int kSlots>
__device__ __forceinline__ void load_row(const float* __restrict__ row, int t, int lane, float (&v)[kSlots]) {
#pragma unroll
  for (int q = 0; q < kSlots; ++q) {
    const int j = q * kWarp + lane;
    v[q] = j < t ? __ldg(row + j) : 0.0f;
  }
}

template <int kSlots>
__device__ __forceinline__ void key_row(const float (&v)[kSlots], int r, int t, int lane, uint32_t kmin,
                                        bool every_row, uint32_t* skeys, uint8_t* scand, int32_t* smatch) {
  bool any = false;
#pragma unroll
  for (int q = 0; q < kSlots; ++q) {
    const int j = q * kWarp + lane;
    const uint32_t key = j < t ? order_key(v[q]) : 0u;
    skeys[r * kSlots * kWarp + j] = key;
    any |= key >= kmin && key != kKeyNaN;
  }
  any = __any_sync(kFull, any) || every_row;
  if (lane == 0) {
    scand[r] = any;
    smatch[r] = -1;
  }
}

template <int kSlots>
__global__ void __launch_bounds__(kMaxThreads)
    track_associate_matrix_kernel(const float* __restrict__ iou, const int32_t* __restrict__ order,
                                  int32_t* __restrict__ det_match, uint8_t* __restrict__ trk_used,
                                  int32_t k, int32_t t, float iou_min) {
  constexpr int kRow = kSlots * kWarp;
  extern __shared__ uint4 smem4[];
  uint32_t* skeys = reinterpret_cast<uint32_t*>(smem4);
  int32_t* slist = reinterpret_cast<int32_t*>(skeys + k * kRow);
  int32_t* smatch = slist + k;
  uint8_t* scand = reinterpret_cast<uint8_t*>(smatch + k);
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int warps = blockDim.x / kWarp;
#if TRIAL_CLUSTER > 1
  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int64_t f = blockIdx.x / kCluster;
  uint32_t* w_keys = cluster.map_shared_rank(skeys, 0);
  int32_t* w_list = cluster.map_shared_rank(slist, 0);
  int32_t* w_match = cluster.map_shared_rank(smatch, 0);
  uint8_t* w_cand = cluster.map_shared_rank(scand, 0);
  cluster.sync();
#else
  const int rank = 0;
  const int64_t f = blockIdx.x;
  uint32_t* w_keys = skeys;
  int32_t* w_list = slist;
  int32_t* w_match = smatch;
  uint8_t* w_cand = scand;
#endif
  const float* f_iou = iou + f * k * t;
  const uint32_t kmin = isnan(iou_min) ? kKeyNaN : order_key(iou_min);
  const bool every_row = -1.0f >= iou_min;
  for (int i = rank * blockDim.x + threadIdx.x; i < k; i += kCluster * blockDim.x) w_list[i] = order[f * k + i];
  const int gw = rank * warps + warp, gws = kCluster * warps;
  for (int r0 = gw; r0 < k; r0 += 2 * gws) {
    const int r1 = r0 + gws;
    float v0[kSlots], v1[kSlots];
    load_row<kSlots>(f_iou + static_cast<int64_t>(r0) * t, t, lane, v0);
    if (r1 < k) load_row<kSlots>(f_iou + static_cast<int64_t>(r1) * t, t, lane, v1);
    key_row<kSlots>(v0, r0, t, lane, kmin, every_row, w_keys, w_cand, w_match);
    if (r1 < k) key_row<kSlots>(v1, r1, t, lane, kmin, every_row, w_keys, w_cand, w_match);
  }
#if TRIAL_CLUSTER > 1
  cluster.sync();
  if (rank != 0) return;
#else
  __syncthreads();
#endif
  if (warp != 0) return;

  int n = 0;
  for (int w = 0; w * kWarp < k; ++w) {
    const int i = w * kWarp + lane;
    const int d = i < k ? slist[i] : 0;
    const bool c = i < k && scand[d];
    const uint32_t bits = __ballot_sync(kFull, c);
    if (c) slist[n + __popc(bits & ((1u << lane) - 1u))] = d;
    n += __popc(bits);
  }
  __syncwarp();

  uint32_t used = 0;
  uint32_t next[kSlots];
#if TRIAL_BALLOT
  const uint32_t* keys_of_lane = skeys + lane * kSlots;
  constexpr int kStride = 1;
#else
  const uint32_t* keys_of_lane = skeys + lane;
  constexpr int kStride = kWarp;
#endif
  int d_next = n > 0 ? slist[0] : 0;
  if (n > 0) {
#pragma unroll
    for (int q = 0; q < kSlots; ++q) next[q] = keys_of_lane[d_next * kRow + q * kStride];
  }
  for (int s = 0; s < n; ++s) {
    const int d = d_next;
    uint32_t key[kSlots];
#pragma unroll
    for (int q = 0; q < kSlots; ++q) key[q] = ((used >> q) & 1u) ? kKeyUsed : next[q];
    if (s + 1 < n) {
      d_next = slist[s + 1];
#pragma unroll
      for (int q = 0; q < kSlots; ++q) next[q] = keys_of_lane[d_next * kRow + q * kStride];
    }
    uint32_t m[kSlots];
#pragma unroll
    for (int q = 0; q < kSlots; ++q) m[q] = key[q];
#pragma unroll
    for (int stride = 1; stride < kSlots; stride *= 2) {
#pragma unroll
      for (int q = 0; q + stride < kSlots; q += 2 * stride) m[q] = max(m[q], m[q + stride]);
    }
    const uint32_t best = m[0];
    const uint32_t top = __reduce_max_sync(kFull, best);
    const bool hit = top != kKeyNaN && top >= kmin;
#if TRIAL_BALLOT
    int qb = kSlots - 1;
#pragma unroll
    for (int q = kSlots - 1; q >= 0; --q) qb = key[q] == best ? q : qb;
    const int src = __ffs(__ballot_sync(kFull, best == top)) - 1;
    if (lane == src) {
      used |= static_cast<uint32_t>(hit) << qb;
      smatch[d] = hit ? lane * kSlots + qb : -1;
    }
#else
    uint32_t at = kFull;
#pragma unroll
    for (int q = kSlots - 1; q >= 0; --q) at = key[q] == best ? q * kWarp + lane : at;
    const uint32_t jm = __reduce_min_sync(kFull, best == top ? at : kFull);
    used |= static_cast<uint32_t>(hit && lane == static_cast<int>(jm % kWarp)) << (jm / kWarp);
    if (lane == 0) smatch[d] = hit ? static_cast<int32_t>(jm) : -1;
#endif
  }
  __syncwarp();
  for (int i = lane; i < k; i += kWarp) det_match[f * k + i] = smatch[i];
#pragma unroll
  for (int q = 0; q < kSlots; ++q) {
#if TRIAL_BALLOT
    const int j = lane * kSlots + q;
#else
    const int j = q * kWarp + lane;
#endif
    if (j < t) trk_used[f * t + j] = (used >> q) & 1u;
  }
}

size_t matrix_smem(int32_t k, int slots) { return static_cast<size_t>(k) * (kWarp * 4 * slots + 9); }

int threads_for(int32_t k) {
  const int rows = (k + kCluster - 1) / kCluster;
  const int warps = (rows + 1) / 2;
  return warps >= kMaxThreads / kWarp ? kMaxThreads : (warps < 1 ? kWarp : warps * kWarp);
}

template <int kSlots>
cudaError_t launch(const void* iou, const void* order, void* det_match, void* trk_used, int64_t batch,
                   int32_t k, int32_t t, float iou_min, void* stream) {
  const size_t smem = matrix_smem(k, kSlots);
  static bool opted = false;  // once per variant and process: the script uses one device
  if (!opted) {
    int limit = 0, device = 0;
    cudaError_t e = cudaGetDevice(&device);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(track_associate_matrix_kernel<kSlots>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
    }
    if (e != cudaSuccess) return e;
    opted = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned int>(batch * kCluster));
  cfg.blockDim = dim3(threads_for(k));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = kCluster;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  if (kCluster > 1) {
    cfg.attrs = &cluster;
    cfg.numAttrs = 1;
  }
  return cudaLaunchKernelEx(&cfg, track_associate_matrix_kernel<kSlots>, static_cast<const float*>(iou),
                            static_cast<const int32_t*>(order), static_cast<int32_t*>(det_match),
                            static_cast<uint8_t*>(trk_used), k, t, iou_min);
}
}  // namespace

extern "C" int track_associate_cuda(const void* iou, const void* order, void* det_match, void* trk_used,
                                    int64_t batch, int32_t k, int32_t t, float iou_min, int32_t device,
                                    void* stream) {
  cudaError_t err;
  switch ((t + kWarp - 1) / kWarp) {
    case 1: err = launch<1>(iou, order, det_match, trk_used, batch, k, t, iou_min, stream); break;
    case 2: err = launch<2>(iou, order, det_match, trk_used, batch, k, t, iou_min, stream); break;
    case 3: err = launch<3>(iou, order, det_match, trk_used, batch, k, t, iou_min, stream); break;
    case 4: err = launch<4>(iou, order, det_match, trk_used, batch, k, t, iou_min, stream); break;
    case 5: err = launch<5>(iou, order, det_match, trk_used, batch, k, t, iou_min, stream); break;
    case 6: err = launch<6>(iou, order, det_match, trk_used, batch, k, t, iou_min, stream); break;
    case 7: err = launch<7>(iou, order, det_match, trk_used, batch, k, t, iou_min, stream); break;
    case 8: err = launch<8>(iou, order, det_match, trk_used, batch, k, t, iou_min, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}
"""


def build() -> dict:
    """{(cluster, ballot): library}, one nvcc per variant, all started together."""
    out_dir = _build.BUILD_DIR / "track_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "variants.cu"
    src.write_text(VARIANTS_SOURCE)
    nvcc = _build.find_nvcc()
    procs = {}
    for c, b in VARIANTS:
        lib_path = out_dir / f"libvariant_c{c}_b{b}.so"
        cmd = [nvcc, *_build.NVCC_FLAGS, f"-DTRIAL_CLUSTER={c}", f"-DTRIAL_BALLOT={b}", "-Xptxas", "-v",
               "-o", str(lib_path), str(src)]
        procs[(c, b)] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib_path)
    libs = {}
    for key, (proc, lib_path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {key}:\n{log}")
        regs = [int(w) for line in log.splitlines() if "Used" in line and "registers" in line
                for w in [line.split("Used ")[1].split()[0]]]
        spills = [line.strip() for line in log.splitlines() if "spill" in line and " 0 bytes spill stores" not in line]
        print(json.dumps({"variant": list(key), "registers": regs, "spills": spills}), flush=True)
        lib = ctypes.CDLL(str(lib_path))
        lib.track_associate_cuda.restype = ctypes.c_int
        lib.track_associate_cuda.argtypes = list(ta._ARGS)
        libs[key] = lib
    return libs


def call(lib, iou: torch.Tensor, order: torch.Tensor, iou_min: float):
    b, k, t = iou.shape
    det_match, trk_used = order.new_empty((b, k)), iou.new_empty((b, t), dtype=torch.bool)
    err = lib.track_associate_cuda(iou.data_ptr(), order.data_ptr(), det_match.data_ptr(), trk_used.data_ptr(),
                                   b, k, t, float(iou_min), iou.device.index,
                                   torch.cuda.current_stream(iou.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"variant launch failed: cudaError {err}")
    return det_match, trk_used


def tracker_like(rng, dev):
    """(1, 50, 64): 17 rows with three eligible tracks each, every other pair
    gated to -1: the candidate rows of the track phase's scene (13-20)."""
    iou = np.full((1, 50, 64), -1.0, np.float32)
    rows = rng.choice(50, 17, replace=False)
    iou[0, rows[:, None], rng.integers(0, 64, (17, 3))] = rng.uniform(0.05, 0.9, (17, 3)).astype(np.float32)
    order = rng.permutation(50).astype(np.int32)[None]
    return torch.from_numpy(iou).to(dev), torch.from_numpy(order).to(dev)


def main() -> int:
    card = chip_smoke.phase_device()  # exits when there is no GPU
    libs = build()
    dev = chip_smoke.DEVICE
    inputs = {name: tuple(torch.from_numpy(a).to(dev) for a in arrays)
              for name, arrays in chip_smoke.track_seeded_inputs().items()}
    for name, arrays in chip_smoke.track_crafted_inputs(np.random.default_rng(chip_smoke.SEED + 14)).items():
        if arrays[0].shape[2] <= 32 * ta.MATRIX_SLOTS_PER_LANE:
            inputs[name] = tuple(torch.from_numpy(a).to(dev) for a in arrays)
    inputs["tracker_like_17of50"] = tracker_like(np.random.default_rng(3), dev)
    for key, lib in libs.items():
        for name, (iou, order) in inputs.items():
            for iou_min in chip_smoke.ASSOC_IOU_MINS:
                got, want = call(lib, iou, order, iou_min), ta.track_associate_plain(iou, order, iou_min)
                if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                    raise AssertionError(f"variant {key} disagrees with the plain version on {name} at {iou_min}")
    print(json.dumps({"bit_exact": {"variants": len(libs), "inputs": len(inputs),
                                    "thresholds": len(chip_smoke.ASSOC_IOU_MINS)}}), flush=True)
    for name in (*chip_smoke.ASSOC_TIMED, "tracker_like_17of50"):
        iou, order = inputs[name]
        device_us = {str(key): [] for key in libs}
        for key in [*libs, *reversed(list(libs))]:
            ms = chip_smoke.device_ms(lambda: call(libs[key], iou, order, chip_smoke.TRACK_IOU_MIN),
                                      kernel=chip_smoke.ASSOC_DESIGN_KERNELS["matrix"])
            if ms is None:
                raise AssertionError(f"the profiler saw no launch of variant {key}")
            device_us[str(key)].append(ms * 1e3)
        print(json.dumps({"input": name, "shape": list(iou.shape), "device_us": device_us}), flush=True)
    print(json.dumps({"card": card["nvidia_smi"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
