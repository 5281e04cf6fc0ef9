// The fusion path's three sequential loops, one block per frame.
//
// Replaces the lax.fori_loop programs of the JAX package, which XLA ran on
// the device (they were not Pallas kernels):
//   hard_nms_keep      sfa3d_tpu/fusion/nms.py:33-50 (hard_nms, the loop on
//                      boxes already in stable score order); also the NMS of
//                      sfa3d_tpu/models/yolov8.py:254 (select_detections)
//   soft_nms_gaussian  sfa3d_tpu/fusion/nms.py:53-87
//   greedy_match       sfa3d_tpu/fusion/fuse.py:64-91
//
// What bounds them on this card: neither bytes nor arithmetic. A frame moves
// a few KB (K boxes in, K flags or scores out) and does K * K IoUs, but the
// K steps depend on each other: step i reads what steps < i decided. So the
// floor is the launch latency plus K dependent block-wide reductions per
// frame. The design does just that and no more: one block per frame (the
// frames of a batch run side by side on separate SMs, one launch per batch),
// the frame's boxes and flags in shared memory, and thread j owning slot j's
// state in registers. Step i recomputes row i of the IoU matrix (thread j
// computes iou(i, j)) instead of storing the K x K matrix: at K = 256 it
// would be 262,144 B, above the 232,448 B of shared memory a block may use.
// Each step is one reduction: __syncthreads_or for hard NMS, an argmax
// (first index on ties, like jnp.argmax) in two warp-shuffle levels for
// soft-NMS and the match. Steps whose outcome is known skip the reduction:
// an invalid row in hard NMS and in the match, and every soft-NMS step after
// the first with nothing left to select. Warp-level frames, several frames
// per block or one launch for all three loops are left to later work.
//
// Bit parity with the plain PyTorch versions (sfa3d_tpu_torch/ops/
// fusion_loops.py): the IoU repeats fusion/iou.py's float32 steps with
// __fadd_rn / __fsub_rn / __fmul_rn / __fdiv_rn, so nvcc cannot contract a
// product and a sum into a fused multiply-add; the soft-NMS decay is
// expf(-(iou * iou) * inv_sigma) with inv_sigma = float32(1 / sigma) passed
// in (the form XLA compiles for a constant sigma). expf may differ from the
// plain version's exp by an ulp; the build never uses --use_fast_math.
//
// Plain C interface, bound with ctypes (sfa3d_tpu_torch/_build.py). The
// wrappers check shapes, types, devices and contiguity, allocate the
// outputs, and raise when the return value is not 0.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / kWarp;

struct Box {
  float x, y, w, h;
};

__device__ __forceinline__ Box load_box(const float* __restrict__ p) {
  return Box{p[0], p[1], p[2], p[3]};
}

// iou(a, b) for a = box1 (the row) and b = box2 (the column), in
// fusion/iou.py's float32 steps.
__device__ __forceinline__ float iou_xywh(const Box& a, const Box& b) {
  const float left = fmaxf(a.x, b.x);
  const float top = fmaxf(a.y, b.y);
  const float right = fminf(__fadd_rn(a.x, a.w), __fadd_rn(b.x, b.w));
  const float bottom = fminf(__fadd_rn(a.y, a.h), __fadd_rn(b.y, b.h));
  const float inter =
      __fmul_rn(fmaxf(__fsub_rn(right, left), 0.0f), fmaxf(__fsub_rn(bottom, top), 0.0f));
  const float uni = __fsub_rn(__fadd_rn(__fmul_rn(a.w, a.h), __fmul_rn(b.w, b.h)), inter);
  return uni > 0.0f ? __fdiv_rn(inter, fmaxf(uni, 1e-12f)) : 0.0f;
}

// (v, i) beats (ov, oi) when v is larger, or equal with a smaller index.
__device__ __forceinline__ void take_better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

// Block-wide argmax with the first index on ties; every thread gets the
// result. Two __syncthreads: the per-warp winners go through `wv`/`wi`, the
// block's winner through `rv`/`ri`, so the next call's writes never race
// this call's reads.
__device__ __forceinline__ void block_argmax(float v, int i, float* wv, int* wi, float* rv,
                                             int* ri, float& out_v, int& out_i) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    take_better(v, i, __shfl_down_sync(0xffffffffu, v, off), __shfl_down_sync(0xffffffffu, i, off));
  }
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  if (lane == 0) {
    wv[warp] = v;
    wi[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x / kWarp;
    v = lane < n_warps ? wv[lane] : -INFINITY;
    i = lane < n_warps ? wi[lane] : 0x7fffffff;
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1) {
      take_better(v, i, __shfl_down_sync(0xffffffffu, v, off),
                  __shfl_down_sync(0xffffffffu, i, off));
    }
    if (lane == 0) {
      *rv = v;
      *ri = i;
    }
  }
  __syncthreads();
  out_v = *rv;
  out_i = *ri;
}

// grid (batch), block >= k threads. boxes (batch, k, 4) in stable score
// order, valid (batch, k) -> keep (batch, k): keep[i] = valid[i] and no kept
// j < i has iou(i, j) > thr.
__global__ void hard_nms_keep_kernel(const float* __restrict__ boxes,
                                     const uint8_t* __restrict__ valid, uint8_t* __restrict__ keep,
                                     int32_t k, float thr) {
  extern __shared__ float4 sbox[];
  __shared__ uint8_t svalid[kMaxThreads];
  const int64_t f = blockIdx.x;
  const int j = threadIdx.x;
  const float* fb = boxes + f * k * 4;
  Box mine{0.0f, 0.0f, 0.0f, 0.0f};
  if (j < k) {
    mine = load_box(fb + 4 * j);
    sbox[j] = make_float4(mine.x, mine.y, mine.w, mine.h);
    svalid[j] = valid[f * k + j];
  }
  __syncthreads();
  bool kept = false;
  for (int i = 0; i < k; ++i) {
    if (!svalid[i]) continue;  // keep[i] is false; the same branch for every thread
    const float4 r = sbox[i];
    const bool hit = j < i && kept && iou_xywh(Box{r.x, r.y, r.z, r.w}, mine) > thr;
    const int any_hit = __syncthreads_or(hit);
    if (j == i) kept = !any_hit;
  }
  if (j < k) keep[f * k + j] = kept;
}

// grid (batch), block >= k threads. Gaussian soft-NMS in slot order:
// repeatedly select the highest unprocessed score, freeze it, and decay every
// other unprocessed score by expf(-(iou * iou) * inv_sigma). Writes the final
// scores (0 for invalid slots) and surv = valid & score > score_thresh.
__global__ void soft_nms_gaussian_kernel(const float* __restrict__ boxes,
                                         const float* __restrict__ scores,
                                         const uint8_t* __restrict__ valid,
                                         float* __restrict__ out_scores,
                                         uint8_t* __restrict__ surv, int32_t k, float inv_sigma,
                                         float score_thresh) {
  extern __shared__ float4 sbox[];
  __shared__ float wv[kMaxWarps];
  __shared__ int wi[kMaxWarps];
  __shared__ float rv;
  __shared__ int ri;
  const int64_t f = blockIdx.x;
  const int j = threadIdx.x;
  Box mine{0.0f, 0.0f, 0.0f, 0.0f};
  bool v = false;
  float s = -INFINITY;
  if (j < k) {
    mine = load_box(boxes + (f * k + j) * 4);
    sbox[j] = make_float4(mine.x, mine.y, mine.w, mine.h);
    v = valid[f * k + j] != 0;
    s = v ? scores[f * k + j] : -INFINITY;
  }
  bool processed = !v;  // threads past k never take part
  __syncthreads();
  for (int step = 0; step < k; ++step) {
    float best;
    int m;
    block_argmax(processed ? -INFINITY : s, j, wv, wi, &rv, &ri, best, m);
    if (!isfinite(best)) break;  // nothing left: no later step changes anything
    if (!processed && j != m) {
      const float4 r = sbox[m];
      const float q = iou_xywh(Box{r.x, r.y, r.z, r.w}, mine);
      s = __fmul_rn(s, expf(__fmul_rn(-__fmul_rn(q, q), inv_sigma)));
    }
    if (j == m) processed = true;
  }
  if (j < k) {
    const float out = v ? s : 0.0f;
    out_scores[f * k + j] = out;
    surv[f * k + j] = v && out > score_thresh;
  }
}

// grid (batch), block >= max(ks, 32) threads, ky <= 1024. YOLO rows scanned
// in order; row i claims the unmatched SFA box with the largest IoU (first
// index on ties) when that IoU is >= thr and > 0. The YOLO rows and their
// flags sit in shared memory, thread j owns SFA box j.
__global__ void greedy_match_kernel(const float* __restrict__ yolo_boxes,
                                    const uint8_t* __restrict__ yolo_valid,
                                    const float* __restrict__ sfa_boxes,
                                    const uint8_t* __restrict__ sfa_valid,
                                    int32_t* __restrict__ match_idx,
                                    uint8_t* __restrict__ sfa_matched, int32_t ky, int32_t ks,
                                    float thr) {
  extern __shared__ float4 sbox[];  // the frame's ky YOLO boxes
  __shared__ uint8_t svalid[kMaxThreads];
  __shared__ float wv[kMaxWarps];
  __shared__ int wi[kMaxWarps];
  __shared__ float rv;
  __shared__ int ri;
  const int64_t f = blockIdx.x;
  const int j = threadIdx.x;
  for (int q = j; q < ky; q += blockDim.x) {
    const Box b = load_box(yolo_boxes + (f * ky + q) * 4);
    sbox[q] = make_float4(b.x, b.y, b.w, b.h);
    svalid[q] = yolo_valid[f * ky + q];
  }
  Box mine{0.0f, 0.0f, 0.0f, 0.0f};
  bool sv = false;
  if (j < ks) {
    mine = load_box(sfa_boxes + (f * ks + j) * 4);
    sv = sfa_valid[f * ks + j] != 0;
  }
  __syncthreads();
  bool matched = false;
  for (int i = 0; i < ky; ++i) {
    if (!svalid[i]) {  // a row of -1: no match; the same branch for every thread
      if (j == 0) match_idx[f * ky + i] = -1;
      continue;
    }
    float r = -INFINITY;  // threads past ks never win
    if (j < ks) {
      const float4 y = sbox[i];
      r = sv && !matched ? iou_xywh(Box{y.x, y.y, y.z, y.w}, mine) : -1.0f;
    }
    float best;
    int jm;
    block_argmax(r, j, wv, wi, &rv, &ri, best, jm);
    const bool ok = best >= thr && best > 0.0f;
    if (j == 0) match_idx[f * ky + i] = ok ? jm : -1;
    if (j == jm && ok) matched = true;
  }
  if (j < ks) sfa_matched[f * ks + j] = matched;
}

int threads_for(int32_t n) {
  const int t = (n + kWarp - 1) / kWarp * kWarp;
  return t < kWarp ? kWarp : t;
}

// Runs `launch_fn` with `device` current; the caller's device is restored
// afterwards. Returns the first CUDA error (0 on success).
template <typename F>
int on_device(int32_t device, F launch_fn) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (prev != device) {
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  launch_fn();
  err = cudaGetLastError();
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}

}  // namespace

// boxes (batch, k, 4) float32, valid (batch, k) bool -> keep (batch, k)
// bool; all contiguous on `device`; 1 <= k <= 1024, batch >= 1.
extern "C" int hard_nms_keep_cuda(const void* boxes, const void* valid, void* keep, int64_t batch,
                                  int32_t k, float thr, int32_t device, void* stream) {
  return on_device(device, [&] {
    hard_nms_keep_kernel<<<static_cast<unsigned int>(batch), threads_for(k),
                           static_cast<size_t>(k) * sizeof(float4),
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(boxes), static_cast<const uint8_t*>(valid),
        static_cast<uint8_t*>(keep), k, thr);
  });
}

// boxes (batch, k, 4), scores (batch, k) float32, valid (batch, k) bool ->
// out_scores (batch, k) float32, surv (batch, k) bool; 1 <= k <= 1024.
extern "C" int soft_nms_gaussian_cuda(const void* boxes, const void* scores, const void* valid,
                                      void* out_scores, void* surv, int64_t batch, int32_t k,
                                      float inv_sigma, float score_thresh, int32_t device,
                                      void* stream) {
  return on_device(device, [&] {
    soft_nms_gaussian_kernel<<<static_cast<unsigned int>(batch), threads_for(k),
                               static_cast<size_t>(k) * sizeof(float4),
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(boxes), static_cast<const float*>(scores),
        static_cast<const uint8_t*>(valid), static_cast<float*>(out_scores),
        static_cast<uint8_t*>(surv), k, inv_sigma, score_thresh);
  });
}

// yolo_boxes (batch, ky, 4), yolo_valid (batch, ky), sfa_boxes (batch, ks, 4),
// sfa_valid (batch, ks) -> match_idx (batch, ky) int32, sfa_matched
// (batch, ks) bool; 0 <= ky <= 1024, 1 <= ks <= 1024.
extern "C" int greedy_match_cuda(const void* yolo_boxes, const void* yolo_valid,
                                 const void* sfa_boxes, const void* sfa_valid, void* match_idx,
                                 void* sfa_matched, int64_t batch, int32_t ky, int32_t ks,
                                 float thr, int32_t device, void* stream) {
  return on_device(device, [&] {
    greedy_match_kernel<<<static_cast<unsigned int>(batch), threads_for(ks),
                          static_cast<size_t>(ky) * sizeof(float4),
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(yolo_boxes), static_cast<const uint8_t*>(yolo_valid),
        static_cast<const float*>(sfa_boxes), static_cast<const uint8_t*>(sfa_valid),
        static_cast<int32_t*>(match_idx), static_cast<uint8_t*>(sfa_matched), ky, ks, thr);
  });
}
